"""Hierarchical banks at the `exact` and `high` tiers: range_tpu_torch
against range_tpu on the CPU.

The port builds and serves a HierBank at every tier JAX does.  At `exact`
the queries, keys and group operands are f32 (and the values too with
``value_dtype=float32``, JAX's override); at `high` the semantic block
holds the 3 x 256 hi/lo cross terms.  Here JAX builds the banks (through
its `load_model` hier cache or `build_hier_bank`), the port loads the
archives, and both serve the same requests: `retrieve_hier` with every
tile selected (JAX's exactness check, `tests/test_hier.py:73-80`) and with
8 of 16, `hier_topk`, `load_model` at the flagship knobs in RANGE+ and
RANGE, a tail_super bank and a two-level bank.  The CUDA-core body that
serves these tiers on the card (`csrc/hier_cores.cu`) runs only there; its
two passes, composed as the wrappers compose them, are held here by a
plain PyTorch version of each pass against every kernel's plain version.

Sizes: an informative bank of 2,048 rows with 256-d keys and bf16 128-d
values, bn 128 (16 tiles), gsz_sem 8 or 16, gsz_geo 16, B = 256.  JAX's
Pallas kernels run in interpret mode.  Module-scoped banks: the file takes
~30 s on one process.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

import range_tpu
from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.bank.bank import quantize_values as jax_quantize
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval as jret
from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch import load_model
from range_tpu_torch.convert.from_jax import (_tensor, geobank_from_arrays,
                                              siren_params_from_jax)
from range_tpu_torch.ops import retrieval as tret
from range_tpu_torch.ops import retrieval_fused as rf
from range_tpu_torch.ops import retrieval_hier as th
from test_torch_topk import _hilo, _row_logits, _rows_agree_outside_near_ties

N, B, Dv = 2048, 256, 128
TIERS = ["exact", "high"]
SMALL = dict(hier_bn=128, gsz_geo=16, chunk=512, seed=0)
f32 = torch.float32


def _np(x):
    return np.asarray(x).astype(np.float32)


def _t(x):
    return _tensor(np.asarray(x))


def _relerr(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 0.1)


def _close_but_flips(t, j, atol=2e-4):
    """|t - j| <= atol, except in at most max(2, B / 100) rows, each within
    2^-7 of its row's largest |j|: the logits agree to f32 summation order,
    and a weight next to a bf16 rounding midpoint that rounds the other way
    before a bf16 value product moves its element by up to 2^-7 of that one
    term (ROADMAP Queue 3, "bf16 flips of a dominant term")."""
    err = np.abs(t - j)
    over = (err > atol).any(axis=1)
    assert int(over.sum()) <= max(2, t.shape[0] // 100), int(over.sum())
    row = np.abs(j).max(axis=1, keepdims=True)
    assert (err[over] <= 2.0 ** -7 * row[over]).all()


@pytest.fixture(scope="module")
def jb():
    return JaxGeoBank.synthetic_informative(5, N, key_dim=256, value_dim=Dv, pad_to=512,
                                            value_dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def regional(jb):
    """B queries near 8 bank rows (3 degree jitter), each the bank key of
    its row plus noise, with their locations."""
    rng = np.random.default_rng(3)
    rows = np.repeat(rng.integers(0, N, 8), B // 8)
    ll = _np(jb.locs_lonlat)[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = _np(jb.keys_sem)[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return q, _np(jax_xyz(jnp.asarray(ll, jnp.float32))), ll.astype(np.float32)


def _cross(jhb, path):
    jh.save_hier_bank(jhb, path)
    return th.load_hier_bank(path, device="cpu")


@pytest.fixture(scope="module")
def exact_f32(jb, tmp_path_factory):
    """JAX's exactness bank: tier exact with f32 values, gsz_sem 8."""
    jhb = jh.build_hier_bank(jb, bn=128, gsz_sem=8, gsz_geo=16, tier="exact",
                             value_dtype=jnp.float32)
    return jhb, _cross(jhb, str(tmp_path_factory.mktemp("tiers") / "exact_f32.npz"))


@pytest.fixture(scope="module")
def flagship(jb, tmp_path_factory):
    """Per tier: the JAX flagship encoder (bn 128, gsz_geo 16; lr_rank /
    lr_geo / res_rank clamp to 128) whose load_model built the HierBank
    into its hier cache, the cache's path, and the port's load of it."""
    out = {}
    for tier in TIERS:
        path = str(tmp_path_factory.mktemp("tiers") / f"flag_{tier}.npz")
        jenc = range_tpu.load_model("RANGE+", db_path=jb, profile="flagship", k_tiles=4,
                                    k_geo=2, hier_cache=path, tier=tier, **SMALL)
        out[tier] = (jenc, path, th.load_hier_bank(path, device="cpu"))
    return out


# ---------------------------------------------------------------- build


def test_value_dtype_override(jb, tmp_path):
    """`build_hier_bank(value_dtype=)` as JAX's (`retrieval_hier.py:777-779`):
    f32 values on request, bf16 by default, int8 codes before either; the
    archive carries the dtype, and a cache of other values is rebuilt."""
    bank = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values, jb.n_valid)
    kw = dict(bn=128, gsz_sem=8, gsz_geo=16, tier="exact")
    hb = th.build_hier_bank(bank, value_dtype=f32, **kw)
    assert hb.values.dtype == f32 and hb.k_cat.dtype == f32 and hb.g_sem_vw.dtype == f32
    path = str(tmp_path / "hb.npz")
    th.save_hier_bank(hb, path)
    assert th.load_hier_bank(path, device="cpu").values.dtype == f32
    from range_tpu_torch.bank.bank import quantize_values
    q8 = th.build_hier_bank(quantize_values(bank), value_dtype=f32, **kw)
    assert q8.values.dtype == torch.int8 and q8.value_scale is not None
    cache = str(tmp_path / "cache.npz")
    a = th.prepare_hier_bank(bank, cache_path=cache, **kw)
    assert a.values.dtype == torch.bfloat16
    b = th.prepare_hier_bank(bank, cache_path=cache, value_dtype=f32, **kw)  # stale: rebuilt
    assert b.values.dtype == f32
    assert th.prepare_hier_bank(bank, cache_path=cache, value_dtype=f32,
                                **kw).values.dtype == f32  # loaded
    np.testing.assert_array_equal(a.values.float().numpy(), b.values.to(torch.bfloat16)
                                  .float().numpy())


def test_port_build_equals_jax_at_both_tiers(jb):
    """The port's own build at each tier: the packed operands in JAX's
    dtypes and widths (f32 at exact, 768 semantic columns at high)."""
    bank = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values, jb.n_valid)
    for tier, (dt, sem_d) in (("exact", (f32, 256)), ("high", (torch.bfloat16, 768))):
        hb = th.build_hier_bank(bank, bn=128, gsz_sem=8, gsz_geo=16, tier=tier)
        assert (hb.sem_d, hb.k_cat.dtype, hb.g_sem_cat.dtype) == (sem_d, dt, dt)
        assert hb.g_sem_vw.dtype == dt and hb.values.dtype == torch.bfloat16


# ---------------------------------------------------------------- serving


def test_exact_all_tiles_matches_jax_and_dense(exact_f32, jb, regional):
    """With every tile selected, the exact tier with f32 values is the
    exact dense answer: JAX's check (max relerr < 5e-3, floor 0.1) holds
    on both packages, and the port equals JAX's interpret mode to f32
    summation order (1e-5)."""
    jhb, thb = exact_f32
    q, x, _ = regional
    jref = _np(jret.retrieve(jnp.asarray(q), jnp.asarray(x), jb, chunk=512))
    tref = tret.retrieve(_t(q), _t(x), thb.bank, chunk=512).numpy()
    j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb, k_tiles=jhb.n_tiles,
                             bm=128, interpret=True))
    t = th.retrieve_hier(_t(q), _t(x), thb, k_tiles=thb.t_real, bm=128).numpy()
    print(f"max relerr: JAX {_relerr(j, jref).max():.3e}, port {_relerr(t, tref).max():.3e}")
    assert _relerr(j, jref).max() < 5e-3 and _relerr(t, tref).max() < 5e-3
    assert _relerr(t, tref).max() < 1e-4  # the card's bar, met here too
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)


@pytest.mark.parametrize("tier", TIERS)
def test_selected_tiles_match_jax(flagship, regional, tier):
    """`retrieve_hier` at k_tiles 8 of 16 on the flagship-knob bank (the
    family split, k_geo defaulting to 8 with res_rank, and the fused
    combine; RANGE's merged kernel: test_load_model_matches_jax); 2e-4 on
    outputs ~0.1-1 (the scan tail and parts within a bf16 ulp of a term,
    as at `fast`), bf16 flips aside (`_close_but_flips`)."""
    jenc, _, thb = flagship[tier]
    jhb = jenc.extra
    q, x, _ = regional
    kw = dict(k_tiles=8, bm=128, j_sem=3)
    j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb,
                             concat_query=jnp.asarray(q), interpret=True, **kw))
    t = th.retrieve_hier(_t(q), _t(x), thb, concat_query=_t(q), **kw).numpy()
    assert t.shape == j.shape == (B, Dv + 256) and np.isfinite(t).all()
    _close_but_flips(t, j)


@pytest.mark.parametrize("tier,k", [("exact", 1), ("high", 4)])
def test_hier_topk_matches_jax(flagship, regional, tier, k):
    """`hier_topk` over the flagship bank's topk_gsz operand, the argmax at
    `exact` and the k-carry top-4 at `high`: the stats scan reads the
    tier's packed queries, the argmax the hi/lo keys; rows equal JAX's
    outside near-ties."""
    jenc, _, thb = flagship[tier]
    jhb = jenc.extra
    q, x, _ = regional
    j = np.asarray(jh.hier_topk(jnp.asarray(q), jnp.asarray(x), jhb, k=k, k_tiles=4, bm=128,
                                interpret=True)).reshape(B, -1)
    t = th.hier_topk(_t(q), _t(x), thb, k=k, k_tiles=4, bm=128).numpy().reshape(B, -1)
    if (t != j).any():
        q2, ql = _hilo(q)
        ref = _row_logits(q2, ql, jhb.khl_sem, jhb.mask_neg, j, 256)
        _rows_agree_outside_near_ties(t, j, ref, q2, ql, jhb.khl_sem, jhb.mask_neg, 256,
                                      f"hier_topk {tier} k={k}")


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
@pytest.mark.parametrize("tier", TIERS)
def test_load_model_matches_jax(flagship, jb, regional, tier, name):
    """`load_model(name, retrieval="hier", profile="flagship", tier=...,
    device="cpu")` loads JAX's hier cache (equal signatures and values)
    and serves with JAX's tower weights as JAX's `load_model` does; 2e-4,
    bf16 flips aside (`_close_but_flips`)."""
    jenc, path, _ = flagship[tier]
    kw = dict(profile="flagship", k_tiles=4, k_geo=2, hier_cache=path, tier=tier, **SMALL)
    if name == "RANGE":
        jenc = range_tpu.load_model(name, db_path=jb, **kw)
    sig = th.peek_hier_build(path)
    bank = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values, jb.n_valid)
    enc = load_model(name, db_path=bank, device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    assert th.peek_hier_build(path) == sig and enc.model.bank.tier == tier  # loaded
    _, _, ll = regional
    j = np.asarray(jenc(jnp.asarray(ll)))
    t = enc(ll).numpy()
    assert t.shape == j.shape == (B, Dv + 256)
    _close_but_flips(t, j)


@pytest.mark.parametrize("name,tier", [("tail_super", "exact"), ("gsz_super", "high")])
def test_tail_super_and_two_level_banks_match_jax(jb, regional, tmp_path, name, tier):
    """A tail_super bank at `exact` (the scan's segment sums and the
    correction, RANGE+ at k_geo 4, m_corr 4) and a two-level bank at `high`
    (gsz_super 16, no lr_rank: the two-level feature path, M = 12 of 16,
    K = 6); 2e-4, bf16 flips aside.  (The card serves both at both tiers:
    chip_smoke.py.)"""
    q, x, _ = regional
    knobs, kw = {"tail_super": (dict(lr_rank=128, res_rank=128, tail_super=32),
                                dict(k_tiles=6, k_geo=4, m_corr=4)),
                 "gsz_super": (dict(gsz_super=16), dict(k_tiles=6, m_tiles=12))}[name]
    jhb = jh.build_hier_bank(jb, bn=128, gsz_sem=8, gsz_geo=16, tier=tier, **knobs)
    thb = _cross(jhb, str(tmp_path / f"{name}.npz"))
    j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb, bm=128, interpret=True,
                             **kw))
    t = th.retrieve_hier(_t(q), _t(x), thb, bm=128, **kw).numpy()
    assert t.shape == j.shape == (B, Dv)
    _close_but_flips(t, j)


# ---------------------------------------------------------------- the CUDA-core body


def _kept(idx, row, K, dedup):
    if idx is None:
        return torch.arange(K), torch.arange(K)
    t, pos = idx[row].long(), torch.arange(K)
    if dedup:
        keep = torch.ones(K, dtype=torch.bool)
        keep[1:] = t[1:] != t[:-1]
        t, pos = t[keep], pos[keep]
    return t, pos


def _round(x, like):
    return x.to(f32 if like.dtype == f32 else torch.bfloat16).to(f32)


def _groups_pass(q, g, *, wk, gpt, out=None, idx=None, bm=64, n_tiles=0, qc0=0, stats=None,
                 vw=None, sup=1, nvc=0, oc0=0, cntc=-1, dcol=-1, ps=None, mode=0, lrr=0,
                 sign=1.0, accumulate=False, dedup=False, n_seg=1):
    """A plain version of `groups_kernel` (`csrc/hier_cores.cu`), 64 queries
    at a time as its blocks (its segments only split the sums)."""
    K = idx.shape[1] if idx is not None else n_tiles
    for b0 in range(0, q.shape[0], 64):
        b = slice(b0, b0 + 64)
        tiles, pos = _kept(idx, b0 // bm, K, dedup)
        grps = (tiles[:, None] * gpt + torch.arange(gpt)).reshape(-1)
        lg = q[b, qc0:qc0 + wk].to(f32) @ g[grps, :wk].to(f32).T
        p = torch.exp2(torch.clamp_max(lg, 86.0))
        n = lg.shape[0]
        if stats is not None:
            stats[0][b, pos] = lg.reshape(n, -1, gpt).amax(2)
            stats[1][b, pos] = p.reshape(n, -1, gpt).sum(2)
        if vw is None:
            continue
        e = p
        if mode:
            psn = ps[b, :grps.numel()] / vw[grps, lrr].to(f32).clamp_min(1.0)
            e = p - psn if mode == 1 else psn - p
        vr = grps
        if sup > 1:
            e, vr = e.reshape(n, -1, sup).sum(2), grps[::sup] // sup
        e = _round(e, vw)
        for cols, o_cols in ((slice(0, nvc), slice(oc0, oc0 + nvc)),
                             (slice(cntc, cntc + 1), slice(dcol, dcol + 1))):
            if cols.start < 0:
                continue
            prod = sign * (e @ vw[vr, cols].to(f32))
            out[b, o_cols] = out[b, o_cols] + prod if accumulate else prod


def _rows_pass(q, k, mask_neg, idx, x, out, *, kf, bm, bn, qc0=0, kc0=0, scale=None,
               oc0=0, dcol=-1, rr=False, ps=None, gsz=1, accumulate=False, dedup=False):
    """A plain version of `rows_kernel` (`csrc/hier_cores.cu`)."""
    nx = x.shape[1]
    for b0 in range(0, q.shape[0], 64):
        b = slice(b0, b0 + 64)
        tiles, _ = _kept(idx, b0 // bm, idx.shape[1], dedup)
        r = (tiles[:, None] * bn + torch.arange(bn)).reshape(-1)
        lg = q[b, qc0:qc0 + kf].to(f32) @ k[r, kc0:kc0 + kf].to(f32).T + mask_neg[0, r]
        p = torch.exp2(torch.clamp_max(lg, 86.0))
        if rr:
            w = _round(p, x)
            ps[b, :r.numel() // gsz] = w.reshape(w.shape[0], -1, gsz).sum(2)
        else:
            w = _round(p * scale[0, r] if scale is not None else p, x)
            if dcol >= 0:
                out[b, dcol] = out[b, dcol] + p.sum(1) if accumulate else p.sum(1)
        prod = w @ x[r].to(f32)
        out[b, oc0:oc0 + nx] = out[b, oc0:oc0 + nx] + prod if accumulate else prod


@pytest.fixture
def plain_passes(monkeypatch):
    """The wrappers' CUDA-core compositions with each pass's plain version
    in place of its launch (nothing here is on the card)."""
    monkeypatch.setattr(th, "_cores_groups", _groups_pass)
    monkeypatch.setattr(th, "_cores_rows", _rows_pass)
    monkeypatch.setattr(th, "_cores_check", lambda *a, **k: None)
    monkeypatch.setattr(th, "_count_cores", lambda *a, **k: None)


def _close(name, got, ref):
    """Within 1e-5 of each row's largest |ref|: the same f32 terms, summed
    in other orders."""
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        scale = b.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
        assert ((a - b).abs() / scale).max().item() < 1e-5, name


@pytest.mark.parametrize("tier", TIERS)
def test_cores_passes_compose_each_kernel(flagship, regional, plain_passes, tier):
    """Composed as `_scan_cores`, `_refine_cores`, `_parts_family_cores` and
    `_parts_cores` compose them, the two passes are each kernel: both scans
    (± geo, the supergroup segment sums), kernel 14's four shapes on both
    families (± dedup_pad), kernel 15 lr and plain (± geo), the refine
    (stats, parts)."""
    thb = flagship[tier][2]
    q, x, _ = regional
    q_cat = rf.pack_queries(_t(q), _t(x), 12.0, 40.0, tier)
    gpt = 8
    sa = (q_cat, thb.g_sem_cat, thb.g_geo_cat, thb.g_sem_vw_lr, thb.g_geo_vw_lr)
    for has_geo in (True, False):
        ref = th._hier_scan_plain(*sa, gpt_s=gpt, gpt_g=gpt, has_geo=has_geo)
        _close("scan", th._scan_cores("f32", *sa, gpt_s=gpt, gpt_g=gpt, has_geo=has_geo),
               tuple(r for r in ref if r is not None))
    ts = (q_cat, thb.g_sem_cat, thb.g_geo_cat, thb.g_sem_vw_lr[::4].contiguous(),
          thb.g_geo_vw_lr)
    _close("scan sup", th._scan_cores("f32", *ts, gpt_s=gpt, gpt_g=gpt, sup_r=4),
           th._hier_scan_plain(*ts, gpt_s=gpt, gpt_g=gpt, sup_r=4))
    st = (q_cat, thb.g_topk_cat, thb.g_geo_cat)
    _close("stats", th._scan_cores("f32", *st, None, None, gpt_s=16, gpt_g=gpt),
           th._hier_scan_stats_plain(*st, gpt_s=16, gpt_g=gpt))
    m_s, s_s, m_g, s_g = th._hier_scan_stats_plain(q_cat, thb.g_sem_cat, thb.g_geo_cat,
                                                   gpt_s=gpt, gpt_g=gpt)
    sel = dict(t_real=thb.t_real, bm=128, n_valid=B, mode="range")
    idx_s, _ = th.select_tiles(m_s, s_s, m_g, s_g, k_tiles=6, **sel)
    idx_g, _ = th.select_tiles(m_g, s_g, m_s, s_s, k_tiles=3, **sel)
    idx_d = torch.cat([idx_s[:, :2], idx_s[:, 1:2], idx_s[:, 2:]], 1)  # a repeat a row
    for shape in ("plain", "lr", "rr", "rrlr"):
        lr, rr = shape in ("lr", "rrlr"), shape.startswith("rr")
        for geo in (False, True):
            vw = ((thb.g_geo_vw_lr if lr else thb.g_geo_vw) if geo
                  else (thb.g_sem_vw_lr if lr else thb.g_sem_vw))
            z = (thb.z_geo if geo else thb.z_sem) if rr else None
            for idx, dedup in ((idx_g if geo else idx_s, False), (idx_d, True)):
                args = (q_cat, thb.k_cat, thb.mask_neg, idx, thb.g_geo_cat if geo
                        else thb.g_sem_cat, vw, z)
                kw = dict(sem_d=thb.sem_d, bm=128, bn=128, gpt=gpt, geo=geo,
                          lrr=128 if lr else Dv, lr=lr, values=thb.values, scale=None,
                          dedup_pad=dedup)
                _close(f"family {shape} geo={geo}",
                       th._parts_family_cores(*args, **kw, sel=False,
                                              geo_cols=rf.geo_real_cols(tier)),
                       th._hier_parts_family_plain(*args, **kw))
    for lr in (True, False):
        for geo in (True, False):
            args = (q_cat, thb.k_cat, thb.values, None, thb.mask_neg, idx_s, thb.g_sem_cat,
                    thb.g_geo_cat, thb.g_sem_vw_lr if lr else thb.g_sem_vw, thb.g_geo_vw)
            kw = dict(sem_d=thb.sem_d, bm=128, bn=128, gpt_s=gpt, gpt_g=gpt, lr=lr, geo=geo)
            _close(f"merged lr={lr}", th._parts_cores(*args, **kw),
                   th._hier_parts_plain(*args, **kw))
    sup_vw = 0.5 * thb.g_sem_vw[::2]
    for stats_only in (True, False):
        got = th._refine_cores("f32", q_cat, idx_s, thb.g_sem_cat, thb.g_sem_cat[::2],
                               thb.g_sem_vw, sup_vw, bm=128, gpt_f=gpt, gpt_sup=4,
                               stats_only=stats_only)
        kw = dict(bm=128, gpt_f=gpt) if stats_only else dict(
            bm=128, gpt_f=gpt, g_sup_cat=thb.g_sem_cat[::2], g_sem_vw=thb.g_sem_vw,
            g_sup_vw=sup_vw, gpt_sup=4)
        _close("refine", got[:2] if stats_only else got,
               th._hier_refine_plain(q_cat, idx_s, thb.g_sem_cat, **kw))


@pytest.mark.parametrize("tier", TIERS)
def test_cores_passes_compose_the_sel_form(flagship, regional, plain_passes, tier):
    """Kernel 14's sel form (the sem family over [q_cat | q_sel], its group
    logits from a rank-64 sketch of the sem centroids, as sel_lr builds
    it) in each shape, composed from the two passes, equals its plain
    version."""
    thb = flagship[tier][2]
    g_sel, p_sel = th._lowrank_centroid_factor(thb.g_sem_cat, 64)
    thb = dataclasses.replace(thb, sel_lr=64, g_sem_sel=g_sel, p_sel=p_sel)
    q, x, _ = regional
    q_cat = rf.pack_queries(_t(q), _t(x), 12.0, 40.0, tier)
    q_sel = (q_cat[:, :thb.sem_d].to(f32) @ thb.p_sel.T).to(q_cat.dtype)
    m_s, s_s, m_g, s_g = th._hier_scan_stats_plain(q_cat, thb.g_sem_cat, thb.g_geo_cat,
                                                   gpt_s=8, gpt_g=8)
    idx, _ = th.select_tiles(m_s, s_s, m_g, s_g, t_real=thb.t_real, k_tiles=6, bm=128,
                             n_valid=B, mode="range")
    for shape in ("plain", "lr", "rr", "rrlr"):
        lr, rr = shape in ("lr", "rrlr"), shape.startswith("rr")
        args = (torch.cat([q_cat, q_sel], 1), thb.k_cat, thb.mask_neg, idx, thb.g_sem_sel,
                thb.g_sem_vw_lr if lr else thb.g_sem_vw, thb.z_sem if rr else None)
        kw = dict(sem_d=thb.sem_d, bm=128, bn=128, gpt=8, geo=False, lrr=128 if lr else Dv,
                  lr=lr, values=thb.values, scale=None, sel=True)
        _close(f"sel {shape}", th._parts_family_cores(*args, **kw, dedup_pad=False),
               th._hier_parts_family_plain(*args, **kw))


def test_high_tier_knobs_match_jax(jb, regional, tmp_path):
    """The knobs the `fast` tier serves, at `high` (the deep form): a bank
    with sel_lr 64 and topk_lr 64 beside the flagship's ranks; RANGE+ over
    the sel sketch (k_geo 4) with dedup=2 (two 128-query blocks' lists
    merged), and with the rescue (adaptive_frac 0.5), and hier_topk over
    the topk_lr sketch, each against JAX (2e-4, bf16 flips aside; top-k
    rows outside near-ties)."""
    jhb = jh.build_hier_bank(jb, bn=128, gsz_sem=16, gsz_geo=16, lr_rank=128, lr_geo=128,
                             res_rank=128, topk_gsz=8, topk_lr=64, sel_lr=64, tier="high")
    thb = _cross(jhb, str(tmp_path / "knobs.npz"))
    assert thb.g_sem_sel is not None and thb.g_topk_lr is not None
    q, x, _ = regional
    base = dict(k_tiles=6, k_geo=4, bm=128)
    for knobs in (dict(dedup=2), dict(adaptive_frac=0.5, adaptive_mult=2)):
        j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb, interpret=True,
                                 **base, **knobs))
        t = th.retrieve_hier(_t(q), _t(x), thb, **base, **knobs).numpy()
        assert t.shape == j.shape == (B, Dv), knobs
        _close_but_flips(t, j)
    j = np.asarray(jh.hier_topk(jnp.asarray(q), jnp.asarray(x), jhb, k_tiles=4, bm=128,
                                interpret=True)).reshape(B, 1)
    t = th.hier_topk(_t(q), _t(x), thb, k_tiles=4, bm=128).numpy().reshape(B, 1)
    if (t != j).any():
        q2, ql = _hilo(q)
        ref = _row_logits(q2, ql, jhb.khl_sem, jhb.mask_neg, j, 256)
        _rows_agree_outside_near_ties(t, j, ref, q2, ql, jhb.khl_sem, jhb.mask_neg, 256,
                                      "hier_topk topk_lr")


@pytest.mark.parametrize("tier", ["fast", "exact", "high"])
def test_cores_form_routes_by_dtype_and_depth(flagship, tier):
    """f32 operands (exact) take the f32 form, bf16 ones deeper than 256
    logit columns (high) the deep form (the stats scan's on its own kernel
    up to 864 columns), the `fast` tier's operands their own bodies."""
    if tier == "fast":
        g = torch.zeros(8, 256, dtype=torch.bfloat16)
        assert th._cores_form(256, g, None, g) is None
        assert th._cores_form(320, g) == "deep"
        return
    thb = flagship[tier][2]
    want = {"exact": "f32", "high": "deep"}[tier]
    assert th._cores_form(thb.sem_d, thb.k_cat, thb.g_sem_cat, thb.values) == want
    # the stats kernel's own shared memory holds the high tier's depth
    assert th._stats_smem(thb.sem_d) <= th._SM90_MAX_SMEM < th._stats_smem(880)


def test_cores_shape_checks_refuse_what_the_launch_refuses(flagship):
    """The CUDA-core wrappers' checks take every width and dtype the tiers
    give and refuse, before any launch, what `hier_groups_launch` /
    `hier_rows_launch` refuse: a supergroup that does not divide the
    32-group chunk or the tile, centroids wider than the queries, value
    rows that are not one a group, a batch of no whole selection blocks,
    int8 codes without their scales."""
    thb = flagship["high"][2]
    q = torch.zeros(256, thb.cat_d, dtype=torch.bfloat16)
    g, vw = thb.g_sem_cat, thb.g_sem_vw_lr
    assert th._scan_cores_shapes(q, g, thb.g_geo_cat, vw, thb.g_geo_vw, gpt_s=8,
                                 gpt_g=8) == thb.t_pad
    for kw in (dict(sup_r=3), dict(sup_r=16)):  # 3 divides no chunk, 16 no tile of 8
        with pytest.raises(ValueError, match="unsupported shapes"):
            th._scan_cores_shapes(q, g, thb.g_geo_cat, vw[::kw["sup_r"]], thb.g_geo_vw,
                                  gpt_s=8, gpt_g=8, **kw)
    with pytest.raises(ValueError, match="unsupported shapes"):
        th._scan_cores_shapes(q[:, :512], g, thb.g_geo_cat, vw, thb.g_geo_vw, gpt_s=8,
                              gpt_g=8)
    idx = torch.zeros(2, 4, dtype=torch.int32)
    th._list_shapes("t", q, idx, bm=128, fams=[(g, vw, 8)])
    for bad in (dict(bm=96), dict(bm=64), dict(fams=[(g, vw[:-8], 8)])):
        with pytest.raises(ValueError, match="unsupported shapes"):
            th._list_shapes("t", q, idx, **{**dict(bm=128, fams=[(g, vw, 8)]), **bad})
    th._rows_shapes("t", thb.k_cat, thb.mask_neg, idx, thb.values, bn=128)
    codes = torch.zeros_like(thb.values, dtype=torch.int8)
    with pytest.raises(ValueError, match="unsupported shapes"):
        th._rows_shapes("t", thb.k_cat, thb.mask_neg, idx, codes, bn=128)
    with pytest.raises(ValueError, match="unsupported shapes"):
        th._rows_shapes("t", thb.k_cat, thb.mask_neg, idx, thb.values, bn=96)


def test_exact_int8_bank_matches_jax(jb, regional, tmp_path):
    """int8 codes at the exact tier (the codes take precedence over a
    value_dtype): JAX builds from its quantized bank, the port serves the
    archive; RANGE+ at k_tiles 8, 2e-4, bf16 flips aside."""
    jhb = jh.build_hier_bank(jax_quantize(jb), bn=128, gsz_sem=8, gsz_geo=16, tier="exact",
                             value_dtype=jnp.float32)
    thb = _cross(jhb, str(tmp_path / "i8.npz"))
    assert thb.values.dtype == torch.int8 and thb.k_cat.dtype == f32
    q, x, _ = regional
    j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb, k_tiles=8, bm=128,
                             interpret=True))
    t = th.retrieve_hier(_t(q), _t(x), thb, k_tiles=8, bm=128).numpy()
    _close_but_flips(t, j)


def test_high_tier_keeps_dataclass_fields(flagship):
    """The archive's meta carries the tier and the packed widths."""
    thb = flagship["high"][2]
    assert (thb.tier, thb.sem_d, thb.cat_d) == ("high", 768, 896)
    assert dataclasses.replace(thb).k_cat.shape == (N, 896)


def test_cores_block_plan():
    """The CUDA-core body's shared memory (`_cores_smem`, the launch's
    `layout` at its fewest ring slots) holds the exact tier's 256 f32 logit
    columns and the high tier's 768 bf16 ones, and refuses f32 ones 512
    deep; the scans' segments (`_cores_segments`) give about four waves of
    blocks, at least 4 tiles a segment."""
    assert th._cores_smem(256, False, False, True, 0) <= th._SM90_MAX_SMEM
    assert th._cores_smem(768, True, True, True, 0) <= th._SM90_MAX_SMEM
    th._cores_fits("t", 768, True, True, True, 48)
    with pytest.raises(ValueError, match="shared memory"):
        th._cores_fits("t", 512, False, False, True, 0)
    for Bp, slices, K in ((10112, 1, 196), (10112, 3, 196), (64, 1, 196), (64, 1, 3)):
        n = th._cores_segments(Bp, slices, K)
        blocks = -(-Bp // 64) * slices * n
        assert 1 <= n <= max(1, K // 4)
        assert blocks >= min(4 * th.SM90_SMS, -(-Bp // 64) * slices * max(1, K // 4))
