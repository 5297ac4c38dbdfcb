"""The general one-level hierarchical path of range_tpu_torch: banks with any
subset of lr_rank / res_rank / lr_geo, against range_tpu on the CPU.

Covers the plain versions of the kernel variants this path adds (the scan
over full-width group sums, the merged parts kernel without lr, the family
parts kernel's plain / lr / rr shapes, the combine without a low-rank geo
tail), `retrieve_hier` over every knob subset in RANGE and RANGE+ with
k_geo 0 and > 0, `load_model(retrieval="hier")` at the JAX defaults, and
the routing rules the port copies from the JAX function (the k_geo default
of res_rank banks, the fused-combine gate).

Sizes follow `tests/test_torch_hier.py`: an informative bank of 3,000 rows
with 256-d keys and bf16 128-d values, bn = 128, gsz_sem = gsz_geo = 16
(8 groups a tile), lr_rank = lr_geo = res_rank = 128; the int8 bank is the
same bank quantized by JAX.  JAX builds the HierBanks and the port loads
its archives (the rows in JAX's order).  Each knob subset is that bank
with the other knobs' operands dropped (`dataclasses.replace` on both
packages' banks alike), so both sides serve the same operands.  JAX's
Pallas kernels run in interpret mode.  Inputs are float32 (conftest
enables x64).
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
from range_tpu.ops import retrieval_hier as jh
from range_tpu.ops.retrieval_pallas import pack_queries as jax_pack_queries
from range_tpu_torch import load_model
from range_tpu_torch.convert.from_jax import (_tensor, geobank_from_arrays,
                                              siren_params_from_jax)
from range_tpu_torch.ops import retrieval_hier as th

KW = dict(bn=128, gsz_sem=16, gsz_geo=16, lr_rank=128, lr_geo=128,
          res_rank=128)
GPT = 8  # groups per tile of both families at bn=128, gsz=16
B = 256
Dv = 128

# each knob subset: the operands the other knobs' absence drops
NO_LR = dict(lr_rank=0, g_sem_vw_lr=None, u_sem=None)
NO_RR = dict(res_rank=0, z_sem=None, w_sem=None, z_geo=None, w_geo=None)
NO_LRG = dict(lr_geo=0, g_geo_vw_lr=None, u_geo=None)
SUBSETS = {"none": {**NO_LR, **NO_RR, **NO_LRG}, "lr": {**NO_RR, **NO_LRG},
           "rr": {**NO_LR, **NO_LRG}, "lr_rr": NO_LRG, "lr_rr_lrg": {},
           "lr_lrg": NO_RR}


def _np(x):
    return np.asarray(x).astype(np.float32)


def _t(x):
    return _tensor(np.asarray(x))


def _within_terms(got, ref, mag, frac=4e-3):
    """|got - ref| <= min(frac * the row's max |ref|, 2^-7 * mag) + 1e-6
    elementwise (`tests/test_torch_hier.py::_within_terms`): f32 logits in
    another summation order can move a bf16-rounded weight one ulp, which
    bounds each element by its own terms' magnitudes."""
    err = np.abs(got - ref)
    tol = np.minimum(frac * np.abs(ref).max(axis=1, keepdims=True),
                     2.0 ** -7 * mag) + 1e-6
    assert (err <= tol).all(), float((err / tol).max())


@pytest.fixture(scope="module")
def jbanks():
    jb = JaxGeoBank.synthetic_informative(5, 3000, key_dim=256, value_dim=Dv,
                                          pad_to=512, value_dtype=jnp.bfloat16)
    return {"bf16": jb, "int8": jax_quantize(jb)}


@pytest.fixture(scope="module")
def jhbs(jbanks):
    return {k: jh.build_hier_bank(b, **KW) for k, b in jbanks.items()}


@pytest.fixture(scope="module")
def thbs(jhbs, tmp_path_factory):
    out = {}
    for k, hb in jhbs.items():
        path = str(tmp_path_factory.mktemp("hier") / f"jax_{k}.npz")
        jh.save_hier_bank(hb, path)
        out[k] = th.load_hier_bank(path, device="cpu")
    return out


@pytest.fixture(scope="module")
def packed(jhbs):
    """B random unit queries and locations, packed (both families live) and
    geo-sorted as JAX does, and the tiles each selection keeps: the merged
    one (K = 8 of 24 per block of 128) and the two family-split ones (K = 8
    sem, 4 geo)."""
    rng = np.random.default_rng(0)
    ll = np.stack([rng.uniform(-180, 180, B),
                   np.degrees(np.arcsin(rng.uniform(-1, 1, B)))], 1)
    q = rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = jax_xyz(jnp.asarray(ll, jnp.float32))
    jhb = jhbs["bf16"]
    q_cat = jax_pack_queries(jnp.asarray(q), x, 12.0, 40.0, tier="fast")
    order = jh._hybrid_order(x, jnp.zeros(B, jnp.int32), B, jhb.t_pad,
                             sort="geo")
    q_cat = q_cat[order]
    stats = jh._hier_scan_stats_call(q_cat, jhb.g_sem_cat, jhb.g_geo_cat,
                                     bm=128, tc=4, gpt_s=GPT, gpt_g=GPT,
                                     interpret=True)
    sel = dict(t_real=24, bm=128, n_valid=B)
    idx, _ = jh.select_tiles(*stats, k_tiles=8, j_sem=3, j_geo=2,
                             mode="range+", **sel)
    idx_s, _ = jh.select_tiles(*stats, k_tiles=8, j_sem=3, j_geo=2,
                               mode="range", **sel)
    m_s, s_s, m_g, s_g = stats
    idx_g, _ = jh.select_tiles(m_g, s_g, m_s, s_s, k_tiles=4, j_sem=2,
                               j_geo=3, mode="range", **sel)
    return dict(q_cat=q_cat, idx=idx, idx_s=idx_s, idx_g=idx_g)


def _regional(jbank, seed, n=B):
    """n queries near 8 bank rows (3 degree jitter), each the bank key of
    its row plus noise: the coherent batches hier serving is built for."""
    rng = np.random.default_rng(seed)
    locs, keys = _np(jbank.locs_lonlat), _np(jbank.keys_sem)
    rows = np.repeat(rng.integers(0, 3000, 8), n // 8)
    ll = locs[rows] + rng.normal(0, 3.0, (n, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = keys[rows] + 0.3 * rng.standard_normal((n, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return q, np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32), \
        ll.astype(np.float32)


# ---------------------------------------------------------------- kernels


# the plain versions against JAX interpret mode on the same operands: f32
# sums of the same bf16 products in another order, so a bf16-rounded exp
# or weight can round the other way (`_within_terms`), each output segment
# held to its own scale
@pytest.mark.parametrize("case", ["full", "mixed", "no_geo"])
def test_scan_wide_tail_plain_matches_jax(packed, jhbs, thbs, case):
    """The scan over the full-width group value sums (W = Dv + 128): both
    families full width, the mixed launch RANGE+ takes on an lr-only bank
    (low-rank sem tail beside the full-width geo tail), and the geo-less
    launch of RANGE mode on a plain bank."""
    jhb, thb = jhbs["bf16"], thbs["bf16"]
    sem = "g_sem_vw_lr" if case == "mixed" else "g_sem_vw"
    has_geo = case != "no_geo"
    ref = jh._hier_scan_call(packed["q_cat"], jhb.g_sem_cat, jhb.g_geo_cat,
                             getattr(jhb, sem), jhb.g_geo_vw, bm=128, tc=4,
                             gpt_s=GPT, gpt_g=GPT, has_geo=has_geo,
                             interpret=True)
    args = (_t(packed["q_cat"]), thb.g_sem_cat, thb.g_geo_cat)
    kw = dict(gpt_s=GPT, gpt_g=GPT, has_geo=has_geo)
    got = th._hier_scan_plain(*args, getattr(thb, sem), thb.g_geo_vw, **kw)
    mag = th._hier_scan_plain(*args, getattr(thb, sem).abs(),
                              thb.g_geo_vw.abs(), **kw)[4].numpy()
    Ws = getattr(thb, sem).shape[1]
    for i in (0, 2) if has_geo else (0,):  # max logits, |l| < ~20
        np.testing.assert_allclose(got[i].numpy(), _np(ref[i]), rtol=0, atol=1e-4)
    for i in (1, 3) if has_geo else (1,):  # f32 sums of f32 exps
        np.testing.assert_allclose(got[i].numpy(), _np(ref[i]), rtol=1e-4, atol=0)
    tails, rtails = got[4].numpy(), _np(ref[4])
    assert tails.shape == (B, Ws + (Dv + 128 if has_geo else 0))
    segs = [slice(0, Ws)] + ([slice(Ws, Ws + Dv + 128)] if has_geo else [])
    for cols in segs:
        _within_terms(tails[:, cols], rtails[:, cols], mag[:, cols])


# Columns of the merged parts output without lr (Dv = 128).
ACC_S, ACC_G, D_S, D_G = (slice(0, 128), slice(128, 256), slice(256, 257),
                          slice(257, 258))


@pytest.mark.parametrize("geo", [True, False], ids=["geo", "no_geo"])
@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_parts_lr_false_plain_matches_jax(packed, jhbs, thbs, quant, geo):
    """`_hier_parts_call(lr=False)`: both approximations subtracted in the
    kernel, the sem one from acc_s and d_s.  Without the geo family the
    port writes zeros where JAX computes what RANGE mode discards."""
    jhb, thb = jhbs[quant], thbs[quant]
    ref = _np(jh._hier_parts_call(
        packed["q_cat"], jhb.k_cat, jhb.values, jhb.value_scale, jhb.mask_neg,
        packed["idx"], jhb.g_sem_cat, jhb.g_geo_cat, jhb.g_sem_vw,
        jhb.g_geo_vw, sem_d=256, bm=128, bn=128, gpt_s=GPT, gpt_g=GPT,
        lr=False, interpret=True))
    args = (_t(packed["q_cat"]), thb.k_cat, thb.values, thb.value_scale,
            thb.mask_neg, _t(packed["idx"]).to(torch.int32), thb.g_sem_cat,
            thb.g_geo_cat, thb.g_sem_vw, thb.g_geo_vw)
    kw = dict(sem_d=256, bm=128, bn=128, gpt_s=GPT, gpt_g=GPT, geo=geo,
              lr=False)
    before = th._hier_parts_call.launches
    got = th._hier_parts_call(*args, **kw).numpy()
    assert th._hier_parts_call.launches == before  # the plain version on the CPU
    mag = th._hier_parts_plain(*args, **kw, magnitude=True).numpy()
    assert got.shape == ref.shape == (B, 2 * Dv + 128)
    assert not got[:, 258:].any()
    for cols in (ACC_S, D_S) + ((ACC_G, D_G) if geo else ()):
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols])
    if not geo:
        assert not got[:, ACC_G].any() and not got[:, D_G].any()


# (shape, family, values): the value shapes with bf16 and int8 values, the
# rr shape (no values) with bf16
FAMILY_CASES = [(v, f, q) for v in ("plain", "lr") for f in ("sem", "geo")
                for q in ("bf16", "int8")] + [("rr", f, "bf16")
                                               for f in ("sem", "geo")]


@pytest.mark.parametrize("variant,fam,quant", FAMILY_CASES,
                         ids=["-".join(c) for c in FAMILY_CASES])
def test_parts_family_variants_plain_match_jax(packed, jhbs, thbs, variant,
                                               fam, quant):
    """`_hier_parts_family_plain` in its plain ([acc | d | pad]), lr ([acc
    | d | pad | alr]) and rr ([acc | d | pad | az]) shapes against JAX's
    `_hier_parts_family_call` on the same tiles; the lr shape over the
    family's low-rank coefficients, the others over its full-width sums."""
    jhb, thb = jhbs[quant], thbs[quant]
    geo = fam == "geo"
    lr = variant == "lr"
    idx = packed["idx_g" if geo else "idx_s"]
    g = "g_geo_cat" if geo else "g_sem_cat"
    vw = ("g_geo_vw" if geo else "g_sem_vw") + ("_lr" if lr else "")
    z = ("z_geo" if geo else "z_sem") if variant == "rr" else None
    lrr = (jhb.lr_geo if geo else jhb.lr_rank) if lr else Dv
    ref = _np(jh._hier_parts_family_call(
        packed["q_cat"], jhb.k_cat, jhb.values, jhb.value_scale, jhb.mask_neg,
        idx, getattr(jhb, g), getattr(jhb, vw),
        getattr(jhb, z) if z else None, sem_d=256, bm=128, bn=128, gpt=GPT,
        geo=geo, lr=lr, rr=int(z is not None), lrr=lrr, interpret=True))
    args = (_t(packed["q_cat"]), thb.k_cat, thb.mask_neg,
            _t(idx).to(torch.int32), getattr(thb, g), getattr(thb, vw),
            getattr(thb, z) if z else None)
    kw = dict(sem_d=256, bm=128, bn=128, gpt=GPT, geo=geo, lrr=lrr, lr=lr,
              values=thb.values, scale=thb.value_scale)
    before = th._hier_parts_family_call.launches
    got = th._hier_parts_family_call(*args, **kw).numpy()
    assert th._hier_parts_family_call.launches == before
    mag = th._hier_parts_family_plain(*args, **kw, magnitude=True).numpy()
    W = getattr(thb, vw).shape[1]
    width = {"plain": Dv + 128, "lr": Dv + 128 + W, "rr": Dv + 128 + 128}
    assert got.shape == ref.shape == (B, width[variant])
    assert not got[:, Dv + 1:Dv + 128].any()
    segs = [slice(0, Dv), slice(Dv, Dv + 1)]
    if variant != "plain":
        segs.append(slice(Dv + 128, None))  # alr, or az
    for cols in segs:
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols])


def test_combine_without_geo_lr_plain_matches_jax(packed, jhbs, thbs):
    """rg = 0: the geo family's rr-shape parts ([acc | d | pad | az]) and
    its full-width tail; f32 products in another summation order."""
    jhb, thb = jhbs["bf16"], thbs["bf16"]
    q_cat, idx_s, idx_g = packed["q_cat"], packed["idx_s"], packed["idx_g"]
    tails = jh._hier_scan_call(q_cat, jhb.g_sem_cat, jhb.g_geo_cat,
                               jhb.g_sem_vw_lr, jhb.g_geo_vw, bm=128, tc=4,
                               gpt_s=GPT, gpt_g=GPT, interpret=True)[4]
    common = dict(sem_d=256, bm=128, bn=128, gpt=GPT, rr=1, interpret=True)
    ps = jh._hier_parts_family_call(
        q_cat, jhb.k_cat, jhb.values, None, jhb.mask_neg, idx_s, jhb.g_sem_cat,
        jhb.g_sem_vw_lr, jhb.z_sem, geo=False, lr=True, lrr=128, **common)
    pg = jh._hier_parts_family_call(
        q_cat, jhb.k_cat, jhb.values, None, jhb.mask_neg, idx_g, jhb.g_geo_cat,
        jhb.g_geo_vw, jhb.z_geo, geo=True, lr=False, lrr=Dv, **common)
    q = jnp.asarray(np.random.default_rng(4).standard_normal((B, 128)),
                    jnp.float32)
    ck = dict(Ws=256, r=128, rrp=128, Dv=Dv, beta=0.3, rg=0, Wg=Dv + 128)
    ref = _np(jh._combine_cat_call(ps, pg, tails, q, jhb.w_sem, jhb.u_sem,
                                   jhb.w_geo, None, bm=128, interpret=True,
                                   **ck))
    before = th._combine_cat_call.launches
    got = th._combine_cat_call(_t(ps), _t(pg), _t(tails), _t(q), thb.w_sem,
                               thb.u_sem, thb.w_geo, None, **ck).numpy()
    assert th._combine_cat_call.launches == before
    assert got.shape == ref.shape == (B, Dv + 128)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- serving


def _subset(hb, name):
    return dataclasses.replace(hb, **SUBSETS[name])


ROUTES = [("range", 0), ("range+", 0), ("range+", 4)]


@pytest.mark.parametrize("mode,k_geo", ROUTES, ids=[f"{m}-kg{k}" for m, k in ROUTES])
@pytest.mark.parametrize("subset", list(SUBSETS))
def test_retrieve_hier_subsets_match_jax(jhbs, thbs, jbanks, subset, mode,
                                         k_geo):
    """`retrieve_hier` over each knob subset, RANGE and RANGE+, k_geo 0 and
    4: the port takes JAX's route (the merged branch, or the family split
    with the fused or the torch combine) and its output.  Tolerance: the
    scan tail and parts within one bf16 ulp of a term (above), through
    the unprojection and the normalization; 2e-4 on outputs ~0.1-1, as
    `tests/test_torch_hier_api.py` holds the flagship."""
    jhb, thb = _subset(jhbs["bf16"], subset), _subset(thbs["bf16"], subset)
    q, x, _ = _regional(jbanks["bf16"], seed=1)
    xs = None if mode == "range" else x
    kw = dict(mode=mode, k_tiles=8, k_geo=k_geo, bm=128, j_sem=3,
              sem_temp=15.0 if mode == "range" else 12.0)
    j = _np(jh.retrieve_hier(jnp.asarray(q), None if xs is None else
                             jnp.asarray(xs), jhb, concat_query=jnp.asarray(q),
                             interpret=True, **kw))
    t = th.retrieve_hier(_t(q), None if xs is None else _t(xs), thb,
                         concat_query=_t(q), **kw).numpy()
    assert t.shape == j.shape == (B, Dv + 256) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
def test_load_model_hier_defaults_match_jax(jbanks, tmp_path, name):
    """`load_model(name, retrieval="hier")` at the JAX package's defaults
    (gsz_sem 8, k_tiles 16, k_geo 0, no lr_rank / res_rank / lr_geo; bn cut
    to 128 and gsz_geo to 16 for the test bank): JAX builds the HierBank
    into its hier cache, the port loads it (equal signatures) and serves
    with the same tower weights (f32).  Both widen k_tiles 3x at B = 256:
    the default 16 would make all 24 tiles exact and cancel the tail, so
    k_tiles is cut to 4 (12 of 24 after the widening).  Tolerance 2e-4, as
    the flagship's."""
    jb = jbanks["bf16"]
    cache = str(tmp_path / "hb.npz")
    kw = dict(retrieval="hier", hier_bn=128, gsz_geo=16, chunk=512, seed=0,
              k_tiles=4, hier_cache=cache)
    jenc = range_tpu.load_model(name, db_path=jb, **kw)
    sig = th.peek_hier_build(cache)
    bank = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values,
                               jb.n_valid)
    enc = load_model(name, db_path=bank, device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    assert th.peek_hier_build(cache) == sig  # loaded, not rebuilt
    hb = enc.model.bank
    assert (hb.gsz_sem, hb.lr_rank, hb.res_rank, hb.lr_geo) == (8, 0, 0, 0)
    _, _, ll = _regional(jb, seed=2)
    j = np.asarray(jenc(jnp.asarray(ll)))
    t = enc(ll).numpy()
    assert t.shape == j.shape == (B, Dv + 256)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


# ---------------------------------------------------------------- routing


def _spy(monkeypatch, names):
    """Count the calls of the named retrieval_hier functions."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(th, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(th, name, wrapped)
    return calls


def test_k_geo_defaults_only_with_res_rank(jhbs, thbs, jbanks, monkeypatch):
    """JAX gives k_geo = max(8, k_tiles // 2) only to banks with res_rank
    (`retrieval_hier.py:3262-3264`): a plain bank at k_geo = 0 takes the
    merged branch (one merged parts call, no family parts) and JAX's
    merged output; a res_rank bank takes the family split."""
    q, x, _ = _regional(jbanks["bf16"], seed=3)
    calls = _spy(monkeypatch, ["_hier_parts_call", "_hier_parts_family_call"])
    kw = dict(k_tiles=8, bm=128)
    for subset, want in (("none", (1, 0)), ("rr", (0, 2))):
        jhb, thb = _subset(jhbs["bf16"], subset), _subset(thbs["bf16"], subset)
        before = tuple(calls.values())
        t = th.retrieve_hier(_t(q), _t(x), thb, **kw).numpy()
        got = tuple(a - b for a, b in zip(calls.values(), before))
        assert got == want, subset
        j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb,
                                 interpret=True, **kw))
        np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


GATE = [  # (subset, concat columns or None, k_geo, fused)
    ("lr_rr_lrg", 128, 4, True), ("lr_rr", 128, 0, True),
    ("lr_rr_lrg", None, 4, False), ("lr_rr_lrg", 96, 4, False),
    ("lr_lrg", 128, 4, False), ("rr", 128, 4, False)]


@pytest.mark.parametrize("subset,dq,k_geo,fused", GATE,
                         ids=[f"{s}-dq{d}-kg{k}" for s, d, k, _ in GATE])
def test_fused_combine_gate_follows_jax(jhbs, thbs, jbanks, monkeypatch,
                                        subset, dq, k_geo, fused):
    """The fused combine + concat runs exactly where JAX's fused_cat holds
    (`retrieval_hier.py:3291-3295`: concat_query, RANGE+, lr and rr, k_geo
    > 0, 128-aligned Dv / lr_rank / lr_geo / Dq); elsewhere the combine
    branches of `_hier_partials` in torch.  Either way the output is
    JAX's (2e-4)."""
    jhb, thb = _subset(jhbs["bf16"], subset), _subset(thbs["bf16"], subset)
    q, x, _ = _regional(jbanks["bf16"], seed=4)
    cq = None if dq is None else np.ascontiguousarray(q[:, :dq])
    calls = _spy(monkeypatch, ["_combine_cat_call"])
    kw = dict(k_tiles=8, k_geo=k_geo, bm=128)
    t = th.retrieve_hier(_t(q), _t(x), thb, concat_query=None if cq is None
                         else _t(cq), **kw).numpy()
    assert calls["_combine_cat_call"] == int(fused)
    j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb,
                             concat_query=None if cq is None else jnp.asarray(cq),
                             interpret=True, **kw))
    assert t.shape == j.shape == (B, Dv + (dq or 0))
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_tail_super_without_lr_matches_jax(jbanks, tmp_path):
    """A tail_super bank without lr_rank (full-width supergroup tail and
    correction operand, W = Dv + 128): JAX builds it, the port loads the
    archive, and RANGE+ at k_geo = 4, m_corr = 4 (the family split, plain
    shapes, the correction over all K + m_corr tiles) matches JAX (2e-4)."""
    jhb = jh.build_hier_bank(jbanks["bf16"], bn=128, gsz_sem=16, gsz_geo=16,
                             tail_super=64)
    path = str(tmp_path / "ts.npz")
    jh.save_hier_bank(jhb, path)
    thb = th.load_hier_bank(path, device="cpu")
    assert thb.g_sem_ts_dvw.shape[1] == Dv + 128 and thb.lr_rank == 0
    q, x, _ = _regional(jbanks["bf16"], seed=6)
    kw = dict(k_tiles=8, k_geo=4, m_corr=4, bm=128)
    j = _np(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb,
                             concat_query=jnp.asarray(q), interpret=True, **kw))
    t = th.retrieve_hier(_t(q), _t(x), thb, concat_query=_t(q), **kw).numpy()
    assert t.shape == j.shape == (B, Dv + 256)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_unservable_banks_still_raise(thbs):
    """Every bank serves now: the two-level feature path (supergroup
    operands without lr_rank; here supergroups equal to the fine groups, so
    the refine's fine-minus-supergroup term is zero), a bank whose sel_lr is
    set without its sketch (served as the plain bank, JAX's use_sel) and
    every knob subset."""
    thb = thbs["bf16"]
    q = torch.nn.functional.normalize(torch.randn(8, 256), dim=1)
    x = torch.nn.functional.normalize(torch.randn(8, 3), dim=1)
    plain = _subset(thb, "none")
    two_level = dataclasses.replace(plain, gsz_super=plain.gsz_sem,
                                    g_sup_cat=plain.g_sem_cat, g_sup_vw=plain.g_sem_vw)
    out = th.retrieve_hier(q, x, two_level, bm=128)
    assert out.shape == (8, Dv) and torch.isfinite(out).all()
    assert torch.equal(th.retrieve_hier(q, x, dataclasses.replace(thb, sel_lr=32), bm=128),
                       th.retrieve_hier(q, x, thb, bm=128))
    for name in SUBSETS:
        assert th.retrieve_hier(q, x, _subset(thb, name), bm=128).shape == (8, Dv)
