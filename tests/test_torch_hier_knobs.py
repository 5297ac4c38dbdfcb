"""The rest of one-level hierarchical serving in range_tpu_torch, each piece
against its range_tpu counterpart on the CPU: the rank-k PCA sketches
(`_lowrank_centroid_factor`, ``build_hier_bank(topk_lr=, sel_lr=)``),
`hier_topk` on a topk_lr bank, `retrieve_hier` on a sel_lr bank (the sem
parts kernel's sel form), the tile-list union (`_dedup_union`) and dedup
serving (the dedup_pad form), the adaptive rescue, and `load_model` with
each knob.

Sizes follow `tests/test_hier.py:1020-1110` and `tests/test_torch_hier.py`:
the 3,000-row informative bank (256-d keys, bf16 128-d values), bn = 128,
gsz_sem = gsz_geo = 16, topk_gsz = 8, lr_rank = lr_geo = res_rank = 128,
and topk_lr = sel_lr = 64.  JAX builds one bank with every knob and the
port loads its archive, so both sides serve the same sketch (PCA factors
are unique only up to signs and rotations); shapes without a knob drop
its operands with `dataclasses.replace` on both packages' banks.  JAX's
Pallas kernels run in interpret mode.  Inputs are float32 (conftest
enables x64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import KW, _np, jbank, tbank  # noqa: F401
from test_torch_topk import _hilo, _row_logits, _rows_agree_outside_near_ties

import range_tpu
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch import load_model
from range_tpu_torch.convert.from_jax import geobank_from_arrays, siren_params_from_jax
from range_tpu_torch.geometry import lonlat_deg_to_xyz
from range_tpu_torch.ops import retrieval as tret
from range_tpu_torch.ops import retrieval_hier as th

KNOBS = dict(topk_lr=64, sel_lr=64)
B = 256
# the port's f32 sums of the same bf16 products in other orders, a
# bf16-rounded weight one ulp the other way: 2e-4 on outputs ~0.5
# (`tests/test_torch_hier_api.py::test_flagship_matches_jax`)
ATOL = 2e-4


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def jkb(jbank):
    return jh.build_hier_bank(jbank, **KW, **KNOBS)


@pytest.fixture(scope="module")
def tkb(jkb, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("knobs") / "knobs.npz")
    jh.save_hier_bank(jkb, path)
    return th.load_hier_bank(path, device="cpu")


@pytest.fixture(scope="module")
def regional(jkb):
    """B queries near 8 bank rows (3 degree jitter), each a bank key
    nearby plus noise: the coherent batches hier serves."""
    rng = np.random.default_rng(31)
    locs, keys = _np(jkb.bank.locs_lonlat), _np(jkb.bank.keys_sem)
    rows = np.repeat(rng.integers(0, int(jkb.bank.n_valid), 8), B // 8)
    ll = locs[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = keys[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    return q, np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)


_DROP = {"plain": dict(lr_rank=0, g_sem_vw_lr=None, res_rank=0, z_sem=None, z_geo=None,
                       lr_geo=0, g_geo_vw_lr=None),
         "nosel": dict(sel_lr=0, g_sem_sel=None)}


def _both(jb, tb, *drops):
    kw = {k: v for d in drops for k, v in _DROP[d].items()}
    return dataclasses.replace(jb, **kw), dataclasses.replace(tb, **kw)


def _serve_both(jb, tb, regional, concat, **kw):
    q, x = regional
    j = np.asarray(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jb,
                                    concat_query=jnp.asarray(q) if concat else None,
                                    interpret=True, **kw))
    t = th.retrieve_hier(_t(q), _t(x), tb, concat_query=_t(q) if concat else None,
                         **kw).numpy()
    assert t.shape == j.shape
    return t, j


# ---------------------------------------------------------------- build


@pytest.mark.parametrize("k", [64, 256])
def test_lowrank_centroid_factor_matches_jax(jkb, k):
    """The factors differ by signs (and rotations in degenerate
    eigenspaces), so hold what serving reads: the reconstruction
    coef @ basis and the sketched logits (q @ basis^T) @ coef^T, within
    the bf16 rounding of the stored coefficients (2^-8 of each, summed
    over k products: 1e-2 of the largest value); the basis is
    orthonormal in both."""
    g = jkb.g_sem_cat
    jc, jp = (_np(a) for a in jh._lowrank_centroid_factor(g, k))
    tc, tp = th._lowrank_centroid_factor(_t(_np(g)).bfloat16(), k)
    assert tc.dtype == torch.bfloat16 and tp.dtype == torch.float32
    tc, tp = tc.float().numpy(), tp.numpy()
    assert tc.shape == jc.shape == (g.shape[0], k) and tp.shape == jp.shape == (k, 256)
    ref = jc @ jp
    np.testing.assert_allclose(tc @ tp, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    np.testing.assert_allclose(tp @ tp.T, np.eye(k), rtol=0, atol=1e-4)
    q = np.random.default_rng(5).standard_normal((64, 256)).astype(np.float32)
    ref = (q @ jp.T) @ jc.T
    np.testing.assert_allclose((q @ tp.T) @ tc.T, ref, rtol=0,
                               atol=1e-2 * np.abs(ref).max())
    if k == 256:  # complete rank: the sketch reproduces the centroids
        np.testing.assert_allclose(tc @ tp, _np(g), rtol=0, atol=1e-2 * np.abs(_np(g)).max())


@pytest.fixture(scope="module")
def injected(jkb):
    """The port's build of JAX's clustered bank (JAX's row order)."""
    cb = jkb.bank
    tcb = geobank_from_arrays(cb.locs_lonlat, cb.xyz, cb.keys_sem, cb.values, cb.n_valid,
                              cb.valid_mask)
    return th.pack_hier_bank(tcb, **KW, **KNOBS)


@pytest.mark.parametrize("coef,basis,src", [("g_topk_lr", "p_topk", "g_topk_cat"),
                                            ("g_sem_sel", "p_sel", "g_sem_cat")])
def test_build_sketches_match_jax(jkb, injected, coef, basis, src):
    """The sketches of the same (bf16, equal to JAX's within a ulp)
    centroids: reconstruction and projector, as the factor test."""
    assert injected.topk_lr == jkb.topk_lr == 64 and injected.sel_lr == jkb.sel_lr == 64
    jc, jp = _np(getattr(jkb, coef)), _np(getattr(jkb, basis))
    tc, tp = getattr(injected, coef).float().numpy(), getattr(injected, basis).numpy()
    assert tc.shape == jc.shape and tp.shape == jp.shape
    assert getattr(injected, coef).dtype == torch.bfloat16
    ref = jc @ jp
    np.testing.assert_allclose(tc @ tp, ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    np.testing.assert_allclose(tp.T @ tp, jp.T @ jp, rtol=0, atol=1e-3)
    # zero pad groups project to zero coefficients
    pad = ~_np(getattr(jkb, src)).any(axis=1)
    assert pad.any() and not tc[pad].any()


def test_build_knob_rules_and_signature(jbank, tbank):
    """The signature keys topk_lr and sel_lr (sel_lr clamped to the key
    width) as JAX's; topk_lr needs topk_gsz; sel_lr beside tail_super and
    the knobs' clamps."""
    sig = dict(bn=128, gsz_sem=16, gsz_geo=16, tier="fast", seed=0, shards=1, topk_gsz=8,
               topk_lr=64, sel_lr=999)
    t = th.hier_build_signature(tbank, **sig)
    assert t == jh.hier_build_signature(jbank, **sig)
    assert t["topk_lr"] == 64 and t["sel_lr"] == 256
    with pytest.raises(ValueError, match="topk_gsz"):
        th.build_hier_bank(tbank, bn=128, gsz_sem=16, gsz_geo=16, topk_lr=32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        th.build_hier_bank(tbank, bn=128, gsz_sem=16, gsz_geo=16, sel_lr=32, tail_super=32)
    hb = th.build_hier_bank(tbank, bn=128, gsz_sem=16, gsz_geo=16, sel_lr=999)
    assert hb.sel_lr == 256 and hb.g_sem_sel.shape == (hb.g_sem_cat.shape[0], 256)


# ---------------------------------------------------------------- hier_topk


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("with_xyz", [True, False], ids=["xyz", "no_xyz"])
def test_hier_topk_topk_lr_rows_equal_jax(jkb, tkb, regional, k, with_xyz):
    """The low-rank selection signal: the queries' sketch (f32 products,
    rounded to bf16) against g_topk_lr, then the exact argmax / k-carry.
    Rows equal JAX's outside near-ties (`tests/test_torch_topk.py`: rival
    logits within 2e-6)."""
    q, x = regional
    xx = x if with_xyz else None
    kw = dict(k_tiles=4, bm=128, auto_widen=False)
    j = np.asarray(jh.hier_topk(jnp.asarray(q), None if xx is None else jnp.asarray(xx), jkb,
                                k=k, interpret=True, **kw))
    n0 = th._hier_scan_stats_call.launches
    t = th.hier_topk(_t(q), None if xx is None else _t(xx), tkb, k=k, **kw)
    assert th._hier_scan_stats_call.launches == n0  # the plain version on the CPU
    assert t.dtype == torch.int32 and t.shape == j.shape
    t, j = t.numpy().reshape(B, -1), j.reshape(B, -1)
    if (t != j).any():
        q2, ql = _hilo(q)
        ref = _row_logits(q2, ql, jkb.khl_sem, jkb.mask_neg, j, 256)
        _rows_agree_outside_near_ties(t, j, ref, q2, ql, jkb.khl_sem, jkb.mask_neg, 256,
                                      f"topk_lr k={k}")


def test_hier_topk_topk_lr_recall(tkb, regional):
    """At rank 64 the sketched selection's recall@1 against the exact NN
    stays within 0.02 of the full stats operand's (`tests/test_hier.py:
    1048-1050`)."""
    q, x = _t(regional[0]), _t(regional[1])
    full = dataclasses.replace(tkb, topk_lr=0, g_topk_lr=None)
    true = tret.exact_nn(q, tkb.bank)
    rec = [(th.hier_topk(q, x, hb, k_tiles=4, bm=128) == true).float().mean().item()
           for hb in (tkb, full)]
    assert rec[0] >= rec[1] - 0.02, rec


# ---------------------------------------------------------------- sel_lr


@pytest.mark.parametrize("shape", ["flagship", "plain"])
def test_retrieve_hier_sel_lr_matches_jax(jkb, tkb, regional, shape):
    """A sel_lr bank: the scan over [q_sel | geo columns] against
    g_sem_sel, the sem parts kernel's sel form over [q_cat | q_sel].  The
    flagship shape (lr + rr + lr_geo, the fused combine) and the plain
    value shape (no lr / rr / lr_geo, the combine in torch).  Tolerance
    ATOL."""
    jb, tb = _both(jkb, tkb, *(["plain"] if shape == "plain" else []))
    t, j = _serve_both(jb, tb, regional, shape == "flagship", k_tiles=4, k_geo=2, bm=128)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def test_sel_lr_fidelity_and_routing(tkb, regional):
    """At rank 64 the error against the exact dense path stays within 0.02
    of the full operands' (`tests/test_hier.py:1090`); sel_lr banks serve
    through the family split only (ValueError "family-split", as JAX);
    a bank whose sel_lr is set without its sketch serves as a plain bank
    (JAX's use_sel)."""
    q, x = _t(regional[0]), _t(regional[1])
    kw = dict(k_tiles=4, k_geo=2, bm=128)
    full = dataclasses.replace(tkb, sel_lr=0, g_sem_sel=None)
    ref = tret.retrieve(q, x, tkb.bank, sem_temp=12.0, beta=0.5)
    err = [((th.retrieve_hier(q, x, hb, **kw) - ref).abs() / ref.abs().clamp_min(0.1)).mean()
           for hb in (tkb, full)]
    assert err[0] <= err[1] + 0.02, err
    for mode, k_geo in (("range+", 0), ("range", 2)):
        with pytest.raises(ValueError, match="family-split"):
            th.retrieve_hier(q, x, dataclasses.replace(tkb, res_rank=0, z_sem=None), mode=mode,
                             k_tiles=4, k_geo=k_geo, bm=128)
    unsketched = dataclasses.replace(tkb, g_sem_sel=None)
    assert torch.equal(th.retrieve_hier(q, x, unsketched, **kw),
                       th.retrieve_hier(q, x, full, **kw))


# ---------------------------------------------------------------- dedup


def test_dedup_union_equals_jax():
    """The cases of `tests/test_hier.py::test_dedup_union_unit` (rank-major
    order, repeats dropped, pad slots repeating the last distinct tile,
    truncation keeping each block's top ranks) and random lists with many
    shared tiles: equal to JAX's exactly."""
    idx = np.asarray([[0, 1, 2, 3], [2, 3, 4, 5], [10, 11, 12, 13], [12, 1, 0, 9]], np.int32)
    u = th._dedup_union(_t(idx), 2, 8).numpy()
    np.testing.assert_array_equal(u, np.asarray(jh._dedup_union(jnp.asarray(idx), 2, 8)))
    assert set(u[0][:6].tolist()) == {0, 1, 2, 3, 4, 5}
    assert u[0][6] == u[0][5] and u[0][7] == u[0][5]
    assert u[0][0] == 0 and u[0][1] == 2
    assert set(u[1][:7].tolist()) == {10, 11, 12, 13, 1, 0, 9} and u[1][7] == u[1][6]
    assert th._dedup_union(_t(idx), 2, 4).tolist() == [[0, 2, 1, 3], [10, 12, 11, 1]]
    rng = np.random.default_rng(7)
    for f, K, ku in ((2, 4, 8), (2, 4, 4), (2, 16, 24), (4, 8, 17), (3, 5, 100)):
        idx = np.stack([rng.choice(20, K, replace=False) for _ in range(6 * f)]).astype(np.int32)
        t = th._dedup_union(_t(idx), f, ku)
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(jh._dedup_union(
            jnp.asarray(idx), f, ku)))


@pytest.mark.parametrize("shape", ["flagship", "plain"])
def test_dedup_serving_matches_jax(jkb, tkb, regional, shape):
    """dedup=2: two 128-query blocks' lists merge into one of k_union
    (automatic: 4 + 2 = 6 sem tiles, 3 geo) served as 256-query blocks
    by the dedup_pad form, on the flagship (lr + rr) and the plain value
    shapes.  Tolerance ATOL."""
    jb, tb = _both(jkb, tkb, "nosel", *(["plain"] if shape == "plain" else []))
    t, j = _serve_both(jb, tb, regional, shape == "flagship", k_tiles=4, k_geo=2, bm=128,
                       dedup=2)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    base = th.retrieve_hier(_t(regional[0]), _t(regional[1]), tb, k_tiles=4, k_geo=2, bm=128,
                            concat_query=_t(regional[0]) if shape == "flagship" else None)
    assert not torch.equal(torch.from_numpy(t), base)  # dedup changed the exact sets


@pytest.mark.parametrize("shape", ["flagship", "plain"])
def test_dedup_all_tiles_exact(jkb, tkb, regional, shape):
    """`tests/test_hier.py::test_hier_dedup_all_tiles_exact`: with every tile
    selected, each merged list is every tile once plus as many pad
    repeats; skipping them leaves the exact softmax up to the bf16 weights
    (< 5e-3 of max(|ref|, 0.1)), where running a repeat would double its
    tile's (exact - approx) term."""
    _, tb = _both(jkb, tkb, "nosel", *(["plain"] if shape == "plain" else []))
    q, x = _t(regional[0]), _t(regional[1])
    T = tb.t_real
    # two all-tiles lists merge into every tile once, then T pad repeats
    union = th._dedup_union(torch.stack([torch.randperm(T), torch.randperm(T)])[None, :]
                            .reshape(2, T).int(), 2, 2 * T)
    assert sorted(union[0, :T].tolist()) == list(range(T))
    assert (union[0, T:] == union[0, T - 1]).all()
    out = th.retrieve_hier(q, x, tb, k_tiles=T, k_geo=T, bm=128, dedup=2)
    ref = tret.retrieve(q, x, tb.bank, sem_temp=12.0, beta=0.5)
    assert ((out - ref).abs() / ref.abs().clamp_min(0.1)).max() < 5e-3


# ---------------------------------------------------------------- rescue


def _jax_worst(s_s, sel_s, s_g, sel_g, bm, n_valid, R):
    """`retrieval_hier.py:2902-2916`, the rescue's query choice, as JAX
    computes it."""
    Bp = s_s.shape[0]

    def cov(s, selm):
        tot = jnp.maximum(jnp.sum(s, axis=1), 1e-30)
        selq = jnp.einsum("bqt,bt->bq", s.reshape(Bp // bm, bm, -1), selm,
                          preferred_element_type=jnp.float32).reshape(Bp)
        return selq / tot

    import jax

    c = jnp.minimum(cov(s_s, sel_s), cov(s_g, sel_g))
    c = jnp.where(jnp.arange(Bp) < n_valid, c, jnp.inf)
    return jnp.sort(jax.lax.top_k(-c, R)[1].astype(jnp.int32))


def test_rescue_queries_equal_jax(jkb, regional):
    """The R = 128 lowest-coverage queries of JAX's scan and selections,
    padded rows excluded: the same positions."""
    q, x = regional
    from range_tpu.ops.retrieval_pallas import pack_queries as jax_pack_queries

    qc = jax_pack_queries(jnp.asarray(q[:250]), jnp.asarray(x[:250]), 12.0, 40.0, tier="fast")
    qc = jnp.pad(qc, ((0, 6), (0, 0)))
    m_s, s_s, m_g, s_g, _ = jh._hier_scan_call(qc, jkb.g_sem_cat, jkb.g_geo_cat,
                                               jkb.g_sem_vw_lr, jkb.g_geo_vw_lr, bm=128,
                                               tc=4, gpt_s=8, gpt_g=8, interpret=True)
    _, sel_s = jh.select_tiles(m_s, s_s, m_g, s_g, t_real=24, k_tiles=4, bm=128, n_valid=250,
                               mode="range")
    _, sel_g = jh.select_tiles(m_g, s_g, m_s, s_s, t_real=24, k_tiles=2, bm=128, n_valid=250,
                               mode="range")
    j = np.asarray(_jax_worst(s_s, sel_s, s_g, sel_g, 128, 250, 128))
    t = th._rescue_queries(*[_t(_np(a)) for a in (s_s, sel_s, s_g, sel_g)], bm=128,
                           n_valid=250, R=128)
    np.testing.assert_array_equal(t.numpy(), j)
    assert (t < 250).all() and (torch.diff(t) > 0).all()


@pytest.mark.parametrize("shape", ["flagship", "plain"])
def test_rescue_matches_jax_and_is_surgical(jkb, tkb, regional, shape):
    """adaptive_frac = 0.5, adaptive_mult = 4 (R = 128 of 256 queries,
    re-selected at 4x the budgets in one 128-query block): the output
    within ATOL of JAX's; rows not rescued bit-identical to the
    adaptive_frac = 0 output (`tests/test_hier.py:753-755`); the rescued
    rows' error against the exact path lower on average, and its p99 and
    max no higher (x 1.001); the fused combine against the torch combine
    within 1e-5 (`:761`)."""
    jb, tb = _both(jkb, tkb, "nosel", *(["plain"] if shape == "plain" else []))
    kw = dict(k_tiles=4, k_geo=2, bm=128)
    resc = dict(adaptive_frac=0.5, adaptive_mult=4)
    t, j = _serve_both(jb, tb, regional, False, **kw, **resc)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)
    q, x = _t(regional[0]), _t(regional[1])
    base = th.retrieve_hier(q, x, tb, **kw).numpy()
    changed = (base != t).any(axis=1)
    assert 0 < changed.sum() <= 128
    np.testing.assert_array_equal(t[~changed], base[~changed])
    ref = tret.retrieve(q, x, tb.bank, sem_temp=12.0, beta=0.5).numpy()
    den = np.maximum(np.abs(ref), 0.1)
    e_b, e_r = ((np.abs(o - ref) / den).max(axis=1) for o in (base, t))
    assert e_r[changed].mean() < e_b[changed].mean()
    assert np.percentile(e_r, 99) <= np.percentile(e_b, 99) * 1.001
    assert e_r.max() <= e_b.max() * 1.001
    if shape == "flagship":
        fused = th.retrieve_hier(q, x, tb, concat_query=q, **kw, **resc).numpy()
        np.testing.assert_allclose(fused[:, :128], t, rtol=1e-5, atol=1e-5)


def test_rescue_on_tail_super_matches_jax(jbank, regional, tmp_path):
    """The rescue on a tail_super bank (the correction re-run for the
    rescued queries' wider list, `retrieval_hier.py:2924-2931`) against
    JAX's, within ATOL."""
    jts = jh.build_hier_bank(jbank, bn=128, gsz_sem=8, gsz_geo=16, lr_rank=128, lr_geo=128,
                             res_rank=128, tail_super=32)
    path = str(tmp_path / "ts.npz")
    jh.save_hier_bank(jts, path)
    tts = th.load_hier_bank(path, device="cpu")
    t, j = _serve_both(jts, tts, regional, True, k_tiles=4, k_geo=2, bm=128, m_corr=4,
                       adaptive_frac=0.5, adaptive_mult=3)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


# ---------------------------------------------------------------- load_model


@pytest.mark.parametrize("knobs", [dict(sel_lr=64), dict(topk_lr=64),
                                   dict(adaptive_frac=0.5, adaptive_mult=4)],
                         ids=["sel_lr", "topk_lr", "rescue"])
def test_load_model_knob_matches_jax(jbank, tmp_path, knobs):
    """load_model("RANGE+", profile="flagship", **knob) on both packages:
    JAX builds the HierBank into its hier cache, the port loads it (equal
    signatures) and serves with the JAX weights carried across, B = 256
    regional queries (bm 128: the rescue takes R = 128).  2e-4, as the
    flagship's (`tests/test_torch_hier_api.py`)."""
    cache = str(tmp_path / "hb.npz")
    kw = dict(profile="flagship", k_tiles=4, k_geo=2, hier_cache=cache, tower_matmul=None,
              hier_bn=128, gsz_geo=16, chunk=512, seed=0, **knobs)
    jenc = range_tpu.load_model("RANGE+", db_path=jbank, **kw)
    sig = th.peek_hier_build(cache)
    bank = geobank_from_arrays(jbank.locs_lonlat, jbank.xyz, jbank.keys_sem, jbank.values,
                               jbank.n_valid)
    enc = load_model("RANGE+", db_path=bank, device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    assert th.peek_hier_build(cache) == sig  # loaded, not rebuilt
    for k, v in knobs.items():
        got = getattr(enc.model.bank, k) if k.endswith("_lr") else getattr(enc.model.config, k)
        assert got == v, k
    rng = np.random.default_rng(4)
    locs = np.asarray(jbank.locs_lonlat)[np.repeat(rng.integers(0, 2000, 8), 32)]
    coords = (locs + rng.normal(0, 3.0, locs.shape)).astype(np.float32)
    coords[:, 1] = np.clip(coords[:, 1], -89.9, 89.9)
    coords[:, 0] = (coords[:, 0] + 180) % 360 - 180
    j = np.asarray(jenc(jnp.asarray(coords)))
    t = enc(coords).numpy()
    assert t.shape == j.shape == (256, 384)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def test_load_model_dedup_routes_as_jax(tkb):
    """load_model(dedup=2, k_union=40) passes dedup and k_union to
    retrieve_hier from 8,192 queries on, and not below
    (`range_tpu/models/range_encoder.py:205-221`): at B = 8,192 its answer
    is retrieve_hier's with both, at B = 64 the answer without dedup
    (retrieve_hier with dedup is held against JAX's in the tests above,
    the automatic k_union too)."""
    k_union = 40
    bank = dataclasses.replace(tkb, sel_lr=0, g_sem_sel=None)
    kw = dict(profile="flagship", hier_bn=128, gsz_geo=16, chunk=512, seed=0, topk_lr=64)
    enc = load_model("RANGE+", db_path=bank, device="cpu", dedup=2, k_union=k_union, **kw)
    plain = load_model("RANGE+", db_path=bank, device="cpu", **kw)
    assert (enc.model.config.dedup, enc.model.config.k_union) == (2, k_union)
    rng = np.random.default_rng(6)
    locs = _np(bank.bank.locs_lonlat)[np.repeat(rng.integers(0, 2000, 64), 128)]
    coords = torch.from_numpy((locs + rng.normal(0, 3.0, locs.shape)).astype(np.float32))
    coords[:, 1] = coords[:, 1].clamp(-89.9, 89.9)
    coords[:, 0] = (coords[:, 0] + 180) % 360 - 180
    cfg = enc.model.config
    got = enc(coords)
    q = got[:, 128:]  # the concat: the query embeddings themselves
    bm, k_tiles, k_geo, j_sem = cfg.hier_plan(8192)
    want = th.retrieve_hier(q, lonlat_deg_to_xyz(coords), bank, k_tiles=k_tiles,
                            k_geo=k_geo, bm=bm, j_sem=j_sem, j_geo=cfg.j_geo,
                            concat_query=q, dedup=2, k_union=k_union)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert torch.equal(enc(coords[:64]), plain(coords[:64]))
