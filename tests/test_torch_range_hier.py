"""Hierarchical RANGE (the merged parts path) and int8 HierBanks in
range_tpu_torch, against range_tpu on the CPU.

Sizes follow `tests/test_torch_hier.py`: an informative bank of 3,000 rows
with 256-d keys and bf16 128-d values, bn = 128, gsz_sem = gsz_geo = 16,
topk_gsz = 8 and lr_rank = lr_geo = res_rank = 128 (the flagship's knobs
clamped at Dv = 128); the int8 bank is the same bank quantized by JAX.
JAX builds both HierBanks once and the port loads them from JAX's archives
(the rows in JAX's order); JAX's Pallas kernels run in interpret mode.
Inputs are float32 (conftest enables x64).
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
from range_tpu_torch import GeoBank, load_model
from range_tpu_torch.bank import dequantize_values, quantize_values
from range_tpu_torch.convert.from_jax import (_tensor, geobank_from_arrays,
                                              siren_params_from_jax)
from range_tpu_torch.geometry import lonlat_deg_to_xyz
from range_tpu_torch.ops import retrieval
from range_tpu_torch.ops import retrieval_hier as th

KW = dict(bn=128, gsz_sem=16, gsz_geo=16, lr_rank=128, lr_geo=128,
          res_rank=128, topk_gsz=8)
SMALL = dict(hier_bn=128, gsz_geo=16, chunk=512, seed=0)
GPT = 8  # groups per tile of both families at bn=128, gsz=16
B = 256


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
    jb = JaxGeoBank.synthetic_informative(5, 3000, key_dim=256, value_dim=128,
                                          pad_to=512, value_dtype=jnp.bfloat16)
    return {"bf16": jb, "int8": jax_quantize(jb)}


@pytest.fixture(scope="module")
def jhbs(jbanks):
    return {k: jh.build_hier_bank(b, **KW) for k, b in jbanks.items()}


@pytest.fixture(scope="module")
def archives(jhbs, tmp_path_factory):
    out = {}
    for k, hb in jhbs.items():
        out[k] = str(tmp_path_factory.mktemp("hier") / f"jax_{k}.npz")
        jh.save_hier_bank(hb, out[k])
    return out


@pytest.fixture(scope="module")
def thbs(archives):
    return {k: th.load_hier_bank(p, device="cpu") for k, p in archives.items()}


@pytest.fixture(scope="module")
def packed(jhbs):
    """B random unit queries and locations, packed with the locations
    (both families live) and geo-sorted as JAX does, JAX's scan stats and
    the tiles a merged-path selection keeps (K = 8 of 24 per block of
    128)."""
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
    idx, _ = jh.select_tiles(*stats, t_real=24, k_tiles=8, bm=128, n_valid=B,
                             j_sem=3, j_geo=2, mode="range+")
    return dict(q=q, q_cat=q_cat, idx=idx)


# ---------------------------------------------------------------- build


def test_int8_build_keeps_codes_and_scales(jhbs, thbs, jbanks):
    """JAX's int8 HierBank, loaded from its archive: int8 codes and f32
    scales bit-equal, the scales permuted with their rows (the clustered
    bank's rows reconstruct the source bank's dequantized rows)."""
    j8, t8 = jhbs["int8"], thbs["int8"]
    assert t8.values.dtype == torch.int8 and t8.value_scale.dtype == torch.float32
    np.testing.assert_array_equal(t8.values.numpy(), np.asarray(j8.values))
    np.testing.assert_array_equal(t8.value_scale.numpy(),
                                  np.asarray(j8.value_scale))
    assert t8.bank.value_scale is not None
    np.testing.assert_array_equal(t8.bank.value_scale.numpy(),
                                  np.asarray(j8.bank.value_scale))
    # each clustered row (matched to its source row by location) holds the
    # source row's codes: its reconstruction is within 0.51 scale
    src = jbanks["bf16"]
    sl = np.asarray(src.locs_lonlat, np.float32)[:3000]
    so = np.lexsort((sl[:, 1], sl[:, 0]))
    valid = t8.bank.row_mask().bool()
    cl = t8.bank.locs_lonlat[valid].numpy()
    co = np.lexsort((cl[:, 1], cl[:, 0]))
    np.testing.assert_array_equal(cl[co], sl[so])
    deq = dequantize_values(t8.bank)[valid][co]
    ref = torch.from_numpy(_np(src.values)[:3000][so])
    scale = t8.bank.value_scale[0][valid][co]
    assert ((deq - ref).abs() <= 0.51 * scale[:, None]).all()


@pytest.fixture(scope="module")
def injected8(jhbs):
    """The port's operands of JAX's int8 clustered bank (JAX's row order)."""
    cb = jhbs["int8"].bank
    tcb = geobank_from_arrays(cb.locs_lonlat, cb.xyz, cb.keys_sem, cb.values,
                              cb.n_valid, cb.valid_mask, cb.value_scale)
    return th.pack_hier_bank(tcb, **KW)


# the same f32 group sums of the same dequantized rows, then the same bf16
# rounding; one bf16 ulp where a 16-term f32 sum lands on a tie
@pytest.mark.parametrize("name,atol", [
    ("values", 0), ("value_scale", 0), ("k_cat", 0), ("g_sem_vw", 2 ** -4),
    ("g_geo_vw", 2 ** -4), ("g_sem_cat", 2 ** -9)])
def test_int8_build_operands_match_jax(jhbs, injected8, name, atol):
    a, b = _np(getattr(jhbs["int8"], name)), getattr(injected8, name).float().numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_int8_lowrank_operands_match_jax(jhbs, injected8):
    """Eigenvector signs are arbitrary: compare coef @ u (the coefficients
    are bf16, summed over 128 basis vectors) and the count column."""
    j8 = jhbs["int8"]
    for coef, basis in (("g_sem_vw_lr", "u_sem"), ("z_sem", "w_sem")):
        ja, jb_ = _np(getattr(j8, coef)), _np(getattr(j8, basis))
        ta = getattr(injected8, coef).float().numpy()
        tb = getattr(injected8, basis).numpy()
        ref = ja[:, :128] @ jb_[:128]
        np.testing.assert_allclose(ta[:, :128] @ tb[:128], ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max())
    np.testing.assert_array_equal(injected8.g_sem_vw_lr[:, 128].float().numpy(),
                                  _np(j8.g_sem_vw_lr)[:, 128])


def test_int8_archive_round_trip_and_cache(thbs, jbanks, tmp_path):
    """The port's save -> load keeps the int8 codes and scales bit-equal;
    a cache built from bf16 values is stale for an int8 request (the JAX
    signature does not record the value dtype) and is rebuilt."""
    t8 = thbs["int8"]
    path = str(tmp_path / "port8.npz")
    th.save_hier_bank(t8, path)
    back = th.load_hier_bank(path, device="cpu")
    for a, b in ((t8.values, back.values), (t8.value_scale, back.value_scale),
                 (t8.bank.values, back.bank.values),
                 (t8.bank.value_scale, back.bank.value_scale)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    jb = jbanks["bf16"]
    small = geobank_from_arrays(jb.locs_lonlat[:1024], jb.xyz[:1024],
                                jb.keys_sem[:1024], jb.values[:1024], 1024)
    kw = dict(bn=128, gsz_sem=16, gsz_geo=16, lr_rank=64)
    cache = str(tmp_path / "cache.npz")
    hb = th.prepare_hier_bank(small, cache_path=cache, **kw)
    assert hb.value_scale is None
    hb8 = th.prepare_hier_bank(quantize_values(small), cache_path=cache, **kw)
    assert hb8.value_scale is not None and hb8.values.dtype == torch.int8
    again = th.prepare_hier_bank(quantize_values(small), cache_path=cache, **kw)
    assert torch.equal(again.values, hb8.values)  # a hit


# ---------------------------------------------------------------- kernels


def test_scan_without_geo_matches_jax(packed, jhbs, thbs):
    """`has_geo=False` (RANGE mode): what that mode reads, m_s, s_s and the
    sem tail, against JAX's scan (which still fills the geo half)."""
    jhb, thb = jhbs["bf16"], thbs["bf16"]
    q_cat = packed["q_cat"]
    ref = jh._hier_scan_call(q_cat, jhb.g_sem_cat, jhb.g_geo_cat,
                             jhb.g_sem_vw_lr, jhb.g_geo_vw, bm=128, tc=4,
                             gpt_s=GPT, gpt_g=GPT, has_geo=False,
                             interpret=True)
    args = (_t(q_cat), thb.g_sem_cat, thb.g_geo_cat, thb.g_sem_vw_lr,
            thb.g_geo_vw)
    got = th._hier_scan_plain(*args, gpt_s=GPT, gpt_g=GPT, has_geo=False)
    assert got[2] is None and got[3] is None and got[4].shape == (B, 256)
    np.testing.assert_allclose(got[0].numpy(), _np(ref[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), _np(ref[1]), rtol=1e-4, atol=0)
    mag = th._hier_scan_plain(_t(q_cat), thb.g_sem_cat, thb.g_geo_cat,
                              thb.g_sem_vw_lr.abs(), thb.g_geo_vw,
                              gpt_s=GPT, gpt_g=GPT, has_geo=False)[4]
    _within_terms(got[4].numpy(), _np(ref[4])[:, :256], mag.numpy())
    full = th._hier_scan_call(*args[:4], thb.g_geo_vw_lr, gpt_s=GPT, gpt_g=GPT)
    for a, b in zip(got[:2], full[:2]):  # the sem stats do not depend on geo
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_parts(packed, jhbs):
    out = {}
    for k, jhb in jhbs.items():
        out[k] = _np(jh._hier_parts_call(
            packed["q_cat"], jhb.k_cat, jhb.values, jhb.value_scale,
            jhb.mask_neg, packed["idx"], jhb.g_sem_cat, jhb.g_geo_cat,
            jhb.g_sem_vw_lr, jhb.g_geo_vw, sem_d=256, bm=128, bn=128,
            gpt_s=GPT, gpt_g=GPT, lr=True, interpret=True))
    return out


# Columns of the merged parts output (Dv = 128, Ws = 256).
ACC_S, ACC_G, D_S, D_G, ALR = (slice(0, 128), slice(128, 256), slice(256, 257),
                               slice(257, 258), slice(384, 640))


@pytest.mark.parametrize("geo", [True, False], ids=["geo", "no_geo"])
@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_parts_plain_matches_jax(packed, thbs, jax_parts, quant, geo):
    """`_hier_parts_plain` (lr variant, with and without the int8 scale)
    against JAX's `_hier_parts_call(lr=True)` on the same idx: every column
    with the geo family, the columns RANGE reads without it (the geo ones
    then zero).  Tolerance `_within_terms`, each segment at its own scale."""
    thb, ref = thbs[quant], jax_parts[quant]
    args = (_t(packed["q_cat"]), thb.k_cat, thb.values, thb.value_scale,
            thb.mask_neg, _t(packed["idx"]).to(torch.int32), thb.g_sem_cat,
            thb.g_geo_cat, thb.g_sem_vw_lr, thb.g_geo_vw)
    kw = dict(sem_d=256, bm=128, bn=128, gpt_s=GPT, gpt_g=GPT, geo=geo)
    before = th._hier_parts_call.launches
    got = th._hier_parts_call(*args, **kw).numpy()
    assert th._hier_parts_call.launches == before  # the plain version on the CPU
    mag = th._hier_parts_plain(*args, **kw, magnitude=True).numpy()
    assert got.shape == ref.shape == (B, 640)
    assert not got[:, 258:384].any()
    segs = (ACC_S, D_S, ALR) + ((ACC_G, D_G) if geo else ())
    for cols in segs:
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols])
    if not geo:
        assert not got[:, ACC_G].any() and not got[:, D_G].any()


def test_parts_telescoping(packed, thbs):
    """The lr variant puts the sem approximation in alr only, and always
    subtracts the geo approximation: acc_s and d_s are the exact sums over
    the selected rows, acc_g and d_g the exact sums minus the geo group
    approximation (computed here with the groups' own formula)."""
    thb = thbs["bf16"]
    q_cat, idx = _t(packed["q_cat"]), _t(packed["idx"]).to(torch.int32)
    args = (q_cat, thb.k_cat, thb.values, None, thb.mask_neg, idx,
            thb.g_sem_cat, thb.g_geo_cat, thb.g_sem_vw_lr, thb.g_geo_vw)
    kw = dict(sem_d=256, bm=128, bn=128, gpt_s=GPT, gpt_g=GPT)
    out = th._hier_parts_plain(*args, **kw)
    rows = (idx[0].long()[:, None] * 128 + torch.arange(128)).reshape(-1)
    q = q_cat[:128].float()
    k, v = thb.k_cat[rows].float(), thb.values[rows].float()
    m = thb.mask_neg[0, rows]
    p_s = torch.exp2(torch.clamp_max(q[:, :256] @ k[:, :256].T + m, 86.0))
    torch.testing.assert_close(out[:128, D_S], p_s.sum(1, keepdim=True))
    torch.testing.assert_close(out[:128, ACC_S],
                               p_s.bfloat16().float() @ v)
    p_g = torch.exp2(torch.clamp_max(q[:, 256:] @ k[:, 256:].T + m, 86.0))
    grps = (idx[0].long()[:, None] * GPT + torch.arange(GPT)).reshape(-1)
    e = torch.exp2(torch.clamp_max(q[:, 256:] @ thb.g_geo_cat[grps].float().T,
                                   86.0))
    appr = e.bfloat16().float() @ thb.g_geo_vw[grps].float()
    torch.testing.assert_close(out[:128, D_G],
                               p_g.sum(1, keepdim=True) - appr[:, 128:129])
    torch.testing.assert_close(out[:128, ACC_G],
                               p_g.bfloat16().float() @ v - appr[:, :128])


def test_parts_lr_false_raises(packed, thbs):
    """lr=False (the full-width sem group sums) is served now: [B, 2 Dv +
    128], no alr columns, and acc_s / d_s hold the exact sums minus the
    sem group approximation, as acc_g / d_g hold the geo one (the name is
    kept from when the variant raised)."""
    thb = thbs["bf16"]
    args = (_t(packed["q_cat"]), thb.k_cat, thb.values, None, thb.mask_neg,
            _t(packed["idx"]).to(torch.int32), thb.g_sem_cat, thb.g_geo_cat)
    kw = dict(sem_d=256, bm=128, bn=128, gpt_s=GPT, gpt_g=GPT)
    plain = th._hier_parts_call(*args, thb.g_sem_vw, thb.g_geo_vw, lr=False,
                                **kw)
    lr = th._hier_parts_call(*args, thb.g_sem_vw_lr, thb.g_geo_vw, **kw)
    assert plain.shape == (B, 2 * 128 + 128)
    torch.testing.assert_close(plain[:, ACC_G], lr[:, ACC_G])
    torch.testing.assert_close(plain[:, D_G], lr[:, D_G])
    idx = _t(packed["idx"]).to(torch.int32)
    grps = (idx[0].long()[:, None] * GPT + torch.arange(GPT)).reshape(-1)
    q = _t(packed["q_cat"])[:128].float()
    e = torch.exp2(torch.clamp_max(q[:, :256] @ thb.g_sem_cat[grps].float().T,
                                   86.0))
    appr = e.bfloat16().float() @ thb.g_sem_vw[grps].float()
    torch.testing.assert_close(plain[:128, ACC_S], lr[:128, ACC_S] - appr[:, :128])
    torch.testing.assert_close(plain[:128, D_S], lr[:128, D_S] - appr[:, 128:129])


# ---------------------------------------------------------------- serving


def _range_queries(seed, n=B):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 256))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_retrieve_hier_range_matches_jax(jhbs, thbs, quant):
    """`retrieve_hier(mode="range")` (home-tile sort, geo-less scan, merged
    parts, low-rank combine) against JAX's on the same bank.  The port
    sorts by its own home tiles; the order is checked equal to JAX's, so
    a near-tie there would show as that failure, not as a value error.
    Tolerance: the scan tail and parts within one bf16 ulp of a term
    (above), through the unprojection and the normalization; 2e-4 on
    outputs ~0.1-1."""
    jhb, thb = jhbs[quant], thbs[quant]
    q = _range_queries(seed=1)
    kw = dict(sem_temp=15.0, mode="range", k_tiles=8, bm=128, j_sem=3)
    j = _np(jh.retrieve_hier(jnp.asarray(q), None, jhb, interpret=True, **kw))
    t = th.retrieve_hier(torch.from_numpy(q), None, thb, concat_query=torch.ones(B, 2),
                         **kw)
    assert t.shape == (B, 130) and torch.equal(t[:, 128:], torch.ones(B, 2))
    q_cat = jax_pack_queries(jnp.asarray(q), None, 15.0, 40.0, tier="fast")
    m_s = jh._hier_scan_stats_call(q_cat, jhb.g_sem_cat, jhb.g_geo_cat, bm=128,
                                   tc=4, gpt_s=GPT, gpt_g=GPT, interpret=True)[0]
    j_home = np.asarray(jh._home_tile(m_s, 24))
    t_home = th._home_tile(th._hier_scan_stats_call(
        _t(q_cat), thb.g_sem_cat, thb.g_geo_cat, gpt_s=GPT, gpt_g=GPT)[0], 24)
    np.testing.assert_array_equal(t_home.numpy(), j_home)
    np.testing.assert_allclose(t[:, :128].numpy(), j, rtol=0, atol=2e-4)


def test_range_all_tiles_is_exact(thbs):
    """With every real tile selected, corr = tails - alr cancels the whole
    sem approximation, so RANGE hier is the exact dense softmax up to the
    bf16 weights of the value product (one bf16 rounding, 2^-9 relative,
    averaged over the softmax): a sem approximation subtracted twice or
    not at all would be off by the approximation itself."""
    thb = thbs["bf16"]
    q = torch.from_numpy(_range_queries(seed=2, n=128))
    got = th.retrieve_hier(q, None, thb, sem_temp=15.0, mode="range",
                           k_tiles=24, bm=128)
    ref = retrieval.retrieve(q, None, thb.bank, sem_temp=15.0, mode="range")
    torch.testing.assert_close(got, ref, rtol=0, atol=4e-3 * ref.abs().max())


def test_load_model_range_flagship_matches_jax(jbanks, tmp_path):
    """`load_model("RANGE", profile="flagship")`: JAX builds the HierBank
    into its hier cache, the port loads it (equal signatures) and serves
    with the same tower weights (f32 tower, as tests/test_torch_hier_api.py
    holds the RANGE+ flagship).  k_tiles cut to 4 of 24 tiles (widened 3x
    at B = 256 on both sides).  Tolerance as the RANGE+ flagship's: 2e-4."""
    jb = jbanks["bf16"]
    cache = str(tmp_path / "hb.npz")
    kw = dict(profile="flagship", k_tiles=4, hier_cache=cache, tower_matmul=None,
              **SMALL)
    jenc = range_tpu.load_model("RANGE", db_path=jb, **kw)
    bank = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values,
                               jb.n_valid)
    enc = load_model("RANGE", db_path=bank, device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    hb = enc.model.bank
    assert isinstance(hb, th.HierBank) and hb.t_real == 24
    assert enc.model.config.mode == "range" and enc.model.config.resolved_sem_temp() == 15.0
    rng = np.random.default_rng(3)
    qi = np.repeat(rng.integers(0, 2000, 8), B // 8)
    coords = np.asarray(jb.locs_lonlat)[qi] + rng.normal(0, 3.0, (B, 2))
    coords[:, 1] = np.clip(coords[:, 1], -89.9, 89.9)
    coords = coords.astype(np.float32)
    j = np.asarray(jenc(jnp.asarray(coords)))
    t = enc(coords)
    assert t.shape == j.shape == (B, 384)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-4)


def test_port_build_range_within_bar():
    """The port's own build of its own 6,000-row informative bank, served
    by `load_model("RANGE", profile="flagship")` with k_tiles = 8 (24 of
    47 tiles at B = 512), against the exact f32 retrieve(mode="range") over
    the same rows: relerr (denominator max(|ref|, 0.1)) mean < 0.10, the
    bar of `tests/test_hier.py:128-135` (global queries near bank rows, as
    its `_make_queries(regional=False)`)."""
    bank = GeoBank.synthetic_informative(0, 6000, value_dim=128, pad_to=512,
                                         value_dtype=torch.bfloat16, device="cpu")
    enc = load_model("RANGE", db_path=bank, device="cpu", profile="flagship",
                     k_tiles=8, **SMALL)
    hb = enc.model.bank
    assert hb.t_real == 47 and enc.model.config.hier_plan(512)[1] == 24
    rng = np.random.default_rng(0)
    c = bank.locs_lonlat.numpy()[rng.integers(0, 6000, 512)]
    c = c + rng.normal(0, 0.5, (512, 2))
    c[:, 0] = (c[:, 0] + 180) % 360 - 180
    c[:, 1] = np.clip(c[:, 1], -89.9, 89.9)
    out = enc(c.astype(np.float32))
    ref = retrieval.retrieve(out[:, 128:], None, hb.bank, sem_temp=15.0,
                             mode="range")
    rel = (out[:, :128] - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.mean() < 0.10


@pytest.mark.parametrize("name", ["RANGE", "RANGE+"])
def test_int8_flagship_close_to_bf16(thbs, name):
    """The flagship profile over the int8 HierBank against the same bank's
    bf16 HierBank: relerr mean < 0.01 (`tests/test_hier.py:139-149`).
    RANGE runs the merged kernel with the scale folded in; RANGE+ the
    family-split kernels, which read no values."""
    encs = [load_model(name, db_path=thbs[k], device="cpu", profile="flagship",
                       value_quant="int8" if k == "int8" else None, **SMALL)
            for k in ("bf16", "int8")]
    rng = np.random.default_rng(4)
    coords = np.stack([rng.uniform(-180, 180, B), rng.uniform(-80, 80, B)],
                      1).astype(np.float32)
    a, b = (e(coords)[:, :128] for e in encs)
    rel = (b - a).abs() / a.abs().clamp_min(0.1)
    assert rel.mean() < 0.01


def test_range_servability_contract(thbs):
    """RANGE mode serves banks with or without the low-rank sem tail (the
    merged kernel's lr and plain variants), and RANGE+ serves banks
    without the flagship's res_rank / lr_geo; an unknown mode raises."""
    thb = thbs["bf16"]
    q = torch.from_numpy(_range_queries(seed=5, n=8))
    no_lr = dataclasses.replace(thb, lr_rank=0, g_sem_vw_lr=None)
    out = th.retrieve_hier(q, None, no_lr, mode="range", bm=128)
    assert out.shape == (8, 128) and torch.isfinite(out).all()
    slim = dataclasses.replace(thb, res_rank=0, z_sem=None, lr_geo=0,
                               g_geo_vw_lr=None)
    assert th.retrieve_hier(q, None, slim, mode="range", bm=128).shape == (8, 128)
    out = th.retrieve_hier(q, lonlat_deg_to_xyz(torch.zeros(8, 2)), slim, bm=128)
    assert out.shape == (8, 128) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="mode"):
        th.retrieve_hier(q, None, thb, mode="dense")
