"""The hierarchical build and serving modules of range_tpu_torch, each
against its range_tpu counterpart on the CPU.

Sizes follow `tests/test_hier.py`: an informative bank of 3,000 rows with
256-d keys and bf16 128-d values (Dv = 128, so the 128-aligned fused
combine applies), bn = 128, gsz_sem = gsz_geo = 16, topk_gsz = 8 and
lr_rank = lr_geo = res_rank = 128 (full rank at Dv = 128).  JAX's Pallas
kernels run in interpret mode.  Operands cross as numpy arrays or through
the shared HierBank archive.  Inputs are float32 (conftest enables x64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank import clustered as jcl
from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.data.checkerboard import fibonacci_lattice as jax_fib
from range_tpu.geometry import geo_sort_order as jax_geo_sort
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import kmeans as jkm
from range_tpu.ops import retrieval_hier as jh
from range_tpu.ops.retrieval_pallas import pack_queries as jax_pack_queries
from range_tpu_torch.bank import clustered as tcl
from range_tpu_torch.convert.from_jax import _tensor, geobank_from_arrays
from range_tpu_torch.data.checkerboard import fibonacci_lattice
from range_tpu_torch.geometry import geo_sort_order
from range_tpu_torch.ops import kmeans as tkm
from range_tpu_torch.ops import retrieval_hier as th

KW = dict(bn=128, gsz_sem=16, gsz_geo=16, lr_rank=128, lr_geo=128,
          res_rank=128, topk_gsz=8)
GPT = 8  # groups per tile of both families at bn=128, gsz=16
B = 256


def _np(x):
    return np.asarray(x).astype(np.float32)


def _t(x):
    return _tensor(np.asarray(x))


def _within_terms(got, ref, mag, frac=4e-3):
    """|got - ref| <= min(frac * the row's max |ref|, 2^-7 * mag) + 1e-6,
    elementwise, with mag the sum of the element's terms' magnitudes.
    The logits agree to f32 summation order, so a bf16-rounded weight can
    land one ulp (<= 2^-7 of itself) the other way: summed over every term,
    that bounds each element by its own terms, which holds the small
    low-rank columns as tightly as their own size.  The row-scale cap
    (one ulp of the row's largest value) keeps the bound no looser than a
    row-scaled one where terms cancel."""
    err = np.abs(got - ref)
    tol = np.minimum(frac * np.abs(ref).max(axis=1, keepdims=True),
                     2.0 ** -7 * mag) + 1e-6
    assert (err <= tol).all(), float((err / tol).max())


@pytest.fixture(scope="module")
def jbank():
    return JaxGeoBank.synthetic_informative(5, 3000, key_dim=256, value_dim=128,
                                            pad_to=512, value_dtype=jnp.bfloat16)


@pytest.fixture(scope="module")
def tbank(jbank):
    return geobank_from_arrays(jbank.locs_lonlat, jbank.xyz, jbank.keys_sem,
                               jbank.values, jbank.n_valid)


@pytest.fixture(scope="module")
def jhb(jbank):
    return jh.build_hier_bank(jbank, **KW)


@pytest.fixture(scope="module")
def archive(jhb, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hier") / "jax_hb.npz")
    jh.save_hier_bank(jhb, path)
    return path


@pytest.fixture(scope="module")
def thb(archive):
    return th.load_hier_bank(archive, device="cpu")


@pytest.fixture(scope="module")
def packed(jhb):
    """Packed, geo-sorted queries of B random locations (both packages'
    layout) with JAX's order and scan outputs."""
    rng = np.random.default_rng(0)
    ll = np.stack([rng.uniform(-180, 180, B),
                   np.degrees(np.arcsin(rng.uniform(-1, 1, B)))], 1)
    q = rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = jax_xyz(jnp.asarray(ll, jnp.float32))
    q_cat = jax_pack_queries(jnp.asarray(q), x, 12.0, 40.0, tier="fast")
    order = jh._hybrid_order(x, jnp.zeros(B, jnp.int32), B, jhb.t_pad,
                             sort="geo")
    q_cat = q_cat[order]
    scan = jh._hier_scan_call(q_cat, jhb.g_sem_cat, jhb.g_geo_cat,
                              jhb.g_sem_vw_lr, jhb.g_geo_vw_lr, bm=128, tc=4,
                              gpt_s=GPT, gpt_g=GPT, interpret=True)
    return dict(q=q, x=x, q_cat=q_cat, order=order, scan=scan)


# ---------------------------------------------------------------- build


@pytest.mark.parametrize("n", [390, 391, 8])
def test_fibonacci_lattice_equals_jax(n):
    for a, b in zip(fibonacci_lattice(n), jax_fib(n)):
        np.testing.assert_array_equal(a, b)


def test_geo_sort_order_equals_jax():
    rng = np.random.default_rng(1)
    v = rng.standard_normal((2000, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    np.testing.assert_array_equal(geo_sort_order(torch.from_numpy(v)).numpy(),
                                  np.asarray(jax_geo_sort(jnp.asarray(v))))


@pytest.mark.parametrize("chunked", [False, True])
def test_kmeans_matches_jax(monkeypatch, chunked):
    """Same seed points, same Lloyd steps: the assignments agree up to f32
    near-ties of the argmax (the two frameworks sum the matmuls in other
    orders), so at least 99.5% of rows agree; here all do.  ``chunked``
    forces the row-chunked branch, which the JAX function takes only
    above N*C = 2^28 and which gives the one-shot assignments."""
    rng = np.random.default_rng(2)
    pts = rng.standard_normal((3000, 3)).astype(np.float32)
    valid = (rng.uniform(size=3000) > 0.1).astype(np.float32)
    init = pts[::60][:50]
    _, ja = jkm.kmeans(jax.random.PRNGKey(0), jnp.asarray(pts), 50, iters=8,
                       valid=jnp.asarray(valid), init_points=jnp.asarray(init))
    if chunked:
        monkeypatch.setattr(tkm, "ONE_SHOT_MAX", 1000)
    _, ta = tkm.kmeans(torch.from_numpy(pts), 50, iters=8,
                       valid=torch.from_numpy(valid),
                       init_points=torch.from_numpy(init))
    assert (ta.numpy() == np.asarray(ja)).mean() >= 0.995


def test_kmeans_needs_seed_points():
    with pytest.raises(NotImplementedError, match="init_points"):
        tkm.kmeans(torch.zeros(10, 3), 2)


def test_geo_pack_order_equals_jax(jbank, tbank):
    """The dense cluster-packed row order (n_clusters from the row count,
    Fibonacci seeds, latitude-band relabeling) is the JAX package's."""
    j = jcl.geo_pack_order(jbank.xyz, jbank.row_mask(), 128, pack="dense")
    t = tcl.geo_pack_order(tbank.xyz, tbank.row_mask(), 128)
    np.testing.assert_array_equal(t, j)


def test_order_rows_within_tiles_equals_jax(jhb):
    """Per-tile key+value k-means order on the clustered bank's features."""
    cb = jhb.bank
    vf = cb.values.astype(jnp.float32)
    vn = vf / jnp.maximum(jnp.linalg.norm(vf, axis=1, keepdims=True), 1e-9)
    feats = jnp.concatenate([cb.keys_sem.astype(jnp.float32), vn], axis=1)
    j = jh._order_rows_within_tiles(feats, cb.row_mask(), 128, 8, 1)
    t = th._order_rows_within_tiles(torch.from_numpy(_np(feats)),
                                    _t(cb.row_mask()), 128, 8)
    np.testing.assert_array_equal(t, j)


def test_build_row_order_equals_jax(jhb, tbank):
    """The port's whole build orders the rows as JAX's (k-means near-ties
    could move a few; none do on this bank)."""
    hb = th.build_hier_bank(tbank, **KW)
    same = (hb.bank.locs_lonlat.numpy() == _np(jhb.bank.locs_lonlat)).all(1)
    assert same.mean() == 1.0
    assert (hb.t_real, hb.t_pad, hb.sem_d, hb.cat_d) == (24, 32, 256, 384)


@pytest.fixture(scope="module")
def injected(jhb):
    """The port's operands of JAX's clustered bank (JAX's row order)."""
    cb = jhb.bank
    tcb = geobank_from_arrays(cb.locs_lonlat, cb.xyz, cb.keys_sem, cb.values,
                              cb.n_valid, cb.valid_mask)
    return th.pack_hier_bank(tcb, **KW)


# exact: the same f32 group sums of the same rows, then the same bf16
# rounding; one bf16 ulp where a 16-term f32 sum lands on a tie
@pytest.mark.parametrize("name,atol", [
    ("k_cat", 0), ("mask_neg", 0), ("khl_sem", 0), ("g_sem_cat", 2 ** -9),
    ("g_geo_cat", 2 ** -9), ("g_sem_vw", 2 ** -4), ("g_geo_vw", 2 ** -4),
    ("g_topk_cat", 2 ** -9), ("sem_centroid", 1e-6), ("geo_centroid", 1e-6),
    ("sem_radius", 1e-5), ("geo_radius", 1e-5)])
def test_build_operands_match_jax(jhb, injected, name, atol):
    a, b = _np(getattr(jhb, name)), getattr(injected, name).float().numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=atol)


@pytest.mark.parametrize("coef,basis,rank", [
    ("g_sem_vw_lr", "u_sem", "lr_rank"), ("g_geo_vw_lr", "u_geo", "lr_geo"),
    ("z_sem", "w_sem", None), ("z_geo", "w_geo", None)])
def test_eigen_operands_match_jax_sign_invariantly(jhb, injected, coef, basis,
                                                   rank):
    """Eigenvector signs are arbitrary per column, so compare what serving
    uses: the reconstruction coef @ basis, the projector basis^T basis, and
    the count column.  Tolerance: the coefficients are stored bf16
    (2^-8 relative each) and summed over 128 basis vectors."""
    r = getattr(jhb, rank) if rank else _np(getattr(jhb, basis)).shape[0]
    ja, jb = _np(getattr(jhb, coef)), _np(getattr(jhb, basis))
    ta = getattr(injected, coef).float().numpy()
    tb = getattr(injected, basis).numpy()
    assert ta.shape == ja.shape and tb.shape == jb.shape
    ref = ja[:, :r] @ jb[:r]
    np.testing.assert_allclose(ta[:, :r] @ tb[:r], ref, rtol=0,
                               atol=2e-3 * np.abs(ref).max())
    np.testing.assert_allclose(tb.T @ tb, jb.T @ jb, rtol=0, atol=1e-4)
    if rank:
        np.testing.assert_array_equal(ta[:, r], ja[:, r])


def test_build_rejects_unported_knobs(tbank):
    """topk_lr and sel_lr build their rank-32 sketches (of the topk_gsz and
    the sem centroids: `tests/test_torch_hier_knobs.py` holds them against
    JAX's); the two-level knobs' nesting rules raise ValueError before any
    clustering (`retrieval_hier.py:366-401`: gsz_super beside topk_gsz,
    windows that do not nest, sel_lr beside tail_super)."""
    hb = th.build_hier_bank(tbank, **{**KW, "topk_lr": 32, "sel_lr": 32})
    assert hb.topk_lr == hb.sel_lr == 32
    assert hb.p_topk.shape == hb.p_sel.shape == (32, 256)
    assert hb.g_topk_lr.shape == (hb.g_topk_cat.shape[0], 32)
    assert hb.g_sem_sel.shape == (hb.g_sem_cat.shape[0], 32)
    for bad, match in ((dict(gsz_super=16), "mutually exclusive"),
                       (dict(topk_gsz=0, gsz_super=24), "gsz_super"),
                       (dict(tail_super=16), "tail_super"),
                       (dict(tail_super=24), "tail_super"),
                       (dict(tail_super=32, sel_lr=32), "mutually exclusive")):
        with pytest.raises(ValueError, match=match):
            th.build_hier_bank(tbank, **{**KW, **bad})
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        th.build_hier_bank(tbank, shards=2, **KW)


# ---------------------------------------------------------------- archive


def test_jax_archive_loads_with_every_field_equal(jhb, thb):
    for f in dataclasses.fields(jh.HierBank):
        a, b = getattr(jhb, f.name), getattr(thb, f.name)
        if f.name == "bank":
            for g in ("locs_lonlat", "xyz", "keys_sem", "values", "valid_mask"):
                np.testing.assert_array_equal(getattr(b, g).float().numpy(),
                                              _np(getattr(a, g)))
            assert b.n_valid == int(a.n_valid)
        elif a is None or isinstance(a, (int, str)):
            assert a == b, f.name
        else:
            assert b.dtype == (torch.bfloat16 if a.dtype == jnp.bfloat16
                               else _t(a).dtype), f.name
            np.testing.assert_array_equal(b.float().numpy(), _np(a))


def test_port_save_load_is_identity(thb, tmp_path):
    path = str(tmp_path / "port.npz")
    th.save_hier_bank(thb, path, build={"fp": "x"})
    back = th.load_hier_bank(path, device="cpu")
    assert th.peek_hier_build(path) == {"fp": "x"}
    for f in th._ARRAY_FIELDS:
        a, b = getattr(thb, f), getattr(back, f)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b)
    for f in th._META_FIELDS:
        assert getattr(thb, f) == getattr(back, f)
    assert torch.equal(back.bank.values, thb.bank.values)


def test_cache_signature_equals_jax_and_stale_rebuilds(jbank, tbank,
                                                       tmp_path):
    sig_kw = dict(bn=128, gsz_sem=16, gsz_geo=16, tier="fast", seed=0,
                  shards=1, lr_rank=128, lr_geo=128, res_rank=128,
                  topk_gsz=8)
    assert th.hier_build_signature(tbank, **sig_kw) == \
        jh.hier_build_signature(jbank, **sig_kw)
    path = str(tmp_path / "cache.npz")
    hb = th.prepare_hier_bank(tbank, cache_path=path, **KW)
    again = th.prepare_hier_bank(tbank, cache_path=path, **KW)  # a hit
    assert torch.equal(again.k_cat, hb.k_cat)
    other = th.prepare_hier_bank(tbank, cache_path=path,
                                 **{**KW, "gsz_sem": 8})  # stale: rebuilt
    assert other.gsz_sem == 8 and th.peek_hier_build(path)["gsz_sem"] == 8


# ---------------------------------------------------------------- serving


def test_hybrid_order_equals_jax(packed):
    Bp = 384
    x = np.pad(np.asarray(packed["x"], np.float32), ((0, Bp - B), (0, 0)))
    j = jh._hybrid_order(jnp.asarray(x), jnp.zeros(Bp, jnp.int32), B, 32,
                         sort="geo")
    np.testing.assert_array_equal(th._hybrid_order(torch.from_numpy(x), B),
                                  np.asarray(j))


def _select_both(stats, **kw):
    j = jh.select_tiles(*[jnp.asarray(s) for s in stats], **kw)
    t = th.select_tiles(*[torch.from_numpy(s) for s in stats], **kw)
    return np.asarray(j[0]), t[0].numpy()


@pytest.mark.parametrize("mode", ["range", "range+"])
def test_select_tiles_equals_jax(packed, mode):
    stats = [_np(s) for s in packed["scan"][:4]]
    kw = dict(t_real=24, k_tiles=8, bm=128, n_valid=B - 3, j_sem=3,
              j_geo=2, mode=mode)
    ji, ti = _select_both(stats, **kw)
    np.testing.assert_array_equal(ti, ji)


def test_select_tiles_ties_break_by_lower_index():
    """Deliberate ties: repeated tile columns (equal sel and pri), and
    one-sided rank levels whose pri differences vanish in sel * 1e9 + pri's
    f32 rounding."""
    rng = np.random.default_rng(3)
    base = rng.normal(0, 3, (256, 4)).astype(np.float32)
    m = np.tile(base, (1, 10))  # 40 tiles, every value repeated 10 times
    s = np.exp2(np.clip(m, None, 20)).astype(np.float32)
    m[:, 5] += 0.25  # a rank winner whose mass ties its copies after rounding
    stats = [m, s, m[:, ::-1].copy(), s[:, ::-1].copy()]
    for mode in ("range", "range+"):
        ji, ti = _select_both(stats, t_real=37, k_tiles=12, bm=128,
                                    n_valid=256, j_sem=2, j_geo=2, mode=mode)
        np.testing.assert_array_equal(ti, ji)


# the plain versions against JAX interpret mode on the same operands: the
# logits are f32 sums of the same bf16 products in another order (~1e-6
# relative), so a bf16-rounded exp (the tail and parts value products)
# can round the other way: one bf16 ulp of one term (`_within_terms`),
# each family and each output segment held to its own scale
def test_scan_plain_matches_jax(packed, jhb, thb):
    got = th._hier_scan_plain(_t(packed["q_cat"]), thb.g_sem_cat,
                              thb.g_geo_cat, thb.g_sem_vw_lr,
                              thb.g_geo_vw_lr, gpt_s=GPT, gpt_g=GPT)
    for name, a, b in zip(("m_s", "s_s", "m_g", "s_g", "tails"),
                          packed["scan"], got):
        a, b = _np(a), b.numpy()
        assert b.shape == a.shape, name
        if name.startswith("m"):  # logits |l| < ~20: f32 sums agree to ~1e-6
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
        elif name.startswith("s"):  # f32 sums of f32 exps
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=0, err_msg=name)
        else:
            mag = th._hier_scan_plain(
                _t(packed["q_cat"]), thb.g_sem_cat, thb.g_geo_cat,
                thb.g_sem_vw_lr.abs(), thb.g_geo_vw_lr.abs(), gpt_s=GPT,
                gpt_g=GPT)[4].numpy()
            for cols in (slice(0, 256), slice(256, 512)):  # sem, geo
                _within_terms(b[:, cols], a[:, cols], mag[:, cols])


def _selections(packed):
    m_s, s_s, m_g, s_g, _ = packed["scan"]
    idx_s, _ = jh.select_tiles(m_s, s_s, m_g, s_g, t_real=24, k_tiles=8,
                               bm=128, n_valid=B, j_sem=3, j_geo=2,
                               mode="range")
    idx_g, _ = jh.select_tiles(m_g, s_g, m_s, s_s, t_real=24, k_tiles=4,
                               bm=128, n_valid=B, j_sem=2, j_geo=3,
                               mode="range")
    return idx_s, idx_g


@pytest.fixture(scope="module")
def jax_parts(packed, jhb):
    idx_s, idx_g = _selections(packed)
    out = {}
    for geo, idx, g, vw, z, lrr in (
            (False, idx_s, jhb.g_sem_cat, jhb.g_sem_vw_lr, jhb.z_sem, 128),
            (True, idx_g, jhb.g_geo_cat, jhb.g_geo_vw_lr, jhb.z_geo, 128)):
        out[geo] = (idx, jh._hier_parts_family_call(
            packed["q_cat"], jhb.k_cat, jhb.values, None, jhb.mask_neg, idx, g,
            vw, z, sem_d=256, bm=128, bn=128, gpt=GPT, geo=geo, lr=True, rr=1,
            lrr=lrr, interpret=True))
    return out


@pytest.mark.parametrize("geo", [False, True], ids=["sem", "geo"])
def test_parts_family_plain_matches_jax(packed, thb, jax_parts, geo):
    idx, ref = jax_parts[geo]
    ref = _np(ref)
    args = (_t(packed["q_cat"]), thb.k_cat, thb.mask_neg,
            _t(idx).to(torch.int32), thb.g_geo_cat if geo else thb.g_sem_cat,
            thb.g_geo_vw_lr if geo else thb.g_sem_vw_lr,
            thb.z_geo if geo else thb.z_sem)
    kw = dict(sem_d=256, bm=128, bn=128, gpt=GPT, geo=geo, lrr=128)
    got = th._hier_parts_family_plain(*args, **kw).numpy()
    mag = th._hier_parts_family_plain(*args, **kw, magnitude=True).numpy()
    assert got.shape == ref.shape == (B, 128 + 128 + 256)
    assert not got[:, 128:256].any()
    for cols in (slice(0, 128), slice(256, 512)):  # az, alr
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols])


def test_combine_plain_matches_jax(packed, jhb, thb, jax_parts):
    """f32 unprojection products in another summation order."""
    ps, pg = jax_parts[False][1], jax_parts[True][1]
    tails = packed["scan"][4]
    q = jnp.asarray(np.random.default_rng(4).standard_normal((B, 128)),
                    jnp.float32)
    ck = dict(Ws=256, r=128, rrp=128, Dv=128, beta=0.3, rg=128, Wg=256)
    ref = _np(jh._combine_cat_call(ps, pg, tails, q, jhb.w_sem, jhb.u_sem,
                                   jhb.w_geo, jhb.u_geo, bm=128,
                                   interpret=True, **ck))
    got = th._combine_cat_plain(_t(ps), _t(pg), _t(tails), _t(q), thb.w_sem,
                                thb.u_sem, thb.w_geo, thb.u_geo, **ck).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_wrappers_take_the_plain_version_on_cpu(packed, thb, jax_parts):
    q_cat = _t(packed["q_cat"])
    args = (q_cat, thb.g_sem_cat, thb.g_geo_cat, thb.g_sem_vw_lr,
            thb.g_geo_vw_lr)
    before = th._hier_scan_call.launches
    for a, b in zip(th._hier_scan_call(*args, gpt_s=GPT, gpt_g=GPT),
                    th._hier_scan_plain(*args, gpt_s=GPT, gpt_g=GPT)):
        assert torch.equal(a, b)
    assert th._hier_scan_call.launches == before  # no kernel on the CPU
