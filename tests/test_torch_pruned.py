"""range_tpu_torch's clustered bank, tile plans and pruned / hybrid dense
retrieval against range_tpu's, on the CPU.

The bank is `tests/test_pruned.py`'s: 3,000 spatially clustered rows whose
keys correlate with location (64-d keys, 32-d f32 values), clustered at
bn=128 and served at bm=16.  The JAX bank's fields cross as numpy
(`convert.from_jax.geobank_from_arrays`).  JAX's kernels 6 and 7 run in
interpret mode, which keeps the stored (f32) value dtype, as the port's
plain versions do on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank import clustered as jcl
from range_tpu.bank.bank import GeoBank as JaxGeoBank, quantize_values as jquant
from range_tpu.geometry import geo_sort_order as jsort, lonlat_deg_to_xyz as jxyz
from range_tpu.ops import retrieval_pallas as jrp
from range_tpu_torch.bank import clustered as tcl
from range_tpu_torch.bank.bank import quantize_values
from range_tpu_torch.convert.from_jax import geobank_from_arrays
from range_tpu_torch.ops import retrieval as tr
from range_tpu_torch.ops import retrieval_fused as trf

BN, BM = 128, 16


def _jax_bank(n=3000, n_centers=24, key_dim=64, dv=32, seed=0, pad_to=512):
    """`tests/test_pruned.py:17-31`'s clustered bank."""
    rng = np.random.default_rng(seed)
    centers_lon = rng.uniform(-180, 180, n_centers)
    centers_lat = rng.uniform(-60, 60, n_centers)
    which = rng.integers(0, n_centers, n)
    lons = centers_lon[which] + rng.normal(0, 3, n)
    lats = centers_lat[which] + rng.normal(0, 3, n)
    locs = np.stack([np.clip(lons, -180, 180), np.clip(lats, -90, 90)], 1)
    key_centers = rng.standard_normal((n_centers, key_dim)) * 3
    keys = key_centers[which] + rng.standard_normal((n, key_dim))
    values = rng.standard_normal((n, dv)).astype(np.float32)
    return JaxGeoBank.from_arrays(locs.astype(np.float32), keys.astype(np.float32),
                                  values, pad_to=pad_to)


def _port(jb):
    return geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values,
                               jb.n_valid, jb.valid_mask, jb.value_scale)


def _queries(bank, b, seed):
    """Queries near bank rows (`tests/test_pruned.py:34-45`), as f32 numpy."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, int(bank.n_valid), b)
    locs = np.asarray(bank.locs_lonlat)[pick] + rng.normal(0, 1, (b, 2))
    locs[:, 0] = np.clip(locs[:, 0], -180, 180)
    locs[:, 1] = np.clip(locs[:, 1], -90, 90)
    valid = np.nonzero(np.asarray(bank.row_mask()) > 0)[0]
    q = np.asarray(bank.keys_sem)[valid[pick % len(valid)]] \
        + 0.05 * rng.standard_normal((b, bank.key_dim))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = np.asarray(jxyz(jnp.asarray(locs, jnp.float32)), np.float32)
    return q, x


def _sorted_queries(bank, b, seed):
    """`_queries` in geographic order (`retrieve_pruned`'s own sort), so
    that query tiles are coherent and the plans prune."""
    q, x = _queries(bank, b, seed)
    order = np.asarray(jsort(jnp.asarray(x)))
    return q[order], x[order]


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.fixture(scope="module")
def banks():
    """(JAX clustered bank, its stats, the port's clustered bank, its
    stats), both clustered from the same rows."""
    jb = _jax_bank()
    jcb, jst = jcl.cluster_bank(jb, bn=BN)
    tcb, tst = tcl.cluster_bank(_port(jb), bn=BN)
    return jcb, jst, tcb, tst


@pytest.mark.parametrize("bn", [BN, 512])
def test_geo_pack_order_pad_equals_jax(bn):
    """The 'pad' packing gives JAX's row order exactly: the same k-means,
    relabeling and greedy packing (a tile is padded out before a cluster
    smaller than a tile would straddle it).  This bank's 11 clusters hold
    ~270 rows: more than a 128-row tile (no padding there), less than a
    512-row one (padding)."""
    jb = _jax_bank()
    j = jcl.geo_pack_order(jb.xyz, jb.row_mask(), bn, pack="pad")
    t = tcl.geo_pack_order(_port(jb).xyz, _port(jb).row_mask(), bn, pack="pad")
    np.testing.assert_array_equal(t, j)
    dense = tcl.geo_pack_order(_port(jb).xyz, _port(jb).row_mask(), bn)
    assert (len(t) > len(dense)) == (bn == 512)


def test_cluster_bank_and_tile_stats_match_jax(banks):
    """Reordered rows equal, the scattered validity mask equal; the tile
    stats' centroids and radii within 1e-5 (f32 sums in another order)."""
    jcb, jst, tcb, tst = banks
    for f in ("locs_lonlat", "xyz", "keys_sem", "values", "valid_mask"):
        np.testing.assert_array_equal(getattr(tcb, f).numpy(),
                                      np.asarray(getattr(jcb, f)), err_msg=f)
    assert tcb.n_valid == int(jcb.n_valid)
    for f in ("sem_centroid", "sem_radius", "geo_centroid", "geo_radius"):
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=0,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("family", ["sem", "geo"])
@pytest.mark.parametrize("bm", [16, 48])
def test_tile_plan_equals_jax(banks, family, bm):
    """The keep mask, and the plan's idx and counts, equal JAX's exactly
    from the same bounding balls (JAX's stats), including a ragged last
    query tile (B=150) whose padded rows keep nothing."""
    jcb, jst, _, _ = banks
    q, x = _sorted_queries(jcb, 150, seed=1)
    qq = q if family == "sem" else x
    c, r = ((jst.sem_centroid, jst.sem_radius) if family == "sem"
            else (jst.geo_centroid, jst.geo_radius))
    temp = 12.0 if family == "sem" else 40.0
    jk = jcl.compute_keep_mask(jnp.asarray(qq), c, r, temp=temp, bm=bm)
    tk = tcl.compute_keep_mask(_t(qq), _t(c), _t(r), temp=temp, bm=bm)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    ji, jc = jcl.compute_tile_plan(jnp.asarray(qq), c, r, temp=temp, bm=bm)
    ti, tc = tcl.compute_tile_plan(_t(qq), _t(c), _t(r), temp=temp, bm=bm)
    assert ti.dtype == tc.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # geo at temp 40 prunes; sem here keeps every tile
    assert 0 < tc.float().mean() <= r.shape[0]
    assert family == "sem" or tc.float().mean() < r.shape[0]


def _operands(cb, q, x, tier):
    jq = jrp.pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier)
    jk = jrp.pack_bank(cb.keys_sem, cb.xyz, tier)
    sem_d, _ = jrp.packed_dims(cb.key_dim, tier)
    mask = (jrp.NEG * (1.0 - cb.row_mask()))[None, :].astype(jnp.float32)
    return jq, jk, sem_d, mask


def _tt(x):
    """A JAX array as a torch tensor of the same dtype."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


# Kernel 6's plain version against the JAX kernel in interpret mode: the
# same plan and operands; f32 values give the same f32 sums in another
# order (<= 2e-6 on outputs ~1).  int8 values round p * scale to bf16 on
# both sides; a p within a few ulps of a bf16 tie (the logits differ by
# summation order) rounds the other way: one bf16 ulp (2^-8 relative) of
# one weight, under 1e-3 of the output.
@pytest.mark.parametrize("family", ["sem", "geo"])
@pytest.mark.parametrize("quant,atol", [("f32", 2e-6), ("int8", 1e-3)])
def test_family_pruned_plain_matches_jax(banks, family, quant, atol):
    jcb, jst, _, _ = banks
    if quant == "int8":
        jcb = jquant(jcb)
    q, x = _sorted_queries(jcb, 40, seed=2)
    jq, jk, sem_d, mask = _operands(jcb, q, x, "high")
    cols = slice(0, sem_d) if family == "sem" else slice(sem_d, None)
    c, r = ((jst.sem_centroid, jst.sem_radius) if family == "sem"
            else (jst.geo_centroid, jst.geo_radius))
    idx, cnt = jcl.compute_tile_plan(jnp.asarray(q if family == "sem" else x),
                                     c, r, temp=12.0 if family == "sem" else 40.0,
                                     bm=BM)
    scale = jcb.value_scale
    j = jrp._family_pruned_call(jq[:, cols], jk[:, cols], jcb.values, mask, idx,
                                cnt, scale, bm=BM, bn=BN, interpret=True)
    t = trf._family_pruned_call(
        _tt(jq)[:, cols], _tt(jk)[:, cols], _tt(jcb.values), _tt(mask),
        _tt(idx), _tt(cnt), None if scale is None else _tt(scale), bm=BM, bn=BN)
    assert t.shape == (40, jcb.value_dim) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


# Kernel 7's plain version against the JAX kernel in interpret mode: f32
# values, the same sums in another order.
@pytest.mark.parametrize("tier", ["high", "exact"])
def test_hybrid_plain_matches_jax(banks, tier):
    jcb, jst, _, _ = banks
    q, x = _sorted_queries(jcb, 40, seed=3)
    jq, jk, sem_d, mask = _operands(jcb, q, x, tier)
    flags = jcl.compute_keep_mask(jnp.asarray(x), jst.geo_centroid,
                                  jst.geo_radius, temp=40.0, bm=BM
                                  ).astype(jnp.int32)
    assert 0 < int(flags.sum()) < flags.size
    j = jrp.retrieve_fused_hybrid(jq, jk, jcb.values, mask, jnp.float32(0.4),
                                  flags, sem_d=sem_d, bm=BM, bn=BN,
                                  interpret=True)
    t = trf.retrieve_fused_hybrid(_tt(jq), _tt(jk), _tt(jcb.values), _tt(mask),
                                  0.4, _tt(flags), sem_d=sem_d, bm=BM, bn=BN)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-6)


def _relerr(got, ref):
    """`tests/test_pruned.py:87`'s measure: |d| / max(|ref|, 0.1)."""
    return (np.abs(got - ref) / np.maximum(np.abs(ref), 0.1)).max()


# The whole path (query sort, plans, kernels 6 / 7, blend, unsort) against
# JAX's at the same inputs: f32 values, sums in another order (<= 2e-6);
# the fast tier's bf16 semantic operands are the same bits on both sides.
# Both are held to JAX's bar against the exact f32 `retrieve` (5e-3).
@pytest.mark.parametrize("path,mode,tier", [
    ("pruned", "range+", "high"), ("pruned", "range+", "fast"),
    ("pruned", "range", "high"), ("pruned", "range", "fast"),
    ("hybrid", "range+", "high"), ("hybrid", "range+", "fast")])
def test_pruned_and_hybrid_match_jax(banks, path, mode, tier):
    jcb, jst, tcb, tst = banks
    q, x = _queries(jcb, 48, seed=4)
    temp = 12.0 if mode == "range+" else 15.0
    kw = dict(sem_temp=temp, geo_temp=40.0, beta=0.5, tier=tier, bm=BM, bn=BN,
              margin=20.0)
    jx = None if mode == "range" else jnp.asarray(x)
    tx = None if mode == "range" else _t(x)
    if path == "pruned":
        j = jrp.retrieve_pruned(jnp.asarray(q), jx, jcb, jst, mode=mode,
                                interpret=True, **kw)
        t = trf.retrieve_pruned(_t(q), tx, tcb, tst, mode=mode, **kw)
    else:
        j = jrp.retrieve_hybrid(jnp.asarray(q), jx, jcb, jst, interpret=True, **kw)
        t = trf.retrieve_hybrid(_t(q), tx, tcb, tst, **kw)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=2e-6)
    ref = tr.retrieve(_t(q), tx, tcb, sem_temp=temp, geo_temp=40.0, beta=0.5,
                      mode=mode, chunk=BN).numpy()
    bar = 5e-3 if tier == "high" else 5e-2  # the fast tier's bf16 sem logits
    assert _relerr(t.numpy(), ref) < bar


def test_pruned_int8_bank_matches_jax(banks):
    """An int8 bank streams its codes with the scales (`tests/test_pruned.py:
    181-203`, here at the 'exact' tier and bm=8): the port matches JAX's
    interpret-mode path (bf16 weights p * scale on both sides: <= 1e-3, a
    rare bf16 flip) and stays within JAX's 0.05 of the exact retrieve over
    the f32 bank."""
    jcb, jst, tcb, tst = banks
    q, x = _queries(jcb, 8, seed=10)
    j = jrp.retrieve_pruned(jnp.asarray(q), jnp.asarray(x), jquant(jcb), jst,
                            tier="exact", bm=8, bn=BN, interpret=True)
    t = trf.retrieve_pruned(_t(q), _t(x), quantize_values(tcb), tst, tier="exact",
                            bm=8, bn=BN)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-3)
    ref = tr.retrieve(_t(q), _t(x), tcb).numpy()
    assert _relerr(t.numpy(), ref) < 0.05


def test_plans_and_kernel_shapes_are_checked(banks):
    """Mismatched stats, plans and tiles raise ValueError on the CPU too."""
    _, _, tcb, tst = banks
    q, x = _queries(tcb, 8, seed=5)
    with pytest.raises(ValueError, match="tile stats"):
        trf.retrieve_pruned(_t(q), _t(x), tcb, tst, bm=BM, bn=2 * BN)
    with pytest.raises(ValueError, match="plan"):
        trf.retrieve_fused_hybrid(
            torch.zeros(8, 384), torch.zeros(tcb.num_rows, 384),
            torch.zeros(tcb.num_rows, 4), torch.zeros(1, tcb.num_rows), 0.5,
            torch.zeros(2, tcb.num_rows // BN, dtype=torch.int32), sem_d=256,
            bm=BM, bn=BN)
    with pytest.raises(ValueError, match="pack"):
        tcl.geo_pack_order(tcb.xyz, tcb.row_mask(), BN, pack="tight")
