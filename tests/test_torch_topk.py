"""The hierarchical top-k endpoint of range_tpu_torch (`hier_topk`,
`hier_nn`, `exact_nn`, `ops/topk.py`, the stats-only scan, the argmax and
k-carry kernels' plain versions, the hybrid query order), each against its
range_tpu counterpart on the CPU.

The bank is `tests/test_torch_hier.py`'s: JAX builds a 3,000-row
informative HierBank (bn = 128, topk_gsz = 8) and the port loads its
archive.  JAX's Pallas kernels run in interpret mode.  Inputs are float32
numpy arrays (conftest enables x64).

Tolerances: the hi/lo logits are f32 sums of bf16 products, |l| <= ~1
(cosines), summed in another order by the two packages (~1e-7); scores
agree within 2e-6 absolute, and rows must agree wherever the rival rows'
logits are more than 2e-6 apart (near-ties may flip; their count is
printed).  Exact ties are tested on dyadic operands, whose sums are exact
in any order.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import _np, archive, jbank, jhb, thb  # noqa: F401

from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval as jret
from range_tpu.ops import retrieval_hier as jh
from range_tpu.ops import topk as jtopk
from range_tpu.ops.retrieval_pallas import pack_queries as jax_pack_queries
from range_tpu.ops.retrieval_pallas import _split_hilo as jax_split_hilo
from range_tpu_torch.bank.bank import GeoBank
from range_tpu_torch.ops import retrieval as tret
from range_tpu_torch.ops import retrieval_hier as th
from range_tpu_torch.ops import topk as ttopk
from range_tpu_torch.ops.retrieval_fused import pack_queries

B = 256
GAP = 2e-6


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def queries():
    """B unit queries and their locations (uniform over the sphere)."""
    rng = np.random.default_rng(11)
    ll = np.stack([rng.uniform(-180, 180, B),
                   np.degrees(np.arcsin(rng.uniform(-1, 1, B)))], 1)
    q = rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)
    return q, x


@pytest.fixture(scope="module")
def regional(jhb):
    """B queries near 8 bank rows (3 degree jitter), each the bank key of a
    row nearby plus noise: coherent batches, the regime hier serves."""
    rng = np.random.default_rng(12)
    locs = _np(jhb.bank.locs_lonlat)
    keys = _np(jhb.bank.keys_sem)
    n = int(jhb.bank.n_valid)
    rows = np.repeat(rng.integers(0, n, 8), B // 8)
    ll = locs[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = keys[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)
    return q, x


# ---------------------------------------------------------------- ground truth


def _tie_banks(n=700, pad_to=128):
    """(JAX bank, port bank, queries): keys that repeat (8 distinct dyadic
    rows), so every query has exact ties within and across chunks; rows
    past n are padding."""
    from range_tpu.bank.bank import GeoBank as JaxGeoBank

    rng = np.random.default_rng(5)
    base = rng.choice([-0.5, 0.0, 0.5], (8, 256)).astype(np.float32)
    rows = -(-n // pad_to) * pad_to
    f = dict(locs_lonlat=np.zeros((rows, 2), np.float32),
             xyz=np.zeros((rows, 3), np.float32),
             keys_sem=base[rng.integers(0, 8, rows)],
             values=np.zeros((rows, 8), np.float32),
             valid_mask=(np.arange(rows) < n).astype(np.float32))
    jb = JaxGeoBank(n_valid=n, **{k: jnp.asarray(v) for k, v in f.items()})
    tb = GeoBank(n_valid=n, **{k: _t(v) for k, v in f.items()})
    q = rng.choice([-1.0, 0.0, 1.0], (64, 256)).astype(np.float32)
    return jb, tb, q


@pytest.mark.parametrize("case", ["bank", "ties"])
def test_exact_nn_equals_jax(jhb, thb, queries, case):
    """Strict > across chunks, lowest index within one; masked rows never
    win.  The tie bank's sums are exact, so only the tie rule decides."""
    if case == "bank":
        q = queries[0]
        j = jret.exact_nn(jnp.asarray(q), jhb.bank, chunk=500)
        t = tret.exact_nn(_t(q), thb.bank, chunk=500)
    else:
        jb, tb, q = _tie_banks()
        j = jret.exact_nn(jnp.asarray(q), jb, chunk=128)
        t = tret.exact_nn(_t(q), tb, chunk=128)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_exact_nn_restores_the_tf32_flag(thb, queries):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tret.exact_nn(_t(queries[0][:8]), thb.bank)
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("fn", ["topk_sem", "topk_packed"])
def test_topk_equals_jax(jhb, thb, queries, fn):
    """Rows equal (order included), scores within 1e-5 (f32 sums of the same
    products in another order), and the same recall@k against exact_nn."""
    q = queries[0]
    jv, ji = getattr(jtopk, fn)(jnp.asarray(q), jhb.bank, k=5, chunk=1024)
    tv, ti = getattr(ttopk, fn)(_t(q), thb.bank, k=5, chunk=1024)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    true = jret.exact_nn(jnp.asarray(q), jhb.bank)
    assert ttopk.recall_at_k(ti, _t(true)) == jtopk.recall_at_k(ji, true)


def test_topk_sem_ties_equal_jax():
    """Repeated keys: the running list wins ties against a later chunk, the
    lower index within one (`lax.top_k`)."""
    jb, tb, q = _tie_banks()
    _, ji = jtopk.topk_sem(jnp.asarray(q), jb, k=8, chunk=128)
    _, ti = ttopk.topk_sem(_t(q), tb, k=8, chunk=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ---------------------------------------------------------------- query order


def test_home_tile_equals_jax(jhb, thb, queries):
    q, x = queries
    q_cat = jax_pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0,
                             tier="fast")
    m_s = jh._hier_scan_stats_call(q_cat, jhb.g_sem_cat, jhb.g_geo_cat,
                                   bm=128, tc=8, gpt_s=8, gpt_g=8,
                                   interpret=True)[0]
    m_s = _np(m_s)
    m_s[:5] = -1.0  # all real tiles negative: a pad tile's 0 must not win
    m_s[5, 3] = m_s[5, 7] = 99.0  # a tie: the lower index
    np.testing.assert_array_equal(th._home_tile(_t(m_s), 24).numpy(),
                                  np.asarray(jh._home_tile(jnp.asarray(m_s), 24)))


@pytest.mark.parametrize("with_xyz", [True, False], ids=["hybrid", "no_xyz"])
def test_hybrid_order_equals_jax(queries, with_xyz):
    """The permutation itself, padded rows included (they sort last)."""
    Bp, t_pad = 384, 32
    rng = np.random.default_rng(13)
    x = np.pad(queries[1], ((0, Bp - B), (0, 0)))
    home = rng.integers(0, 24, Bp).astype(np.int32)
    j = jh._hybrid_order(jnp.asarray(x) if with_xyz else None,
                         jnp.asarray(home), B, t_pad, sort="hybrid")
    t = th._hybrid_order(_t(x) if with_xyz else None, B,
                         _t(home).long(), t_pad, sort="hybrid")
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("mode", ["range", "range+"])
def test_select_tiles_sel_equals_jax(jhb, queries, mode):
    q, x = queries
    q_cat = jax_pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0,
                             tier="fast")
    stats = [_np(s) for s in jh._hier_scan_stats_call(
        q_cat, jhb.g_topk_cat, jhb.g_geo_cat, bm=128, tc=8, gpt_s=16, gpt_g=8,
        interpret=True)]
    kw = dict(t_real=24, k_tiles=10, bm=128, n_valid=B - 5, j_sem=6, j_geo=2,
              mode=mode)
    ji, js = jh.select_tiles(*[jnp.asarray(s) for s in stats], **kw)
    ti, ts = th.select_tiles(*[_t(s) for s in stats], **kw)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("B_,want", [(1, (144, 128, 10)), (2047, (144, 128, 10)),
                                     (2048, (96, 128, 8)), (8191, (96, 128, 8)),
                                     (8192, (48, 256, 6)), (10_000, (48, 256, 6))])
def test_topk_budget_equals_jax(B_, want):
    assert th._topk_budget(B_, 48, 256, 6) == jh._topk_budget(B_, 48, 256, 6) == want


# ---------------------------------------------------------------- kernels


def _stats_operands(gpt_s):
    """Random bf16 packed queries and group centroids with gpt_s sem and 8
    geo groups per tile over 8 tiles."""
    rng = np.random.default_rng(gpt_s)
    bf = jnp.bfloat16
    q = jnp.asarray(rng.normal(0, 1.0, (256, 384)), bf)
    gs = jnp.asarray(rng.normal(0, 0.1, (8 * gpt_s, 256)), bf)
    gg = jnp.asarray(rng.normal(0, 0.5, (64, 128)), bf)
    return q, gs, gg


def _stats_close(got, ref):
    """Max logits within 1e-4 (f32 sums of the same bf16 products in
    another order, |l| < ~60), exp-masses within 1e-4 relative."""
    for name, a, b in zip(("m_s", "s_s", "m_g", "s_g"), ref, got):
        a, b = _np(a), b.numpy()
        assert b.shape == a.shape, name
        if name.startswith("m"):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=0, err_msg=name)


@pytest.mark.parametrize("gpt_s", [64, 32])
def test_scan_stats_plain_matches_jax(gpt_s):
    """The groups per tile of g_topk_cat (64) and g_sem_cat (32) at the
    flagship's bn = 512, on random operands."""
    q, gs, gg = _stats_operands(gpt_s)
    ref = jh._hier_scan_stats_call(q, gs, gg, bm=128, tc=4, gpt_s=gpt_s,
                                   gpt_g=8, interpret=True)
    got = th._hier_scan_stats_plain(_bf(q), _bf(gs), _bf(gg), gpt_s=gpt_s,
                                    gpt_g=8)
    _stats_close(got, ref)


@pytest.mark.parametrize("operand", ["g_topk_cat", "g_sem_cat"])
def test_scan_stats_plain_matches_jax_on_the_bank(jhb, thb, queries, operand):
    q, x = queries
    q_cat = jax_pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0,
                             tier="fast")
    gpt = 16 if operand == "g_topk_cat" else 8
    ref = jh._hier_scan_stats_call(q_cat, getattr(jhb, operand), jhb.g_geo_cat,
                                   bm=128, tc=8, gpt_s=gpt, gpt_g=8,
                                   interpret=True)
    got = th._hier_scan_stats_call(_bf(q_cat),
                                   getattr(thb, operand), thb.g_geo_cat,
                                   gpt_s=gpt, gpt_g=8)
    _stats_close(got, ref)


def test_scan_stats_equal_the_fused_scans(thb, queries):
    """hier_nn takes its stats from the stats-only scan: they are the
    fused scan's stats on the same operands, exactly."""
    q, x = queries
    q_cat = pack_queries(_t(q), _t(x), 12.0, 40.0, tier="fast")
    got = th._hier_scan_stats_plain(q_cat, thb.g_sem_cat, thb.g_geo_cat,
                                    gpt_s=8, gpt_g=8)
    ref = th._hier_scan_plain(q_cat, thb.g_sem_cat, thb.g_geo_cat,
                              thb.g_sem_vw, thb.g_geo_vw, gpt_s=8, gpt_g=8)
    for a, b in zip(got, ref[:4]):
        assert torch.equal(a, b)


def _hilo(q):
    qh, ql = jax_split_hilo(jnp.asarray(q, jnp.float32))
    return jnp.concatenate([qh, qh], 1), ql


def _row_logits(q2, ql, khl, mask, rows, Dk):
    """f64 hi/lo logits of the given rows [Bp, k] of each query."""
    q2, ql = _np(q2).astype(np.float64), _np(ql).astype(np.float64)
    khl, mask = _np(khl).astype(np.float64), _np(mask)[0].astype(np.float64)
    kr = khl[rows]  # [Bp, k, 2 Dk]
    return (np.einsum("bd,bkd->bk", q2, kr)
            + np.einsum("bd,bkd->bk", ql, kr[:, :, :Dk]) + mask[rows])


def _rows_agree_outside_near_ties(got_rows, ref_rows, ref_scores, q2, ql, khl,
                                  mask, Dk, tag):
    """Rows equal wherever the rival row's logit is more than GAP from the
    reference's score at that position; prints the near-tie count."""
    got_rows, ref_rows = np.asarray(got_rows), np.asarray(ref_rows)
    off = got_rows != ref_rows
    rival = _row_logits(q2, ql, khl, mask, got_rows, Dk)
    near = np.abs(rival - _np(ref_scores)) <= GAP
    print(f"{tag}: {int(off.any(axis=1).sum())} queries differ, "
          f"{int((off & near).any(axis=1).sum())} of them at near-ties")
    assert not (off & ~near).any()


@pytest.fixture(scope="module")
def klist_operands(jhb, regional):
    """Hi/lo queries of the regional batch and K=8 tiles per 128-query
    block from JAX's selection, in JAX's order."""
    q, x = regional
    q_cat = jax_pack_queries(jnp.asarray(q), None, 12.0, 40.0, tier="fast")
    order = jh._hybrid_order(jnp.asarray(x), jnp.zeros(B, jnp.int32), B,
                             jhb.t_pad, sort="geo")
    q_cat = q_cat[order]
    stats = jh._hier_scan_stats_call(q_cat, jhb.g_topk_cat, jhb.g_geo_cat,
                                     bm=128, tc=8, gpt_s=16, gpt_g=8,
                                     interpret=True)
    idx, _ = jh.select_tiles(*stats, t_real=24, k_tiles=8, bm=128, n_valid=B,
                             j_sem=6, mode="range")
    q2, ql = _hilo(np.asarray(q)[np.asarray(order)])
    return q2, ql, idx


def _bf(x):
    return _t(np.asarray(x, np.float32)).bfloat16()


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_klist_plain_matches_jax(jhb, thb, klist_operands, k):
    """`_hier_argmax_plain` (k = 1) and `_hier_topk_plain` against the JAX
    kernels in interpret mode, with JAX's idx given to both."""
    q2, ql, idx = klist_operands
    args = (q2, ql, jhb.khl_sem, jhb.mask_neg, idx)
    targs = (_bf(q2), _bf(ql), thb.khl_sem, thb.mask_neg,
             _t(idx).to(torch.int32))
    if k == 1:
        out = np.asarray(jh._hier_argmax_call(*args, Dk=256, bm=128, bn=128,
                                              interpret=True))
        js, jr = out[:, :1], out[:, 1:2].astype(np.int32)
        ts, tr = th._hier_argmax_plain(*targs, Dk=256, bm=128, bn=128)
        ts, tr = ts[:, None], tr[:, None]
    else:
        js, jr = jh._hier_topk_call(*args, Dk=256, k=k, bm=128, bn=128,
                                    interpret=True)
        ts, tr = th._hier_topk_plain(*targs, Dk=256, k=k, bm=128, bn=128)
    assert tr.dtype == torch.int32 and tr.shape == (B, k)
    np.testing.assert_allclose(ts.numpy(), _np(js), rtol=0, atol=GAP)
    _rows_agree_outside_near_ties(tr.numpy(), jr, js, q2, ql, jhb.khl_sem,
                                  jhb.mask_neg, 256, f"k={k}")


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_klist_ties_equal_jax(k):
    """Duplicated key rows, inside one tile and across selected tiles, and
    masked rows: dyadic operands make every logit exact in any summation
    order, so the tie rules alone decide: the lowest in-tile index first, a
    later tile only when strictly greater, the list's first minimum
    replaced, the final sort keeping list order."""
    rng = np.random.default_rng(20 + k)
    Dk, bn, bm, nB, nT = 32, 16, 16, 3, 6
    base_h = rng.choice([-0.5, 0.0, 0.5], (4, Dk))
    base_l = rng.choice([-2.0 ** -8, 0.0, 2.0 ** -8], (4, Dk))
    pick = rng.integers(0, 4, nT * bn)
    khl = np.concatenate([base_h[pick], base_l[pick]], 1).astype(np.float32)
    mask = np.where(rng.uniform(size=(1, nT * bn)) < 0.1, -1e30, 0.0)
    mask = mask.astype(np.float32)
    qh = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (nB * bm, Dk))
    q2 = np.concatenate([qh, qh], 1).astype(np.float32)
    ql = rng.choice([-2.0 ** -9, 0.0, 2.0 ** -9], (nB * bm, Dk)).astype(np.float32)
    idx = np.stack([rng.permutation(nT)[:4] for _ in range(nB)]).astype(np.int32)
    bf = jnp.bfloat16
    jargs = (jnp.asarray(q2, bf), jnp.asarray(ql, bf), jnp.asarray(khl, bf),
             jnp.asarray(mask), jnp.asarray(idx))
    targs = (_t(q2).bfloat16(), _t(ql).bfloat16(), _t(khl).bfloat16(),
             _t(mask), _t(idx))
    if k == 1:
        out = np.asarray(jh._hier_argmax_call(*jargs, Dk=Dk, bm=bm, bn=bn,
                                              interpret=True))
        js, jr = out[:, 0], out[:, 1].astype(np.int32)
        ts, tr = th._hier_argmax_plain(*targs, Dk=Dk, bm=bm, bn=bn)
    else:
        js, jr = jh._hier_topk_call(*jargs, Dk=Dk, k=k, bm=bm, bn=bn,
                                    interpret=True)
        ts, tr = th._hier_topk_plain(*targs, Dk=Dk, k=k, bm=bm, bn=bn)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(ts.numpy(), _np(js))


# ---------------------------------------------------------------- end to end


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("with_xyz", [True, False], ids=["xyz", "no_xyz"])
@pytest.mark.parametrize("budget", ["widened", "base"])
def test_hier_topk_equals_jax(jhb, thb, regional, k, with_xyz, budget):
    """The whole endpoint: B = 256 takes the 3x widened budget (bm 128, K =
    12 of 24 tiles, j + 4); ``base`` turns the widening off (K = 8).
    Rows equal outside near-ties."""
    q, x = regional
    kw = (dict(k_tiles=4, bm=128) if budget == "widened"
          else dict(k_tiles=8, bm=128, auto_widen=False))
    xx = x if with_xyz else None
    j = np.asarray(jh.hier_topk(jnp.asarray(q), None if xx is None else
                                jnp.asarray(xx), jhb, k=k, interpret=True, **kw))
    t = th.hier_topk(_t(q), None if xx is None else _t(xx), thb, k=k, **kw)
    assert t.dtype == torch.int32 and t.shape == j.shape
    t = t.numpy().reshape(B, -1)
    j = j.reshape(B, -1)
    if (t != j).any():  # only near-ties may differ
        q2, ql = _hilo(q)
        ref_scores = _row_logits(q2, ql, jhb.khl_sem, jhb.mask_neg, j, 256)
        _rows_agree_outside_near_ties(t, j, ref_scores, q2, ql, jhb.khl_sem,
                                      jhb.mask_neg, 256, "hier_topk")


def test_hier_topk_range_plus_equals_jax(jhb, thb, regional):
    q, x = regional
    j = np.asarray(jh.hier_topk(jnp.asarray(q), jnp.asarray(x), jhb, k=2,
                                k_tiles=4, bm=128, mode="range+",
                                interpret=True))
    t = th.hier_topk(_t(q), _t(x), thb, k=2, k_tiles=4, bm=128, mode="range+")
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("sort", ["geo", "hybrid"])
def test_hier_nn_equals_jax(jhb, thb, regional, sort):
    q, x = regional
    j = np.asarray(jh.hier_nn(jnp.asarray(q), jnp.asarray(x), jhb, k_tiles=8,
                              bm=128, j_sem=3, sort=sort))
    t = th.hier_nn(_t(q), _t(x), thb, k_tiles=8, bm=128, j_sem=3, sort=sort)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), j)


def test_retrieve_hier_hybrid_sort_matches_jax(jhb, thb, regional):
    """sort='hybrid': the stats-only pre-scan, the home-tile order, then
    the fused path.  PR 2's feature tolerance (f32 sums in other orders,
    a bf16-rounded exp one ulp the other way): 2e-4 on outputs ~0.5."""
    q, x = regional
    kw = dict(k_tiles=8, k_geo=4, bm=128, sort="hybrid")
    j = np.asarray(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb,
                                    concat_query=jnp.asarray(q),
                                    interpret=True, **kw))
    t = th.retrieve_hier(_t(q), _t(x), thb, concat_query=_t(q), **kw).numpy()
    assert t.shape == j.shape == (B, 384)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_retrieve_hier_unsorted_matches_jax(jhb, thb, regional):
    q, x = regional
    kw = dict(k_tiles=8, k_geo=4, bm=128, sort_queries=False)
    j = np.asarray(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb,
                                    concat_query=jnp.asarray(q),
                                    interpret=True, **kw))
    t = th.retrieve_hier(_t(q), _t(x), thb, concat_query=_t(q), **kw).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_unported_branches_raise(thb, regional):
    q, x = _t(regional[0][:8]), _t(regional[1][:8])
    # the feature path over a two-level bank without lr_rank
    # (`_hier_partials2`) serves: supergroups equal to the fine groups here
    two_level = dataclasses.replace(thb, gsz_super=thb.gsz_sem, g_sup_cat=thb.g_sem_cat,
                                    g_sup_vw=thb.g_sem_vw, lr_rank=0, g_sem_vw_lr=None)
    out = th.retrieve_hier(q, x, two_level, bm=128)
    assert out.shape == (8, 128) and torch.isfinite(out).all()
    # hier_topk on a topk_lr bank serves: a complete-rank sketch (the
    # identity basis) selects as the full stats operand
    low_rank = dataclasses.replace(thb, topk_lr=256, g_topk_lr=thb.g_topk_cat,
                                   p_topk=torch.eye(256))
    assert torch.equal(th.hier_topk(q, x, low_rank, bm=128), th.hier_topk(q, x, thb, bm=128))
    # RANGE mode serves banks without lr_rank too (kernel 15's plain
    # variant): no longer an unported branch
    no_lr = dataclasses.replace(thb, lr_rank=0, g_sem_vw_lr=None)
    out = th.retrieve_hier(q, None, no_lr, mode="range", bm=128)
    assert out.shape == (8, 128) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="k=9"):
        th.hier_topk(q, x, thb, k=9)


def test_new_wrappers_take_the_plain_version_on_cpu(thb, regional):
    q = _t(regional[0][:128])
    counts = (th._hier_scan_stats_call.launches, th._hier_argmax_call.launches,
              th._hier_topk_call.launches)
    th.hier_topk(q, None, thb, k=1, bm=128)
    th.hier_topk(q, None, thb, k=3, bm=128)
    assert (th._hier_scan_stats_call.launches, th._hier_argmax_call.launches,
            th._hier_topk_call.launches) == counts
