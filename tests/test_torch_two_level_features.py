"""The two-level feature path of range_tpu_torch (`retrieve_hier` on banks
with supergroup operands and no lr_rank: `_hier_partials2`, the refine
kernel's has_parts form) against range_tpu's on the CPU.

Sizes follow `tests/test_hier.py:268-304` and `tests/test_torch_two_level.py`:
the 3,000-row informative bank (256-d keys, bf16 128-d values) built by JAX
with bn = 128, gsz_sem = 8, gsz_geo = 16, gsz_super = 16 (16 fine groups
and 8 supergroups a tile); the port loads its archive, so both sides serve
the same operands.  JAX's Pallas kernels run in interpret mode.  Inputs
are float32 numpy arrays (conftest enables x64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import _within_terms, jbank, tbank  # noqa: F401
from test_torch_two_level import B, _bf, _np, _t, jhb2, q_cat, regional, thb2  # noqa: F401

from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.ops import retrieval as tret
from range_tpu_torch.ops import retrieval_hier as th

GPT_F, GPT_SUP, GPT_G = 16, 8, 8
# the outputs: f32 sums of the same bf16 products in other orders, a
# bf16-rounded weight one ulp the other way: 2e-4 on outputs ~0.5
# (`tests/test_torch_hier_api.py::test_flagship_matches_jax`)
ATOL = 2e-4


@pytest.fixture(scope="module")
def coarse(jhb2, q_cat):
    """JAX's coarse scan over the supergroups and its M = 8 tiles a block."""
    scan = jh._hier_scan_call(q_cat, jhb2.g_sup_cat, jhb2.g_geo_cat, jhb2.g_sup_vw,
                              jhb2.g_geo_vw, bm=128, tc=4, gpt_s=GPT_SUP, gpt_g=GPT_G,
                              interpret=True)
    idx_m, _ = jh.select_tiles(*scan[:4], t_real=24, k_tiles=8, bm=128, n_valid=B, j_sem=2,
                               j_geo=2, mode="range+")
    return scan, idx_m


def test_refine_parts_plain_matches_jax(jhb2, thb2, q_cat, coarse):
    """The has_parts form over 8 coarse tiles per block: the stats as the
    stats-only form's (1e-4 on the max logits, 1e-4 relative on the
    exp-masses), the fine-minus-supergroup partial [B, 256] (count column
    at 128) within one bf16 ulp of each term (`_within_terms`)."""
    _, idx = coarse
    m_j, s_j, p_j = jh._hier_refine_call(q_cat, idx, jhb2.g_sem_cat, jhb2.g_sup_cat,
                                         jhb2.g_sem_vw, jhb2.g_sup_vw, bm=128, gpt_f=GPT_F,
                                         gpt_sup=GPT_SUP, interpret=True)
    args = (_bf(q_cat), _t(idx).to(torch.int32), thb2.g_sem_cat, thb2.g_sup_cat,
            thb2.g_sem_vw, thb2.g_sup_vw)
    n0 = (th._hier_refine_call.launches, th._hier_refine_call.parts_launches)
    m_t, s_t, p_t = th._hier_refine_call(*args, bm=128, gpt_f=GPT_F, gpt_sup=GPT_SUP)
    assert (th._hier_refine_call.launches, th._hier_refine_call.parts_launches) == n0
    np.testing.assert_allclose(m_t.numpy(), _np(m_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), _np(s_j), rtol=1e-4, atol=0)
    mag = th._hier_refine_plain(*args[:3], bm=128, gpt_f=GPT_F, g_sup_cat=args[3],
                                g_sem_vw=args[4], g_sup_vw=args[5], gpt_sup=GPT_SUP,
                                magnitude=True)[2]
    assert p_t.shape == _np(p_j).shape == (B, 256)
    _within_terms(p_t.numpy(), _np(p_j), mag.numpy())


@pytest.mark.parametrize("mode", ["range+", "range"])
def test_second_selection_equals_jax(jhb2, thb2, q_cat, coarse, mode):
    """K = 4 of the M = 8 coarse tiles, selected on the refine's fine stats
    (and, in RANGE+, the coarse geo stats gathered at the M columns): the
    port's idx_k is JAX's exactly, on JAX's own stats."""
    scan, idx_m = coarse
    m_f, s_f, _ = jh._hier_refine_call(q_cat, idx_m, jhb2.g_sem_cat, jhb2.g_sup_cat,
                                       jhb2.g_sem_vw, jhb2.g_sup_vw, bm=128, gpt_f=GPT_F,
                                       gpt_sup=GPT_SUP, interpret=True)
    at = [jh._gather_cols(s, idx_m, 128) for s in scan[2:4]]
    kw = dict(t_real=8, k_tiles=4, bm=128, n_valid=B, j_sem=2, j_geo=2, mode=mode)
    loc_j, _ = jh.select_tiles(m_f, s_f, *at, **kw)
    idx_j = np.asarray(jnp.take_along_axis(idx_m, loc_j, axis=1))
    tm = _t(idx_m).to(torch.int32)
    t_at = ([th._gather_cols(_t(_np(s)), tm, 128) for s in scan[2:4]] if mode == "range+"
            else [None, None])
    loc_t, _ = th.select_tiles(_t(_np(m_f)), _t(_np(s_f)), *t_at, **kw)
    np.testing.assert_array_equal(torch.gather(tm, 1, loc_t.long()).numpy(), idx_j)


@pytest.mark.parametrize("mode", ["range+", "range"])
@pytest.mark.parametrize("budget", [dict(k_tiles=4, m_tiles=8), dict(k_tiles=4),
                                    dict(k_tiles=24, m_tiles=24)],
                         ids=["K4_M8", "K4_M_default", "all_tiles"])
def test_retrieve_hier_two_level_matches_jax(jhb2, thb2, regional, mode, budget):
    """The whole path, routed as JAX's (two-level: supergroup operands and
    no lr_rank; k_geo ignored; the default M = max(32, 3 K) clipped to the
    24 tiles): within ATOL of JAX's, RANGE+ and RANGE."""
    q, x = regional
    kw = dict(bm=128, k_geo=2, mode=mode, **budget)
    j = np.asarray(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb2, interpret=True,
                                    **kw))
    t = th.retrieve_hier(_t(q), _t(x), thb2, **kw).numpy()
    assert t.shape == j.shape == (B, 128)
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def test_hybrid_sort_reads_the_supergroup_stats(jhb2, thb2, regional):
    """sort='hybrid' on a two-level bank: the home tiles come from a stats
    scan over the supergroup centroids, as JAX's; within ATOL."""
    q, x = regional
    kw = dict(bm=128, k_tiles=4, m_tiles=8, sort="hybrid")
    j = np.asarray(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jhb2, interpret=True,
                                    **kw))
    t = th.retrieve_hier(_t(q), _t(x), thb2, **kw).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=ATOL)


def _relerr(out, ref):
    return (out - ref).abs() / ref.abs().clamp_min(0.1)


def test_all_tiles_telescope_is_exact(thb2, regional):
    """`tests/test_hier.py::test_hier2_all_tiles_matches_exact`: with every
    tile in M and K, coarse tail + sum_M (fine - super) + sum_K (exact -
    fine) is the dense softmax up to the bf16 weights: < 5e-3 of max(|ref|,
    0.1) against the exact f32 retrieve."""
    q, x = _t(regional[0]), _t(regional[1])
    T = thb2.t_real
    out = th.retrieve_hier(q, x, thb2, k_tiles=T, m_tiles=T, bm=128)
    ref = tret.retrieve(q, x, thb2.bank, sem_temp=12.0, beta=0.5)
    assert _relerr(out, ref).max() < 5e-3


def test_two_level_not_worse_than_one_level(thb2, regional):
    """`tests/test_hier.py::test_hier2_partial_not_worse_than_v1`: at K = 8
    exact tiles (M = 16) the two-level path's mean error against the exact
    retrieve stays within 1.1 x the one-level path's over the same bank
    (its fine g_sem_cat / g_sem_vw, without the supergroups)."""
    q, x = _t(regional[0]), _t(regional[1])
    ref = tret.retrieve(q, x, thb2.bank, sem_temp=12.0, beta=0.5)
    one = dataclasses.replace(thb2, gsz_super=0, g_sup_cat=None, g_sup_vw=None)
    e2 = _relerr(th.retrieve_hier(q, x, thb2, k_tiles=8, m_tiles=16, bm=128), ref).mean()
    e1 = _relerr(th.retrieve_hier(q, x, one, k_tiles=8, bm=128), ref).mean()
    assert e2 < e1 * 1.1, (e2, e1)


def test_two_level_routing(thb2, regional):
    """The two-level path ignores the family-split knobs, as JAX's: k_geo,
    dedup and the rescue leave its answer unchanged."""
    q, x = _t(regional[0]), _t(regional[1])
    kw = dict(k_tiles=4, m_tiles=8, bm=128)
    base = th.retrieve_hier(q, x, thb2, **kw)
    for extra in (dict(k_geo=4), dict(dedup=2), dict(adaptive_frac=0.5)):
        assert torch.equal(th.retrieve_hier(q, x, thb2, **kw, **extra), base), extra
    n0 = th._hier_refine_call.launches
    th.retrieve_hier(q, x, thb2, **kw)
    assert th._hier_refine_call.launches == n0  # the plain version on the CPU
