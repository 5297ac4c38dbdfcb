"""The Python around the hierarchical scan's Hopper kernel
(`csrc/hier_scan_sm90.cu`): its plan (`_scan_plan`: tiles, rings, column
slices and segments), and a plain version of its segmented scan (each
segment's stats and partial tail, the partials added in the kernel's
segment order), held against the one-pass plain version and against the
JAX scan kernel in interpret mode on the banks of tests/test_torch_hier.py
(two families, geo-less, full-width tails) and a tail_super bank of the
same rows (the segment-sum tail).  Inputs are made from numpy seeds.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import GPT, KW, jbank, packed  # noqa: F401

from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.convert.from_jax import _tensor
from range_tpu_torch.ops import retrieval_hier as th

# (G, wk, W, gpt, sup) a family, sem first: the main paths' scans on the
# 100,000-row bank (224 tiles a family) and two of the card tests' shapes
FLAGSHIP = ((7168, 256, 384, 32, 1), (1792, 128, 512, 8, 1))
SHAPES = {
    "flagship": FLAGSHIP,
    "range": FLAGSHIP[:1],
    "tail_super": ((7168, 256, 384, 32, 4), (1792, 128, 512, 8, 1)),
    "wide": ((14336, 256, 1152, 64, 1), (1792, 128, 1152, 8, 1)),
    "mixed": ((14336, 256, 384, 64, 1), (1792, 128, 1152, 8, 1)),
    "tail_super_wide": ((14336, 256, 1152, 64, 8), (1792, 128, 1152, 8, 1)),
    "wide_geo_less": ((14336, 256, 1152, 64, 1),),
    "card_test": ((256, 256, 384, 8, 1), (256, 128, 512, 8, 1)),
    "card_sup": ((256, 256, 384, 32, 16), (64, 128, 512, 8, 1)),
    "gpt_96": ((96 * 40, 64, 256, 96, 1), (16 * 40, 16, 128, 16, 1)),
}
BATCHES = [1, 37, 700, 1000, 10_000]


def _padded(B: int) -> int:
    """The serving path's padded batch: a multiple of its 128-query block."""
    return -(-B // 128) * 128


def _blocks(Bp, plan):
    return -(-Bp // 64) * sum(f.n_sl * f.n_seg for f in plan.fams)


# ---- the plan


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_scan_plan_covers_every_group_once(shape, B):
    """Every tile in exactly one segment (whole tiles, the last segment
    ragged and non-empty), every segment whole steps where a tile is
    shorter than a step, no accumulation chain over SCAN_ROWS_MAX tail
    rows, every 64-column box of the tail in one slice of at most 9, and
    the block's shared memory within the card's 232,448 bytes."""
    fams = SHAPES[shape]
    plan = th._scan_plan(_padded(B), fams)
    assert plan.bn in (32, 64) and len(plan.fams) == len(fams)
    for (G, wk, W, gpt, sup), f in zip(fams, plan.fams):
        T = G // gpt
        bounds = [min(T, s * f.seg_tiles) for s in range(f.n_seg + 1)]
        assert bounds[0] == 0 and bounds[-1] == T
        assert all(b - a == f.seg_tiles for a, b in zip(bounds[:-1], bounds[1:-1]))
        assert 0 < bounds[-1] - bounds[-2] <= f.seg_tiles
        if gpt < plan.bn:
            assert f.seg_tiles * gpt % plan.bn == 0
        assert f.seg_tiles * gpt // sup <= th.SCAN_ROWS_MAX
        boxes = W // 64
        assert f.sl_boxes <= 9 and (f.n_sl - 1) * f.sl_boxes < boxes <= f.n_sl * f.sl_boxes
        rv = th._scan_rows(plan.bn, sup)
        assert th._scan_smem(plan.bn, plan.gs, plan.vs, -(-wk // 64), f.sl_boxes,
                             rv) <= 232_448


@pytest.mark.parametrize("B", [1, 37])
@pytest.mark.parametrize("shape", ["flagship", "range", "tail_super", "wide", "mixed",
                                   "tail_super_wide", "wide_geo_less"])
def test_scan_plan_fills_the_card_at_small_batches(shape, B):
    """A request of 1 or 37 queries (one or two 64-query blocks) gives each
    of the card's 132 SMs a block at the main paths' shapes."""
    plan = th._scan_plan(_padded(B), SHAPES[shape])
    assert _blocks(_padded(B), plan) >= th.SM90_SMS


@pytest.mark.parametrize("shape,want", [
    ("flagship", (32, 4, 4)),   # 32-group steps, 4 + 4 stages beside 384 / 512 columns
    ("mixed", (32, 4, 4)),      # a 576-column geo slice beside 128 logit columns fits too
    ("wide", (32, 3, 3)),       # 576 columns beside 256 logit columns: 3 + 3
    ("tail_super_wide", (32, 4, 4)),  # 16-row supergroup value tiles leave the room
])
def test_scan_plan_tiles(shape, want):
    """Steps of 32 groups with the deepest rings that fit in a block's
    shared memory: TMA's latency needs several steps in flight."""
    plan = th._scan_plan(10_112, SHAPES[shape])
    assert plan[:3] == want


def test_scan_plan_slices_the_wide_tail_in_two():
    """1,152 columns (18 boxes): two slices of 576, so the logits run twice
    a query block, not three times as in 384-column slices."""
    plan = th._scan_plan(10_112, SHAPES["wide"])
    assert [(f.n_sl, f.sl_boxes) for f in plan.fams] == [(2, 9), (2, 9)]


def test_scan_plan_is_a_function_of_the_shape():
    a = th._scan_plan(10_112, FLAGSHIP)
    th._scan_plan.cache_clear()
    assert th._scan_plan(10_112, FLAGSHIP) == a
    assert th._scan_plan(128, FLAGSHIP) != a  # the batch changes the cut
    # a tighter chain bound cuts more segments, never a longer chain
    tight = th._scan_plan(10_112, SHAPES["wide"], rows_max=3200)
    assert tight.fams[0].seg_tiles * 64 <= 3200
    assert tight.fams[0].n_seg > th._scan_plan(10_112, SHAPES["wide"]).fams[0].n_seg
    # the defaults bank's 14,336 sem groups are one chain past the bound
    one = th._scan_plan(10_112, SHAPES["wide"], rows_max=10**9)
    assert th._scan_plan(10_112, SHAPES["wide"]).fams[0].n_seg >= 2
    assert one.fams[0].seg_tiles * one.fams[0].n_seg >= 224


def test_scan_plan_balances_the_families():
    """At B = 10,000 the flagship's sem blocks are cut so that no block
    holds more than twice the work of a geo block (a sem tile is four
    times a geo tile's: 7,168 x (256 + 384) against 1,792 x (128 + 512))."""
    plan = th._scan_plan(10_112, FLAGSHIP)
    sem, geo = plan.fams
    work = [f.seg_tiles * gpt * (kb * 64 + slb * 64)
            for f, gpt, kb, slb in ((sem, 32, 4, 6), (geo, 8, 2, 8))]
    assert sem.n_seg > 1 and work[0] <= 2 * work[1]


@pytest.mark.parametrize("kw,match", [
    (dict(gpt_s=24), "groups per tile"),
    (dict(sup_r=3), "sup_r=3"),
    (dict(sup_r=64, gpt_s=64), "sup_r=64"),
])
def test_scan_shapes_reject_what_the_kernel_does_not_take(kw, match):
    opts = dict(gpt_s=32, gpt_g=8, has_geo=True, sup_r=0)
    opts.update(kw)
    G = 8 * opts["gpt_s"]
    with pytest.raises(ValueError, match=match):
        th._scan_shapes(torch.zeros(64, 384), torch.zeros(G, 256), torch.zeros(64, 128),
                        torch.zeros(G // max(opts["sup_r"], 1), 384), torch.zeros(64, 512),
                        **opts)


def test_scan_shapes_reject_a_tail_of_no_whole_boxes():
    with pytest.raises(ValueError, match="unsupported shapes"):
        th._scan_shapes(torch.zeros(64, 384), torch.zeros(256, 256), torch.zeros(64, 128),
                        torch.zeros(256, 320), torch.zeros(64, 512), gpt_s=32, gpt_g=8,
                        has_geo=True, sup_r=0)


# ---- the segmented scan in plain PyTorch


def _segmented_plain(q_cat, g_sem, g_geo, vw_sem, vw_geo, *, gpt_s, gpt_g, plan,
                     has_geo=True, sup_r=0):
    """The kernel's arithmetic over `plan`'s segments: per family and
    segment the tiles' stats and the partial tail (bf16 of the exponentials,
    or of the f32 sums of each sup_r of them, times the segment's tail
    rows, in f32), the partials added in segment order 0, 1, ..."""
    f32 = torch.float32
    cat_d = q_cat.shape[1]
    q = q_cat.to(f32)
    fams = [(g_sem, vw_sem, slice(0, g_sem.shape[1]), gpt_s, sup_r or 1)]
    if has_geo:
        fams.append((g_geo, vw_geo, slice(cat_d - g_geo.shape[1], cat_d), gpt_g, 1))
    stats, tails = [], []
    for (g, vw, cols, gpt, sup), f in zip(fams, plan.fams):
        ms, ss, tail = [], [], None
        for seg in range(f.n_seg):
            lo, hi = seg * f.seg_tiles * gpt, min(g.shape[0], (seg + 1) * f.seg_tiles * gpt)
            m, s, e = th._family_stats(q[:, cols], g[lo:hi].to(f32), gpt)
            ms.append(m)
            ss.append(s)
            if sup > 1:
                e = e.reshape(e.shape[0], -1, sup).sum(dim=2)
            part = e.to(vw.dtype).to(f32) @ vw[lo // sup:hi // sup].to(f32)
            tail = part if tail is None else tail + part
        stats += [torch.cat(ms, 1), torch.cat(ss, 1)]
        tails.append(tail)
    stats += [None, None] * (2 - len(fams))
    return tuple(stats) + (torch.cat(tails, 1),)


def _bf16(rng, shape, scale):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).bfloat16()


@pytest.mark.parametrize("B", [1, 37, 700])
@pytest.mark.parametrize("case", ["two", "geo_less", "sup4", "sup16", "wide"])
def test_segmented_plain_matches_one_pass(case, B):
    """Random operands (numpy seeds) with several segments a family: the
    stats equal the one-pass plain version's bit for bit (the same logits
    of the same tiles), and the tails agree to f32 re-association: within
    1e-5 of each element's sum of |terms| (a few roundings of the partial
    sums, each <= 2^-24 of it)."""
    rng = np.random.default_rng(B)
    Bp = _padded(B)
    gpt_s, gpt_g, sup_r = 32, 8, {"sup4": 4, "sup16": 16}.get(case, 0)
    Ws = Wg = 1152 if case == "wide" else 384
    q = _bf16(rng, (Bp, 384), 1.0)
    gs, gg = _bf16(rng, (20 * gpt_s, 256), 0.1), _bf16(rng, (20 * gpt_g, 128), 0.5)
    vs = _bf16(rng, (20 * gpt_s // max(sup_r, 1), Ws), 1.0)
    vg = _bf16(rng, (20 * gpt_g, Wg), 1.0)
    kw = dict(gpt_s=gpt_s, gpt_g=gpt_g, has_geo=case != "geo_less", sup_r=sup_r)
    fams = th._scan_shapes(q, gs, gg, vs, vg, **kw)
    plan = th._scan_plan(Bp, fams)
    assert plan.fams[0].n_seg > 1
    got = _segmented_plain(q, gs, gg, vs, vg, plan=plan, **kw)
    ref = th._hier_scan_plain(q, gs, gg, vs, vg, **kw)
    mag = th._hier_scan_plain(q, gs, gg, vs.abs(), vg.abs(), **kw)[4]
    for a, b in zip(got[:4], ref[:4]):
        assert (a is None and b is None) or torch.equal(a, b)
    assert got[4].shape == ref[4].shape
    assert ((got[4] - ref[4]).abs() <= 1e-5 * mag + 1e-30).all()


# ---- against the JAX scan kernel (interpret mode) on the test banks


def _np(x):
    return np.asarray(x).astype(np.float32)


def _within_terms(got, ref, mag, frac=4e-3):
    """`tests/test_torch_hier.py::_within_terms`: the logits agree to f32
    summation order, so a bf16-rounded weight (an exponential, or a
    supergroup's f32 sum of them) can land one ulp the other way: each
    element within min(frac x its row's max |ref|, 2^-7 x its sum of
    |terms|) + 1e-6."""
    err = np.abs(got - ref)
    tol = np.minimum(frac * np.abs(ref).max(axis=1, keepdims=True), 2.0 ** -7 * mag) + 1e-6
    assert (err <= tol).all(), float((err / tol).max())


@pytest.fixture(scope="module")
def jts(jbank):  # noqa: F811
    """The test bank's HierBank with the supergroup sem tail (tail_super =
    64 rows: sup_r = 4 groups of 16)."""
    return jh.build_hier_bank(jbank, **KW, tail_super=64)


def _jax_and_segmented(packed, jhb, sem_vw, geo_vw, *, has_geo=True, sup_r=0,  # noqa: F811
                       rows_max=th.SCAN_ROWS_MAX):
    q_cat = packed["q_cat"]
    want = jh._hier_scan_call(q_cat, jhb.g_sem_cat, jhb.g_geo_cat, sem_vw, geo_vw, bm=128,
                              tc=4, gpt_s=GPT, gpt_g=GPT, has_geo=has_geo, sup_r_s=sup_r,
                              interpret=True)
    t = [_tensor(np.asarray(x)) for x in (q_cat, jhb.g_sem_cat, jhb.g_geo_cat, sem_vw, geo_vw)]
    kw = dict(gpt_s=GPT, gpt_g=GPT, has_geo=has_geo, sup_r=sup_r)
    plan = th._scan_plan(t[0].shape[0], th._scan_shapes(*t, **kw), rows_max=rows_max)
    got = _segmented_plain(*t, plan=plan, **kw)
    mag = th._hier_scan_plain(t[0], t[1], t[2], t[3].abs(), t[4].abs(), **kw)[4].numpy()
    return want, got, mag, plan


def _hold(want, got, mag, W_s, has_geo=True):
    names = ("m_s", "s_s", "m_g", "s_g") if has_geo else ("m_s", "s_s")
    for i, name in enumerate(names):
        a, b = _np(want[i]), got[i].numpy()
        if name[0] == "m":  # logits |l| < ~20: f32 sums of the same products
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4, err_msg=name)
        else:  # f32 sums of f32 exps in another order
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=0, err_msg=name)
    a, b = _np(want[4]), got[4].numpy()
    if not has_geo:  # JAX zero-fills the geo tail RANGE mode never reads
        assert not a[:, W_s:].any()
        a = a[:, :W_s]
    assert b.shape == a.shape
    for cols in ((slice(0, W_s), slice(W_s, None)) if has_geo else (slice(0, W_s),)):
        _within_terms(b[:, cols], a[:, cols], mag[:, cols])


@pytest.fixture(scope="module")
def jhb(jbank):  # noqa: F811
    return jh.build_hier_bank(jbank, **KW)


# rows_max 128: the segments of 16 tiles (128 groups) the small bank needs
# to be cut at all (a plan at its 24 tiles and 256 queries is one segment)
@pytest.mark.parametrize("rows_max", [th.SCAN_ROWS_MAX, 128])
@pytest.mark.parametrize("case", ["two", "geo_less", "full_width"])
def test_segmented_plain_matches_jax(packed, jhb, case, rows_max):  # noqa: F811
    """Two families with the low-rank tails, the geo-less launch (RANGE
    mode) and the full-width group sums (W = Dv + 128) on both families."""
    has_geo = case != "geo_less"
    sem_vw, geo_vw = ((jhb.g_sem_vw, jhb.g_geo_vw) if case == "full_width"
                      else (jhb.g_sem_vw_lr, jhb.g_geo_vw_lr))
    want, got, mag, plan = _jax_and_segmented(packed, jhb, sem_vw, geo_vw, has_geo=has_geo,
                                              rows_max=rows_max)
    if rows_max == 128:
        assert plan.fams[0].n_seg > 1
    _hold(want, got, mag, sem_vw.shape[1], has_geo)


@pytest.mark.parametrize("rows_max", [th.SCAN_ROWS_MAX, 32])
def test_segmented_plain_matches_jax_sup(packed, jts, rows_max):  # noqa: F811
    """The tail_super bank's supergroup operand (sup_r = 4): the f32 sums
    of 4 exponentials rounded to bf16 once, over segments."""
    sup_r = jts.tail_super // jts.gsz_sem
    want, got, mag, plan = _jax_and_segmented(packed, jts, jts.g_sem_ts_vw, jts.g_geo_vw_lr,
                                              sup_r=sup_r, rows_max=rows_max)
    assert sup_r == 4 and (rows_max > 32 or plan.fams[0].n_seg > 1)
    _hold(want, got, mag, jts.g_sem_ts_vw.shape[1])
