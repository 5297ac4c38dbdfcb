"""The Python around the dense kernel's Hopper body
(`csrc/fused_retrieval_sm90.cu`): its segment plan, and a plain version of
its segmented sums (each segment's partials added in the kernel's fixed
order, then normalized and blended, or laid out as the partials of kernel
5), held against the one-pass plain version and against the JAX fused
kernels in interpret mode on the banks of tests/test_torch_retrieval.py:
bf16 values (kernel 2), int8 codes with their row scales (kernel 3) and
the partials (kernel 5, both value kinds)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.bank.bank import quantize_values as jax_quantize
from range_tpu.ops import retrieval_pallas as jrp
from range_tpu_torch.convert.from_jax import geobank_from_arrays
from range_tpu_torch.ops import retrieval_fused as trf

TIERS = ["exact", "high", "fast"]


def _bank(n=700, pad_to=256, key_dim=64, value_dim=96, seed=0):
    jb = JaxGeoBank.synthetic(seed, n, key_dim=key_dim, value_dim=value_dim,
                              pad_to=pad_to)
    return jb, geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem,
                                   jb.values, jb.n_valid)


def _queries(b, key_dim=64, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, key_dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = rng.standard_normal((b, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return q, x


def _segments(plan, N):
    return [(lo, min(N, lo + plan.seg_rows)) for lo in range(0, N, plan.seg_rows)]


# ---- the segment plan


@pytest.mark.parametrize("N", [3001, 102_400])
@pytest.mark.parametrize("B", [1, 37, 77, 1000, 10_000])
@pytest.mark.parametrize("sem_d", [256, 768])
def test_segment_plan_covers_the_bank(B, N, sem_d):
    """Whole tiles a segment, every segment non-empty and the last one
    ragged where N is no multiple of it, no chain over SEG_ROWS_MAX rows,
    and the card's SMs given a block each unless every tile is a segment."""
    plan = trf._segment_plan(B, N, 1024, sem_d)
    # 'fast': the flat form's 64 x 256 tiles; 'high': the cluster form
    assert plan[:4] == ((64, 256, 0, 3) if sem_d == 256 else (64, 128, 4, 2))
    assert plan.seg_rows % plan.bn == 0 and plan.seg_rows <= trf.SEG_ROWS_MAX
    segs = _segments(plan, N)
    assert len(segs) == plan.n_seg and segs[0][0] == 0 and segs[-1][1] == N
    assert all(b - a == plan.seg_rows for a, b in segs[:-1])
    assert 0 < segs[-1][1] - segs[-1][0] <= plan.seg_rows
    blocks = -(-B // 64) * (1024 // plan.dvs)
    assert plan.n_seg * blocks >= trf.SM90_SMS or plan.seg_rows == plan.bn
    assert trf._sm90_smem(sem_d, *plan[:4]) <= 232_448


@pytest.mark.parametrize("sem_d,Dv,form,want", [
    (256, 1024, "cluster", (64, 256, 4, 3)),   # 4 slices: clusters of 4, 3 stages fit
    (768, 1024, "flat", (32, 128, 0, 2)),      # the flat form's 'high' instance
    (256, 512, "cluster", (64, 256, 2, 2)),    # 2 slices: 3 stages of 32-row shares do not fit
    (256, 96, "cluster", (64, 256, 1, 2)),     # 1 slice: a cluster of one
    (768, 1024, None, (64, 128, 4, 2)),
    (256, 1024, None, (64, 256, 0, 3)),        # the flat form's 'fast' instance
    (384, 1024, None, (64, 256, 4, 2)),        # no flat instance: the cluster form
])
def test_segment_plan_forms(sem_d, Dv, form, want):
    """Each form's tiles, cluster size and ring stages (the most that fit
    in a block's 232,448 bytes of shared memory), and a form that has no
    instance for the keys' width raises."""
    plan = trf._segment_plan(1000, 102_400, Dv, sem_d, form=form)
    assert plan[:4] == want
    assert trf._sm90_smem(sem_d, *want) <= 232_448
    if form == "flat":
        with pytest.raises(ValueError, match="shared memory"):
            trf._segment_plan(1000, 102_400, Dv, 384, form="flat")


@pytest.mark.parametrize("B,N,want", [
    (10_000, 102_400, (8, 12_800, 12_800)),  # the chain bound alone
    (1000, 102_400, (8, 12_800, 12_800)),
    (1, 102_400, (34, 3072, 1024)),          # 4 blocks: 34 segments fill 132 SMs
    (10_000, 3001, (1, 3008, 3001)),         # one ragged segment
    (1000, 3001, (4, 960, 121)),
    (77, 3001, (24, 128, 57)),
])
def test_segment_plan_values(B, N, want):
    """(segments, rows a segment, rows of the last one) at the dense path's
    bank (102,400 rows) and the card tests' ragged bank (3,001)."""
    plan = trf._segment_plan(B, N, 1024, 256)
    assert (plan.n_seg, plan.seg_rows, N - (plan.n_seg - 1) * plan.seg_rows) == want


def test_segment_plan_is_a_function_of_the_shape():
    assert trf._segment_plan(77, 3001, 1024, 256) == trf._segment_plan(77, 3001, 1024, 256)
    # a tighter chain bound cuts more segments, never a longer chain
    tight = trf._segment_plan(10_000, 102_400, 1024, 256, seg_rows_max=3200)
    assert tight.n_seg == 32 and tight.seg_rows == 3200
    straight = trf._segment_plan(10_000, 102_400, 1024, 256, seg_rows_max=102_400)
    assert straight.n_seg == 1 and straight.seg_rows == 102_400


@pytest.mark.parametrize("sem_d", [256, 768])
@pytest.mark.parametrize("B", [1, 37, 1000, 10_000])
def test_segment_plan_int8_fits_and_cuts_as_bf16(B, sem_d):
    """int8 codes (kernel 3, kernel 5's int8 form): the plan's form fits a
    block's shared memory with its two half tiles of codes and the scales;
    at sem_d 256 it is bf16's plan (the flat form has room for the codes),
    so the int8 path cuts a bank as the bf16 path does; at sem_d 768 the
    cluster form of 128-column slices (no flat 'high' instance takes codes)."""
    plan = trf._segment_plan(B, 102_400, 1024, sem_d, i8=True)
    assert trf._sm90_smem(sem_d, *plan[:4], i8=True) <= 232_448
    if sem_d == 256:
        assert plan == trf._segment_plan(B, 102_400, 1024, sem_d)
        assert plan[:4] == (64, 256, 0, 3)
    else:
        assert plan[:4] == (64, 128, 4, 2)
        with pytest.raises(ValueError, match="shared memory"):
            trf._segment_plan(B, 102_400, 1024, sem_d, form="flat", i8=True)


def test_int8_layout_is_the_kernels():
    """The shared memory `layout` / `clayout` give in the kernel's source:
    the flat 'fast' form with three key stages is 208,984 bytes, 225,400
    with the int8 halves (16,384 bytes), the scales and four barriers; the
    cluster form's int8 stage holds the scales on 128 bytes past the mask."""
    assert trf._sm90_smem(256, 64, 256, 0, 3) == 208_984
    assert trf._sm90_smem(256, 64, 256, 0, 3, i8=True) == 225_400
    assert trf._sm90_smem(768, 64, 128, 4, 2, i8=True) == 228_552
    assert trf._sm90_smem(768, 64, 128, 4, 2) == 220_296


@pytest.mark.parametrize("sem_d", [0, 96, 16 * 67])
def test_segment_plan_rejects_what_the_kernel_does_not_take(sem_d):
    """sem_d must be whole 64-column boxes, and the tiles must fit in a
    block's shared memory (sem_d 1,072 is not a multiple of 64; no tile of
    a sem_d of 3,008 would fit)."""
    with pytest.raises(ValueError, match="fused_sm90"):
        trf._segment_plan(10, 1000, 128, sem_d)
    with pytest.raises(ValueError, match="shared memory"):
        trf._segment_plan(10, 1000, 128, 3008)


# ---- the segmented sums in plain PyTorch


def _packed(tb, q, x, tier, mode):
    temp = 12.0 if mode == "range+" else 15.0
    q_cat = trf.pack_queries(torch.from_numpy(q), torch.from_numpy(x) if mode == "range+"
                             else None, temp, 40.0, tier)
    k_cat = trf.pack_bank(tb.keys_sem, tb.xyz, tier)
    mask = (trf.NEG * (1.0 - tb.row_mask()))[None, :]
    return q_cat, k_cat, mask, trf.packed_dims(tb.key_dim, tier)[0]


# The segments' sums are the one-pass sums re-associated (f32): measured
# ~1e-7 on outputs ~0.5, held to the JAX parity bar of
# tests/test_torch_retrieval.py.
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("mode", ["range+", "range"])
@pytest.mark.parametrize("B", [1, 24])
def test_segments_plain_matches_one_pass(tier, mode, B):
    _, tb = _bank(pad_to=7)  # 700 rows: no multiple of a tile
    q, x = _queries(B)
    q_cat, k_cat, mask, sem_d = _packed(tb, q, x, tier, mode)
    beta = 0.5 if mode == "range+" else 1.0
    plan = trf._segment_plan(B, tb.num_rows, tb.value_dim, 64)
    assert plan.n_seg > 1 and tb.num_rows % plan.seg_rows  # a ragged last segment
    got = trf._fused_segments_plain(q_cat, k_cat, tb.values, mask, beta, sem_d=sem_d,
                                    seg_rows=plan.seg_rows)
    ref = trf._retrieve_fused_plain(q_cat, k_cat, tb.values, mask, beta, sem_d=sem_d)
    torch.testing.assert_close(got, ref, rtol=0, atol=5e-6)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("seg_rows", [64, 192, 768])
def test_segments_plain_matches_jax(tier, seg_rows):
    """Against the JAX fused kernel in interpret mode (`retrieval_pallas.py:
    123`), as tests/test_torch_retrieval.py holds the one-pass version:
    segments of one tile, three tiles and the whole bank."""
    jb, tb = _bank()
    q, x = _queries(24)
    j = jrp.retrieve_pallas(jnp.asarray(q), jnp.asarray(x), jb, sem_temp=12.0,
                            beta=0.5, tier=tier, bm=16, bn=256, interpret=True)
    q_cat, k_cat, mask, sem_d = _packed(tb, q, x, tier, "range+")
    got = trf._fused_segments_plain(q_cat, k_cat, tb.values, mask, 0.5, sem_d=sem_d,
                                    seg_rows=seg_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=0, atol=5e-6)


def test_segments_plain_bf16_values_and_masked_rows():
    """bf16 values (p rounds to bf16 before the value product, per segment
    as in one pass) over a masked bank (700 real rows of 1,024) whose pad
    rows fill the last segments."""
    jb, _ = _bank(n=700, pad_to=512, seed=2)
    jb = JaxGeoBank(locs_lonlat=jb.locs_lonlat, xyz=jb.xyz, keys_sem=jb.keys_sem,
                    values=jb.values.astype(jnp.bfloat16), n_valid=jb.n_valid)
    tb = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values, jb.n_valid)
    q, x = _queries(19, seed=3)
    j = jrp.retrieve_pallas(jnp.asarray(q), jnp.asarray(x), jb, beta=0.3, bm=16, bn=256,
                            interpret=True)
    q_cat, k_cat, mask, sem_d = _packed(tb, q, x, "fast", "range+")
    got = trf._fused_segments_plain(q_cat, k_cat, tb.values, mask, 0.3, sem_d=sem_d,
                                    seg_rows=320)
    assert got.shape == (19, 96) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(j), rtol=0, atol=5e-6)


def _int8(jb, tb):
    """The bank's int8 codes and row scales, quantized by JAX, on both sides."""
    jq = jax_quantize(jb)
    return (jq.values, jq.value_scale, torch.from_numpy(np.array(jq.values)),
            torch.from_numpy(np.array(jq.value_scale, np.float32)))


def _within_terms(got, ref, mag, frac=4e-3):
    """The kernels' rule: min(frac x the row's max |ref|, 2^-7 x the sum of
    the terms' magnitudes) + 1e-6 elementwise: a weight the logits' summation
    order moves across a bf16 boundary rounds the other way, one ulp of
    that term."""
    got, ref, mag = (np.asarray(a, np.float64) for a in (got, ref, mag))
    row = np.abs(ref).max(axis=1, keepdims=True)
    tol = np.minimum(frac * row, 2.0 ** -7 * mag) + 1e-6
    assert np.all(np.abs(got - ref) <= tol), float((np.abs(got - ref) / tol).max())


# The segments re-associate the f32 sums; the weights bf16(p s) are those
# of JAX's kernel up to the logits' summation order (`_within_terms`).
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("seg_rows", [64, 320, 768])
def test_segments_plain_int8_matches_jax(tier, seg_rows):
    """The plain version of kernel 3's segmented form (int8 codes, each
    weight times its row's scale before the bf16 cast of the value
    products, the sums of the unscaled weights) against `_fused_kernel_i8`
    (`retrieval_pallas.py:181`) in interpret mode: segments of one tile, a
    ragged last one (768 rows in segments of 320) and the whole bank, over
    a bank of 700 real rows of 768."""
    jb, tb = _bank(pad_to=256)
    jv, js, tv, ts = _int8(jb, tb)
    q, x = _queries(24)
    jq = jrp.pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier=tier)
    jk = jrp.pack_bank(jb.keys_sem, jb.xyz, tier=tier)
    sem_d = jrp.packed_dims(64, tier)[0]
    mask = (jrp.NEG * (1.0 - jb.row_mask()))[None, :].astype(jnp.float32)
    j = np.asarray(jrp.retrieve_fused(jq, jk, jv, mask, 0.5, js, sem_d=sem_d, bm=8, bn=256,
                                      interpret=True))
    q_cat, k_cat, tmask, _ = _packed(tb, q, x, tier, "range+")
    got = trf._fused_segments_plain(q_cat, k_cat, tv, tmask, 0.5, ts, sem_d=sem_d,
                                    seg_rows=seg_rows)
    acc = [trf._fused_segments_plain(q_cat, k_cat, v, tmask, 0.5, ts, sem_d=sem_d,
                                     seg_rows=seg_rows, parts=True) for v in (tv, tv.abs())]
    Dv = tb.value_dim
    mag = 0.5 * (acc[1][:, :Dv] / acc[0][:, 2 * Dv:2 * Dv + 1]
                 + acc[1][:, Dv:2 * Dv] / acc[0][:, 2 * Dv + 1:2 * Dv + 2])
    assert got.shape == j.shape == (24, Dv)
    _within_terms(got.numpy(), j, mag.numpy())


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("seg_rows", [64, 320, 768])
def test_segments_plain_parts_match_jax(quant, seg_rows):
    """The plain version of kernel 5's segmented form ([acc_s | acc_g | d_s
    | d_g | 0 ...], the segments' partials added in order) against
    `_fused_parts_kernel` (`retrieval_pallas.py:314`) in interpret mode,
    bf16 values and int8 codes: each family's accumulators by the kernels'
    rule, the sums d within 2e-6 relative (f32 sums of the same weights in
    another order), the pad zero."""
    jb, tb = _bank(pad_to=256, seed=4)
    q, x = _queries(24, seed=5)
    if quant == "int8":
        jv, js, tv, ts = _int8(jb, tb)
    else:
        jv, js = jb.values.astype(jnp.bfloat16), None
        tv, ts = tb.values.to(torch.bfloat16), None
    jq = jrp.pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier="fast")
    jk = jrp.pack_bank(jb.keys_sem, jb.xyz, tier="fast")
    mask = (jrp.NEG * (1.0 - jb.row_mask()))[None, :].astype(jnp.float32)
    j = np.asarray(jrp.retrieve_fused_parts(jq, jk, jv, mask, js, sem_d=64, bm=8, bn=256,
                                            interpret=True))
    q_cat, k_cat, tmask, _ = _packed(tb, q, x, "fast", "range+")
    got = trf._fused_segments_plain(q_cat, k_cat, tv, tmask, 0.5, ts, sem_d=64,
                                    seg_rows=seg_rows, parts=True).numpy()
    mag = trf._fused_segments_plain(q_cat, k_cat, tv.abs(), tmask, 0.5, ts, sem_d=64,
                                    seg_rows=seg_rows, parts=True).numpy()
    Dv = tb.value_dim
    assert got.shape == j.shape == (24, 2 * Dv + 128)
    for cols in (slice(0, Dv), slice(Dv, 2 * Dv)):
        _within_terms(got[:, cols], j[:, cols], mag[:, cols])
    d = slice(2 * Dv, 2 * Dv + 2)
    np.testing.assert_allclose(got[:, d], j[:, d], rtol=2e-6, atol=0)
    assert not got[:, 2 * Dv + 2:].any() and not j[:, 2 * Dv + 2:].any()


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_segments_plain_parts_normalize_to_the_blend(quant):
    """Kernel 5's segmented partials, each family divided by its own sum
    and blended as `sharded_retrieve_pallas` does, give the blend form over
    the same segments (kernels 2 and 3) to f32 rounding: the (1, 1) mesh's
    answer is one card's."""
    jb, tb = _bank(pad_to=7, seed=6)
    q, x = _queries(9, seed=7)
    q_cat, k_cat, tmask, sem_d = _packed(tb, q, x, "fast", "range+")
    tv, ts = ((_int8(jb, tb)[2:]) if quant == "int8" else (tb.values.to(torch.bfloat16), None))
    Dv = tb.value_dim
    parts = trf._fused_segments_plain(q_cat, k_cat, tv, tmask, 0.3, ts, sem_d=sem_d,
                                      seg_rows=128, parts=True)
    got = 0.3 * (parts[:, :Dv] / parts[:, 2 * Dv:2 * Dv + 1].clamp_min(1e-30)) + 0.7 * (
        parts[:, Dv:2 * Dv] / parts[:, 2 * Dv + 1:2 * Dv + 2].clamp_min(1e-30))
    ref = trf._fused_segments_plain(q_cat, k_cat, tv, tmask, 0.3, ts, sem_d=sem_d, seg_rows=128)
    torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


def test_segments_plain_of_an_empty_bank_is_zero():
    q_cat = torch.zeros(3, 384, dtype=torch.bfloat16)
    got = trf._fused_segments_plain(q_cat, q_cat[:0], torch.zeros(0, 8), torch.zeros(1, 0),
                                    0.5, sem_d=256, seg_rows=64)
    assert got.shape == (3, 8) and not got.any()


def test_cpu_tensors_take_the_plain_version():
    """retrieve_fused on CPU tensors is `_retrieve_fused_plain`, whatever the
    tier, and counts no launch of either kernel body."""
    _, tb = _bank()
    q, x = _queries(5)
    before = (trf.retrieve_fused.launches, trf.retrieve_fused.exact_launches)
    for tier in TIERS:
        q_cat, k_cat, mask, sem_d = _packed(tb, q, x, tier, "range+")
        got = trf.retrieve_fused(q_cat, k_cat, tb.values, mask, 0.5, sem_d=sem_d)
        ref = trf._retrieve_fused_plain(q_cat, k_cat, tb.values, mask, 0.5, sem_d=sem_d)
        assert torch.equal(got, ref)
    assert (trf.retrieve_fused.launches, trf.retrieve_fused.exact_launches) == before


# ---- the card's packing: semantic columns padded with zeros


@pytest.mark.parametrize("key_dim", [16, 32, 40, 96, 256])
@pytest.mark.parametrize("tier", TIERS)
def test_card_packing_pads_the_semantic_columns_with_zeros(key_dim, tier):
    """`packed_dims(card=True)` rounds the semantic columns up to whole
    64-column boxes at the bf16 tiers and whole k16 steps at 'exact';
    `pack_queries` / `pack_bank` then hold JAX's semantic columns, zeros up
    to the padded width, and JAX's geo columns after them.  A zero column
    adds exactly 0 to every logit.  Without ``card`` (the CPU path) the
    packing is JAX's, bit for bit."""
    jb, tb = _bank(key_dim=key_dim)
    q, x = _queries(9, key_dim=key_dim)
    sem0, cat0 = trf.packed_dims(key_dim, tier)
    assert (sem0, cat0) == jrp.packed_dims(key_dim, tier)
    plain = (trf.pack_queries(torch.from_numpy(q), torch.from_numpy(x), 12.0, 40.0, tier),
             trf.pack_bank(tb.keys_sem, tb.xyz, tier))
    jax = (jrp.pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier=tier),
           jrp.pack_bank(jb.keys_sem, jb.xyz, tier=tier))
    for t, j in zip(plain, jax):
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    sem, cat = trf.packed_dims(key_dim, tier, card=True)
    step = 16 if tier == "exact" else 64
    assert sem % step == 0 and 0 <= sem - sem0 < step and cat % 128 == 0
    card = (trf.pack_queries(torch.from_numpy(q), torch.from_numpy(x), 12.0, 40.0, tier,
                             card=True),
            trf.pack_bank(tb.keys_sem, tb.xyz, tier, card=True))
    for t, ref in zip(card, plain):
        assert t.shape == (ref.shape[0], cat) and t.dtype == ref.dtype
        assert torch.equal(t[:, :sem0], ref[:, :sem0])
        assert not t[:, sem0:sem].any() and not t[:, sem + 9:].any()
        assert torch.equal(t[:, sem:sem + 9], ref[:, sem0:sem0 + 9])


@pytest.mark.parametrize("tier", TIERS)
def test_padded_packing_gives_the_same_answer(tier):
    """The plain version over the card's padded packing equals it over
    JAX's packing (the zero columns add exact zeros), at a 40-d bank, to
    1e-6 (the CPU matmul may block the longer rows in another f32 order);
    and `_packed` keeps JAX's packing for a bank on the CPU."""
    _, tb = _bank(key_dim=40)
    q, x = _queries(24, key_dim=40)
    mask = (trf.NEG * (1.0 - tb.row_mask()))[None, :]
    outs = []
    for card in (False, True):
        q_cat = trf.pack_queries(torch.from_numpy(q), torch.from_numpy(x), 12.0, 40.0, tier,
                                 card=card)
        k_cat = trf.pack_bank(tb.keys_sem, tb.xyz, tier, card=card)
        outs.append(trf._retrieve_fused_plain(q_cat, k_cat, tb.values, mask, 0.5,
                                              sem_d=trf.packed_dims(40, tier, card)[0]))
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-6)
    q_cat, k_cat, sem_d, _ = trf._packed(torch.from_numpy(q), torch.from_numpy(x), tb, 12.0,
                                         40.0, tier)
    assert sem_d == trf.packed_dims(40, tier)[0] and q_cat.shape[1] == k_cat.shape[1]
