"""The Python around the Hopper top-k kernel (`csrc/hier_argmax_sm90.cu`:
TPU kernels 10 and 11, the hi/lo argmax and the k-carry top-k): its plan
(`_klist_plan`: 64 or 128 queries a block, segments of each block's tile
list, the ring), the shared memory it asks for (`_klist_smem`), and a plain
version of its decomposition: each (query, tile)'s k best in extraction
order, a column at or below the minimum of the list folded from its
segment's start dropped, then the fold of the K tile lists in idx order
(an entry replaces the first minimum when strictly greater; a tile list's
first entry that does not enter ends it).  The decomposition is held to the
one-pass plain version (`_hier_klist_plain`) bit for bit, and to JAX's
`_hier_argmax_call` / `_hier_topk_call` in interpret mode, for k = 1, 2, 4
and 8.  Inputs are made from numpy seeds at small shapes.

Tolerances: against the one-pass plain version, exact (the same logits,
rearranged only in how the lists are carried).  Against JAX, exact on
dyadic operands (every logit exact in any summation order: the tie rules
alone decide), and on random operands JAX's own bar of
`tests/test_torch_topk.py::test_klist_plain_matches_jax`: scores within
2e-6, rows equal wherever the rival rows' logits are more than 2e-6 apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.ops import retrieval_hier as th
from range_tpu_torch.ops.retrieval import first_argmax
from range_tpu_torch.ops.topk import topk_stable

SMEM = 232_448  # a block's shared memory on the card
SMS = 132       # the card's SMs
NEG = -1e30
GAP = 2e-6


def _tile_lists(q2, ql, khl, mask_neg, idx, *, Dk, k, bm, bn):
    """Each (query, tile)'s k best in extraction order, as the one-pass
    plain version takes them (the same operations, so the same bits):
    scores [nB, bm, K, k] f32 and bank rows [nB, bm, K, k] int64."""
    f32 = torch.float32
    nB, K = idx.shape
    q2f = q2.to(f32).reshape(nB, bm, -1)
    qlf = ql.to(f32).reshape(nB, bm, -1)
    in_tile = torch.arange(bn)
    vals, rows = [], []
    for j in range(K):
        row0 = idx[:, j].long() * bn
        tile_rows = row0[:, None] + in_tile
        kt = khl[tile_rows].to(f32)
        logit = (q2f @ kt.transpose(1, 2)
                 + qlf @ kt[:, :, :Dk].transpose(1, 2))
        logit = (logit + mask_neg[0, tile_rows][:, None, :]).reshape(-1, bn)
        if k == 1:
            tv = logit.amax(dim=1, keepdim=True)
            ti = first_argmax(logit)[:, None]
        else:
            tv, ti = topk_stable(logit, k)
        vals.append(tv.reshape(nB, bm, k))
        rows.append(ti.reshape(nB, bm, k) + row0[:, None, None])
    return torch.stack(vals, 2), torch.stack(rows, 2)


def _fold(best, rows, tv, tr):
    """Insert one tile list (tv, tr [..., k], in extraction order) into the
    running lists (best, rows [..., k]): each entry in turn replaces the
    first minimum when strictly greater; the first that does not enter ends
    the list (the rest are no greater)."""
    k = best.shape[-1]
    kpos = torch.arange(k)
    alive = torch.ones(best.shape[:-1] + (1,), dtype=torch.bool)
    for r in range(k):
        m = tv[..., r:r + 1]
        cmin = best.amin(dim=-1, keepdim=True)
        cpos = torch.where(best <= cmin, kpos, k).amin(dim=-1, keepdim=True)
        alive = alive & (m > cmin)
        put = alive & (kpos == cpos)
        best = torch.where(put, m, best)
        rows = torch.where(put, tr[..., r:r + 1], rows)
    return best, rows


def _segmented(q2, ql, khl, mask_neg, idx, *, Dk, k, bm, bn, n_seg, filt=True):
    """The kernel's decomposition, written out: segment s of each list (its
    entries [s K / n_seg, (s + 1) K / n_seg)) writes each tile's list to the
    workspace, with ``filt`` every entry at or below the minimum of the
    list folded from the segment's start replaced by -inf; then the fold of
    the K workspace lists in idx order.  Returns the unsorted running list
    (scores [Bp, k] f32, rows [Bp, k] int32) and the workspace scores."""
    tv, tr = _tile_lists(q2, ql, khl, mask_neg, idx, Dk=Dk, k=k, bm=bm, bn=bn)
    nB, K = idx.shape
    work = tv.clone()
    for s in range(n_seg):
        best = torch.full((nB, bm, k), NEG)
        rows = torch.zeros((nB, bm, k), dtype=torch.int64)
        for j in range(s * K // n_seg, (s + 1) * K // n_seg):
            if filt:
                floor = best.amin(dim=-1, keepdim=True)
                work[:, :, j] = torch.where(tv[:, :, j] > floor, tv[:, :, j], -torch.inf)
            best, rows = _fold(best, rows, work[:, :, j], tr[:, :, j])
    best = torch.full((nB, bm, k), NEG)
    rows = torch.zeros((nB, bm, k), dtype=torch.int64)
    for j in range(K):
        best, rows = _fold(best, rows, work[:, :, j], tr[:, :, j])
    return (best.reshape(-1, k), rows.reshape(-1, k).to(torch.int32)), work


def _dyadic(seed, *, Dk, bn, bm, nB, nT, K, masked_tile=None):
    """Operands whose logits are exact in any summation order: 4 distinct
    key rows repeated within and across tiles (exact ties), a tenth of the
    rows masked (and with ``masked_tile`` every row of that tile, which is
    then in every list), the queries' entries dyadic."""
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, 4, nT * bn)
    khl = np.concatenate([rng.choice([-0.5, 0.0, 0.5], (4, Dk))[pick],
                          rng.choice([-2.0 ** -8, 0.0, 2.0 ** -8], (4, Dk))[pick]], 1)
    mask = np.where(rng.uniform(size=(1, nT * bn)) < 0.1, NEG, 0.0)
    qh = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (nB * bm, Dk))
    ql = rng.choice([-2.0 ** -9, 0.0, 2.0 ** -9], (nB * bm, Dk))
    idx = np.stack([rng.permutation(nT)[:K] for _ in range(nB)])
    if masked_tile is not None:
        mask[0, masked_tile * bn:(masked_tile + 1) * bn] = NEG
        idx[:, min(1, K - 1)] = masked_tile
    return (np.concatenate([qh, qh], 1).astype(np.float32), ql.astype(np.float32),
            khl.astype(np.float32), mask.astype(np.float32), idx.astype(np.int32))


def _random(seed, *, Dk, bn, bm, nB, nT, K):
    """Random unit queries and keys split hi/lo as the serving path does
    (bf16 hi, bf16 of the residual), a tenth of the rows masked."""
    rng = np.random.default_rng(seed)

    def unit(n):
        x = rng.standard_normal((n, Dk))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)

    def hilo(x):
        hi = torch.from_numpy(x).bfloat16().float()
        return hi.numpy(), (torch.from_numpy(x) - hi).bfloat16().float().numpy()

    qh, ql = hilo(unit(nB * bm))
    kh, kl = hilo(unit(nT * bn))
    mask = np.where(rng.uniform(size=(1, nT * bn)) < 0.1, NEG, 0.0).astype(np.float32)
    idx = np.stack([rng.permutation(nT)[:K] for _ in range(nB)]).astype(np.int32)
    return np.concatenate([qh, qh], 1), ql, np.concatenate([kh, kl], 1), mask, idx


def _torch(ops):
    q2, ql, khl, mask, idx = ops
    return (torch.from_numpy(q2).bfloat16(), torch.from_numpy(ql).bfloat16(),
            torch.from_numpy(khl).bfloat16(), torch.from_numpy(mask), torch.from_numpy(idx))


def _jax(ops, *, Dk, k, bm, bn):
    """JAX's kernels in interpret mode: (scores, rows) [Bp, k], sorted
    descending as its wrapper sorts them (k = 1: the argmax)."""
    q2, ql, khl, mask, idx = ops
    bf = jnp.bfloat16
    args = (jnp.asarray(q2, bf), jnp.asarray(ql, bf), jnp.asarray(khl, bf),
            jnp.asarray(mask), jnp.asarray(idx))
    if k == 1:
        out = np.asarray(jh._hier_argmax_call(*args, Dk=Dk, bm=bm, bn=bn, interpret=True))
        return out[:, :1].astype(np.float32), out[:, 1:2].astype(np.int32)
    s, r = jh._hier_topk_call(*args, Dk=Dk, k=k, bm=bm, bn=bn, interpret=True)
    return np.asarray(s, np.float32), np.asarray(r, np.int32)


# ---- the decomposition against the one-pass plain version


# (Dk, bn, bm, nB, nT, K): tiles of 16 and 32 rows, lists of 4, 7 and one
# tile
DYADIC = [(32, 16, 16, 3, 6, 4), (16, 32, 32, 2, 9, 7), (32, 16, 16, 2, 3, 1)]


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", DYADIC, ids=lambda s: "Dk{}-bn{}-bm{}-nB{}-nT{}-K{}".format(*s))
@pytest.mark.parametrize("masked_tile", [None, 2], ids=["some_masked", "tile_masked"])
def test_segments_equal_one_pass_on_ties(shape, k, masked_tile):
    """Exact ties within and across tiles, masked rows, a tile whose every
    row is masked, K = 1: every segment count from one to one a tile, with
    the segment-start filter and without, equals `_hier_klist_plain` bit for
    bit (scores and rows)."""
    Dk, bn, bm, nB, nT, K = shape
    ops = _torch(_dyadic(7 * k + K, Dk=Dk, bn=bn, bm=bm, nB=nB, nT=nT, K=K,
                         masked_tile=masked_tile))
    kw = dict(Dk=Dk, k=k, bm=bm, bn=bn)
    ref = th._hier_klist_plain(*ops, **kw)
    for n_seg in sorted({n for n in (1, 2, K) if n <= K}):
        for filt in (True, False):
            got, _ = _segmented(*ops, **kw, n_seg=n_seg, filt=filt)
            for a, b in zip(got, ref):
                assert torch.equal(a, b), (n_seg, filt)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("n_seg", [1, 3, 12])
def test_segments_equal_one_pass_on_random_data(k, n_seg):
    """Random unit queries and keys (near-ties among list minima included):
    the decomposition equals the one-pass plain version bit for bit, and
    the filter leaves each tile list's prefix above it intact (what is
    dropped could never enter)."""
    ops = _torch(_random(40 + k, Dk=48, bn=32, bm=16, nB=4, nT=20, K=12))
    kw = dict(Dk=48, k=k, bm=16, bn=32)
    ref = th._hier_klist_plain(*ops, **kw)
    got, work = _segmented(*ops, **kw, n_seg=n_seg)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    tv, _ = _tile_lists(*ops, **kw)
    kept = torch.isfinite(work)
    assert torch.equal(work[kept], tv[kept])
    # kept entries are a prefix of each tile list
    assert not (kept[..., 1:] & ~kept[..., :-1]).any()
    if n_seg < 12:  # a segment of more than one tile drops something
        assert (~kept).any()


# ---- the decomposition against JAX in interpret mode


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_segments_ties_equal_jax(k):
    """Dyadic operands with duplicated keys and a fully masked tile, each
    list cut into one segment a tile: the decomposition, sorted as the
    wrapper sorts it, equals JAX's kernels exactly."""
    Dk, bn, bm, nB, nT, K = 32, 16, 16, 3, 6, 4
    ops = _dyadic(20 + k, Dk=Dk, bn=bn, bm=bm, nB=nB, nT=nT, K=K, masked_tile=3)
    (s, r), _ = _segmented(*_torch(ops), Dk=Dk, k=k, bm=bm, bn=bn, n_seg=K)
    s, r = th._sort_klist(s, r)
    js, jr = _jax(ops, Dk=Dk, k=k, bm=bm, bn=bn)
    np.testing.assert_array_equal(r.numpy(), jr)
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_segments_match_jax_on_random_data(k):
    """Random operands, three segments a list: scores within 2e-6 of JAX's,
    rows equal wherever the rival row's logit is more than 2e-6 from JAX's
    score at that position (`test_klist_plain_matches_jax`'s bar)."""
    Dk, bn, bm, nB, nT, K = 32, 16, 16, 2, 10, 6
    ops = _random(60 + k, Dk=Dk, bn=bn, bm=bm, nB=nB, nT=nT, K=K)
    (s, r), _ = _segmented(*_torch(ops), Dk=Dk, k=k, bm=bm, bn=bn, n_seg=3)
    s, r = th._sort_klist(s, r)
    js, jr = _jax(ops, Dk=Dk, k=k, bm=bm, bn=bn)
    np.testing.assert_allclose(s.numpy(), js, rtol=0, atol=GAP)
    q2, ql, khl, mask, _ = ops
    q2, ql, khl = (torch.from_numpy(x).bfloat16().double().numpy() for x in (q2, ql, khl))
    kr = khl[r.numpy()]
    rival = (np.einsum("bd,bkd->bk", q2, kr) + np.einsum("bd,bkd->bk", ql, kr[..., :Dk])
             + mask[0][r.numpy()])
    off = r.numpy() != jr
    assert not (off & (np.abs(rival - js) > GAP)).any()


# ---- the plan

# padded batches of the endpoint's four batches (hier_topk's budget: B =
# 1, 37, 1,000 at K = 144 and bm 128, 10,000 at K = 48 and bm 256), then
# the same lists under each selection block size
PLAN_CASES = [(128, 128, 144), (1024, 128, 144), (10_240, 256, 48)] + [
    (Bp, bm, K) for bm in (64, 128, 256) for Bp, K in ((bm, 144), (1024, 144), (10_240, 48))]


@pytest.mark.parametrize("Dk", [48, 200, 256])
@pytest.mark.parametrize("Bp,bm,K", PLAN_CASES)
def test_klist_plan_covers_each_list_once(Bp, bm, K, Dk):
    """Each block's segment is a run of whole list entries, the segments of
    a list cover it exactly once, in order; 128 queries a block wherever
    bm allows it; the ring's 2 to 4 stages fit the block's shared memory;
    and a block takes no more tiles than one wave of the card's 132 SMs
    would leave it (the plan fills the card where the list allows)."""
    for bn in (32, 96, 512):
        plan = th._klist_plan(Bp, bm, K, bn, Dk, 8)
        assert plan == th._klist_plan(Bp, bm, K, bn, Dk, 1)  # k does not change it
        assert plan.bmb == (128 if bm % 128 == 0 else 64)
        assert 2 <= plan.S <= 4 and th._klist_smem(plan.bmb, Dk, plan.S) <= SMEM
        assert plan.S == 4 or th._klist_smem(plan.bmb, Dk, plan.S + 1) > SMEM
        assert 1 <= plan.n_seg <= K
        segs = [range(s * K // plan.n_seg, (s + 1) * K // plan.n_seg) for s in range(plan.n_seg)]
        assert all(len(s) >= 1 for s in segs)
        assert [j for s in segs for j in s] == list(range(K))
        n_qb = Bp // plan.bmb
        assert max(len(s) for s in segs) <= -(-K // max(1, SMS // n_qb))


@pytest.mark.parametrize("bmb", [64, 128])
def test_klist_smem_mirrors_the_kernel_layout(bmb):
    """`_klist_smem` against the kernel's layout written out: the query
    halves' ql boxes, S stages of kh and kl boxes of 64 rows (8 KB a 64-
    column box), 256 bytes of mask a stage, 2 KB of scratch a consumer warp
    (four a query half), 8 bytes a barrier (one for the queries, two a
    stage), 1,024 bytes of alignment slack; every key width fits two
    stages."""
    for Dk in range(8, 257, 8):
        kb = -(-Dk // 64)
        for S in (2, 3, 4):
            want = (bmb // 64 * (kb * 8192 + 4 * 2048) + S * 2 * kb * 8192 + S * 256
                    + 8 * (1 + 2 * S) + 1024)
            assert th._klist_smem(bmb, Dk, S) == want
        assert th._klist_smem(bmb, Dk, 2) <= SMEM
