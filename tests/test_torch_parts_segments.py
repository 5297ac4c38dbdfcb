"""The Python around the family parts kernel's Hopper body
(`csrc/hier_parts_family_sm90.cu`, kernel 14's rr shapes): its plan
(`_parts_plan`: segments of each block's tile list, the ring) and a plain
version of its segmented arithmetic (each segment's partial over its share
of the block's distinct list entries, the partials added in segment order),
held against the one-pass plain version and against JAX's
`_hier_parts_family_call` in interpret mode on the banks of
tests/test_torch_hier.py, in each rr form (rr + lr, rr alone, sel,
dedup_pad); the kernel's walk of a tile's groups replayed for group sizes
of every kind (its shape checks and plan too), tiles of no whole number of
64-row steps (a masked last step) and the groupings whose layout needs the
DIRECT walk or the D block in device memory among them; the geo family's
logits over the one k16 step of its real columns; a bank of groups of 4
rows (128 groups a tile) through the plain versions and `retrieve_hier`
against JAX; and a bank of 96-row tiles of 12-row groups through
`load_model(retrieval="hier")` against JAX.  Inputs are made from numpy
seeds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import GPT, B, archive, jbank, jhb, packed, thb  # noqa: F401

from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.convert.from_jax import _tensor
from range_tpu_torch.ops import retrieval_hier as th

SMEM = 232_448  # a block's shared memory on the card
# (K, bn, gpt, kf, gwe, share, rrp, acols, out_w) of each rr launch the
# paths make on the 100,000-row bank: the flagship's two families (K at
# B >= 8,192, and at B < 2,048 three times it), the rr-only knob bank's
# (full-width sums: 1,025 alr columns), sel_lr=64's sem family (its group
# logits over the 64 sketch columns), dedup=2's merged sem lists, the
# gsz_sem=4 bank's 128 and a gsz 2 bank's 256 groups a tile, and the test
# bank's
SHAPES = {
    "flagship_sem": (32, 512, 32, 256, 256, True, 128, 384, 640),
    "flagship_geo": (16, 512, 8, 16, 16, True, 128, 512, 768),
    "small_batch_sem": (96, 512, 32, 256, 256, True, 128, 384, 640),
    "small_batch_geo": (48, 512, 8, 16, 16, True, 128, 512, 768),
    "rr_sem": (16, 512, 64, 256, 256, True, 128, 1025, 1280),
    "rr_geo": (8, 512, 8, 16, 16, True, 128, 1025, 1280),
    "sel": (32, 512, 32, 256, 64, False, 128, 384, 640),
    "dedup_sem": (48, 512, 32, 256, 256, True, 128, 384, 640),
    "gsz4_sem": (32, 512, 128, 256, 256, True, 128, 384, 640),
    "gsz2_sem": (32, 512, 256, 256, 256, True, 128, 384, 640),
    "test_bank": (8, 128, 8, 256, 256, True, 128, 256, 512),
}
# padded batches: B = 1 and 37 (one 128-query block), 1,000, 10,000; the
# rescue's re-run (384 queries in blocks of 128)
BATCHES = [128, 1024, 10_112, 384]


def _split(n: int, n_seg: int):
    """The kernel's split of a block's n distinct entries: segment s takes
    [s n / n_seg, (s + 1) n / n_seg)."""
    return [(s * n // n_seg, (s + 1) * n // n_seg) for s in range(n_seg)]


def _distinct(row):
    keep = np.ones(len(row), bool)
    keep[1:] = row[1:] != row[:-1]
    return row[keep]


# ---- the plan


@pytest.mark.parametrize("Bp", BATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_parts_plan_covers_every_entry_once(shape, Bp):
    """Lists with dedup_pad repeats (numpy seeds): each block's distinct
    entries fall in exactly one segment each, in list order, no segment
    past seg_cap tiles or over PARTS_ROWS_MAX rows, and the block's shared
    memory within the card's 232,448 bytes."""
    K, bn, gpt, kf, gwe, share, rrp, acols, out_w = SHAPES[shape]
    plan = th._parts_plan(Bp, *SHAPES[shape])
    assert 1 <= plan.n_seg <= K and plan.seg_cap == -(-K // plan.n_seg) and plan.S in (2, 3, 4)
    assert plan.seg_cap * bn <= th.PARTS_ROWS_MAX
    lay = th._parts_layout(K, bn, gpt, kf, gwe, share, rrp, acols, plan.seg_cap, plan.S)
    assert lay.total <= SMEM and lay.S2 >= 2
    rng = np.random.default_rng(Bp + K)
    for _ in range(8):
        row = np.sort(rng.permutation(400)[:K])
        row[rng.random(K) < 0.3] = -1  # repeats of the entry before
        row = np.maximum.accumulate(row)
        distinct = _distinct(row)
        segs = [distinct[lo:hi] for lo, hi in _split(len(distinct), plan.n_seg)]
        assert all(len(s) <= plan.seg_cap for s in segs)
        assert np.array_equal(np.concatenate(segs), distinct)


@pytest.mark.parametrize("Bp", BATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_parts_plan_fills_the_card(shape, Bp):
    """Every SM gets a block wherever the lists allow it: B = 1 and 37
    (two 64-query blocks), 1,000, 10,000 and the rescue's 6 blocks of
    96 tiles."""
    K = SHAPES[shape][0]
    plan = th._parts_plan(Bp, *SHAPES[shape])
    assert Bp // 64 * plan.n_seg >= min(th.SM90_SMS, Bp // 64 * K)


def test_parts_plan_splits_the_flagship_list():
    """The flagship's 32 sem tiles of 512 rows (16,384 rows) exceed one
    chain: two segments at least, and the rescue's 6 x 96 tiles at least
    22 a block."""
    assert th._parts_plan(10_112, *SHAPES["flagship_sem"]).n_seg >= 2
    assert th._parts_plan(384, *SHAPES["small_batch_sem"]).n_seg >= 22


def test_parts_plan_is_a_function_of_the_shape():
    a = th._parts_plan(10_112, *SHAPES["flagship_sem"])
    th._parts_plan.cache_clear()
    assert th._parts_plan(10_112, *SHAPES["flagship_sem"]) == a
    assert th._parts_plan(128, *SHAPES["flagship_sem"]) != a  # the batch changes the cut
    tight = th._parts_plan(10_112, *SHAPES["flagship_sem"], rows_max=2048)
    assert tight.seg_cap * 512 <= 2048 and tight.n_seg > a.n_seg


@pytest.mark.parametrize("gpt,match", [(512, "shared memory")])
def test_parts_plan_raises_what_no_block_holds(gpt, match):
    """Groups of one row at bn 512: a tile's D block (512 columns) does
    not fit beside the ring, so the plan takes the DIRECT walk (its unit
    sums from the p tile) with the D block in device memory, which fits;
    the common layout alone still finds no block that holds it (the
    message the plan raised before the device-memory D block)."""
    plan = th._parts_plan(10_112, 32, 512, gpt, 256, 256, True, 128, 384, 640)
    assert plan.direct and plan.dglob
    lay = th._parts_layout(32, 512, gpt, 256, 256, True, 128, 384, plan.seg_cap, plan.S,
                           plan.direct, plan.dglob)
    assert th._parts_fits(lay) and lay.lst == lay.d and lay.d == lay.sm
    assert not any(th._parts_fits(th._parts_layout(32, 512, gpt, 256, 256, True, 128, 384,
                                                   1, S)) for S in (2, 3, 4)), match


def _rr_operands(rng, *, Bp, T, bn, gpt, W=384, lr=True):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()  # noqa
    N, G = T * bn, T * gpt
    lrr = W - 128 if lr else 1024
    vw = f(G, W)
    vw[:, lrr] = float(bn // gpt)
    idx = torch.from_numpy(np.stack([rng.permutation(T)[:6] for _ in range(Bp // 128)])
                           .astype(np.int32))
    return (f(Bp, 384) * 0.3, f(N, 384) * 0.3, torch.zeros(1, N), idx, f(G, 256) * 0.3, vw,
            f(N, 128)), lrr


@pytest.mark.parametrize("bn,gpt", [(96, 8), (64, 4)])
def test_parts_shapes_reject_what_the_kernel_does_not_take(bn, gpt):
    """Fewer than 8 groups a tile (which the scan does not take) raises
    before any launch; a tile of no whole number of 64-row steps (96 rows,
    refused before the masked last step) is taken."""
    args, lrr = _rr_operands(np.random.default_rng(0), Bp=128, T=4, bn=bn, gpt=gpt)
    kw = dict(sem_d=256, bm=128, bn=bn, gpt=gpt, geo=False, lrr=lrr, lr=True, sel=False)
    if gpt < 8:
        with pytest.raises(ValueError, match="unsupported shapes"):
            th._parts_shapes(*args, **kw)
        return
    sh = th._parts_shapes(*args, **kw)
    assert sh["kf"] == 256 and sh["out_w"] == 640


# (bn, gpt) of groups of every kind: one unit a group (gsz dividing 64),
# whole steps (64, 128, 192 rows), and several units ending inside a step
# (96 = 3 x 32, 48 = 3 x 16, 24, 20, 12, 6, 3); the parent kernel's limits
# were gsz a multiple of 8 and 64 groups a tile.  Then tiles of no whole
# number of steps (96 and 160 rows: 12- and 20-row groups; 24, 48, 96 and
# 32 rows of 3-, 6- and 1-row groups), and the groupings whose common
# layout fits no block (3 rows at 64 and 128 groups a tile, 1 row at 192
# and 512, 2 at 416, 4 at 448)
GROUPINGS = [(512, 8), (512, 32), (512, 64), (512, 128), (512, 256), (1024, 8), (64, 8),
             (64, 16), (768, 8), (384, 8), (192, 8), (320, 16), (384, 32), (384, 64),
             (384, 128), (1536, 8), (96, 8), (160, 8), (192, 64), (192, 192), (512, 512),
             (832, 416), (1792, 448), (24, 8), (48, 16), (96, 32), (96, 16), (32, 32)]
# the (EG, NG) pairs the kernel is built for (`groups_any`): with the
# segment matrix, and (EG, 64) of the DIRECT walk (units of one row)
KERNEL_GROUPS = {(8, 8), (8, 16), (8, 32), (16, 8), (16, 16), (16, 32), (32, 8), (32, 16),
                 (32, 32), (64, 64), (8, 64), (16, 64), (32, 64)}
# the groupings whose plan takes the DIRECT walk / the D block in device
# memory at the flagship's widths
DIRECT = {(192, 64), (384, 128), (192, 192), (512, 512), (24, 8), (48, 16), (96, 32),
          (32, 32)}
DGLOB = {(512, 512), (832, 416), (1792, 448)}


def _kernel_group_rows(bn: int, gpt: int) -> dict:
    """Replays the kernel's walk of one tile's groups (warpgroup 2 of
    `csrc/hier_parts_family_sm90.cu`): 64-row steps in chunks of EG groups
    (a chunk ends on a step or is the tile; where EG does not divide gpt
    the last chunk holds the groups left over and ends where the tile
    ends), the tile's last step masked
    past its rows (ceil(bn / 64) steps, the last counting its nu_last units
    only), each step's sums over units of gcd(gsz, 64) rows, and the
    counters that close a group (at its unit, across steps, or through the
    unit sums); returns the rows each group's D was summed over (rows past
    the tile have p = 0 and belong to no group)."""
    gsz = bn // gpt
    EG, NG = th._parts_groups(gpt, gsz)
    u = math.gcd(gsz, 64)
    nu, upg = 64 // u, gsz // u
    assert (EG, NG) in KERNEL_GROUPS and NG >= nu
    assert EG * gsz % 64 == 0 or EG == gpt
    chunks = -(-gpt // EG)  # the last one what is left past the others
    chunk_steps = -(-EG * gsz // 64)
    spt = -(-bn // 64)
    cs_last = spt - (chunks - 1) * chunk_steps  # it ends where the tile ends
    nu_last = (bn - (spt - 1) * 64) // u
    units = nu > 1 and upg > 1
    ng, gsteps = (0 if units else nu), (upg if nu == 1 else 1)
    rows, run, uc, gs, acc = {}, [], 0, 0, None
    for c in range(chunks):
        ci = 0
        csteps = cs_last if c + 1 == chunks else chunk_steps
        for cs in range(csteps):
            last = cs + 1 == csteps and c + 1 == chunks
            nu_step = nu_last if last else nu
            r0 = (c * chunk_steps + cs) * 64
            step = [list(range(r0 + k * u, r0 + (k + 1) * u)) for k in range(nu)]
            if units:
                for k in range(nu_step):
                    run, uc = run + step[k], uc + 1
                    if uc == upg:
                        rows[c * EG + ci], run, uc, ci = run, [], 0, ci + 1
                continue
            acc = step if gs == 0 else [a + b for a, b in zip(acc, step)]
            gs += 1
            if gs == gsteps:
                ng_step = nu_last if last else ng
                for col in range(ng_step):
                    rows[c * EG + ci + col] = acc[col]
                gs, ci = 0, ci + ng_step
    assert run == [] and uc == 0  # no open group past the tile
    return rows


@pytest.mark.parametrize("bn,gpt", GROUPINGS)
def test_parts_kernel_sums_each_group_over_its_rows(bn, gpt):
    """Every group size and a number of groups the scan takes, on tiles of
    whole 64-row steps and of a masked last step (96 and 160 rows): the
    kernel's counters sum group g over exactly rows [g gsz, (g + 1) gsz),
    with a chunk of EG groups ending on a step (or being the tile) and an
    (EG, NG) pair the kernel is built for."""
    gsz = bn // gpt
    assert th._gpt_ok(gpt)
    rows = _kernel_group_rows(bn, gpt)
    assert sorted(rows) == list(range(gpt))
    for g, r in rows.items():
        assert r == list(range(g * gsz, (g + 1) * gsz)), g


@pytest.mark.parametrize("bn,gpt", GROUPINGS)
def test_parts_shapes_take_every_group_size(bn, gpt):
    """Each grouping passes the launch's shape checks, and its plan fits a
    block's shared memory at the flagship's widths: groups of 3 rows at bn
    384 (128 groups a tile, 64 units a step, whose unit sums left no room
    for a ring) by the DIRECT walk, and the groupings of DIRECT / DGLOB
    by theirs (odd group sizes at up to 32 groups a tile by the DIRECT
    walk alone: the kernel has no segment-matrix instance of their (EG,
    64) pairs); every other grouping keeps the common layout."""
    args, lrr = _rr_operands(np.random.default_rng(gpt), Bp=128, T=4, bn=bn, gpt=gpt)
    sh = th._parts_shapes(*args, sem_d=256, bm=128, bn=bn, gpt=gpt, geo=False, lrr=lrr,
                          lr=True, sel=False)
    shape = (32, bn, gpt, sh["kf"], sh["gwe"], sh["share"], 128, sh["acols"], sh["out_w"])
    plan = th._parts_plan(10_112, *shape)
    assert (plan.direct, plan.dglob) == ((bn, gpt) in DIRECT, (bn, gpt) in DGLOB)
    assert th._parts_fits(th._parts_layout(*shape[:-1], plan.seg_cap, plan.S, plan.direct,
                                           plan.dglob))


# odd group sizes at an odd multiple of 32 groups a tile (3 rows at 96 and
# 160 a tile, 1 row at 96 and 160): 64-group chunks, then a last chunk of
# 32 ending in the tile's masked last step
SHORT_LAST_CHUNK = [(288, 96), (96, 96), (480, 160), (160, 160)]


@pytest.mark.parametrize("bn,gpt", SHORT_LAST_CHUNK)
def test_parts_walk_over_a_short_last_chunk(bn, gpt):
    """The walk at groupings whose tile 64-group chunks do not divide (96
    or 160 groups): every group summed over exactly its rows, the last
    chunk of 32 groups closing at the tile's end; the launch's checks take
    them and the plan fits a block at the flagship's widths."""
    gsz = bn // gpt
    EG, _ = th._parts_groups(gpt, gsz)
    assert EG == 64 and gpt % EG == 32 and bn % 64 == 32
    rows = _kernel_group_rows(bn, gpt)
    assert sorted(rows) == list(range(gpt))
    for g, r in rows.items():
        assert r == list(range(g * gsz, (g + 1) * gsz)), g
    args, lrr = _rr_operands(np.random.default_rng(gpt), Bp=128, T=4, bn=bn, gpt=gpt)
    sh = th._parts_shapes(*args, sem_d=256, bm=128, bn=bn, gpt=gpt, geo=False, lrr=lrr,
                          lr=True, sel=False)
    shape = (32, bn, gpt, sh["kf"], sh["gwe"], sh["share"], 128, sh["acols"], sh["out_w"])
    plan = th._parts_plan(10_112, *shape)
    assert th._parts_fits(th._parts_layout(*shape[:-1], plan.seg_cap, plan.S, plan.direct,
                                           plan.dglob))
    assert _launch_takes(bn, gpt, plan.direct, plan.dglob)


def _launch_takes(bn: int, gpt: int, direct: bool, dglob: bool) -> bool:
    """The group checks of `hier_parts_family_sm90_launch` (the (EG, NG)
    pair the layout gives, `_parts_groups`), transcribed."""
    if gpt < 8 or bn % gpt or (32 % gpt if gpt <= 32 else gpt % 32):
        return False
    gsz = bn // gpt
    EG, NG = th._parts_groups(gpt, gsz)
    lu = ((gsz | 64) & -(gsz | 64)).bit_length() - 1
    nu = 64 >> lu
    rare = (EG == 16 and NG in (16, 32)) or (EG == 8 and NG in (16, 32))
    common = {(8, 8), (16, 8), (32, 8), (32, 16), (32, 32), (64, 64)}
    return not (EG <= 0 or EG > gpt or ((EG * gsz) % 64 and EG != gpt) or NG < nu
                or not ((EG, NG) in common or rare or direct)
                or (direct and (NG != 64 or lu != 0)) or (dglob and gpt % 16))


@pytest.mark.parametrize("bn", [64, 96, 128, 160, 192, 224, 288, 320, 384, 480, 512, 768])
def test_parts_shapes_refuse_what_the_launch_refuses(bn):
    """Every group count of every tile height: `_parts_shapes` raises its
    shape error exactly where no layout gets the launch's group checks to
    pass (`_launch_takes`), and where it does not raise, the plan's
    layout passes them: no shape reaches the launch and fails there."""
    for gpt in [d for d in range(1, bn + 1) if bn % d == 0]:
        args, lrr = _rr_operands(np.random.default_rng(gpt), Bp=128, T=4, bn=bn, gpt=gpt)
        kw = dict(sem_d=256, bm=128, bn=bn, gpt=gpt, geo=False, lrr=lrr, lr=True, sel=False)
        try:
            sh = th._parts_shapes(*args, **kw)
        except ValueError as e:
            assert "unsupported shapes" in str(e)
            assert not any(_launch_takes(bn, gpt, d, g) for d in (False, True)
                           for g in (False, True)), (bn, gpt)
            continue
        plan = th._parts_plan(1024, 8, bn, gpt, sh["kf"], sh["gwe"], sh["share"], 128,
                              sh["acols"], sh["out_w"])
        assert _launch_takes(bn, gpt, plan.direct, plan.dglob), (bn, gpt)


# ---- the segmented arithmetic in plain PyTorch


def _segmented_plain(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, *, n_seg, bm, dedup_pad=False,
                     **kw):
    """The kernel's arithmetic over n_seg segments: for each 64-query block,
    its list's distinct entries (dedup_pad: an entry equal to the one before
    it in its row dropped, across segment boundaries too) split as the
    kernel splits them, each segment's partial the plain version over its
    tiles (a segment with no tile writes zeros), the partials added in
    segment order 0, 1, ..."""
    Bp = q_cat.shape[0]
    out = None
    for s in range(n_seg):
        part = []
        for b in range(Bp // 64):
            row = idx[b * 64 // bm].numpy()
            distinct = _distinct(row) if dedup_pad else row
            lo, hi = _split(len(distinct), n_seg)[s]
            q = q_cat[b * 64:(b + 1) * 64]
            if hi == lo:
                width = th._hier_parts_family_plain(q, k_cat, mask_neg, idx[:1, :1], g_cat, g_vw,
                                                    z, bm=64, **kw).shape[1]
                part.append(torch.zeros(64, width))
                continue
            seg_idx = torch.from_numpy(np.ascontiguousarray(distinct[None, lo:hi]))
            part.append(th._hier_parts_family_plain(q, k_cat, mask_neg, seg_idx, g_cat, g_vw, z,
                                                    bm=64, **kw))
        part = torch.cat(part)
        out = part if out is None else out + part
    return out


def _np(x):
    return np.asarray(x).astype(np.float32)


def _t(x):
    return _tensor(np.asarray(x))


def _within_terms(got, ref, mag, frac=4e-3):
    """`tests/test_torch_hier.py::_within_terms`: the logits agree to f32
    summation order, so bf16(p) or D = bf16(e - ps / cnt) can land one ulp
    the other way: each element within min(frac x its row's max |ref|,
    2^-7 x its sum of |terms|) + 1e-6."""
    err = np.abs(got - ref)
    tol = np.minimum(frac * np.abs(ref).max(axis=1, keepdims=True), 2.0 ** -7 * mag) + 1e-6
    assert (err <= tol).all(), float((err / tol).max())


def _selections(packed, k_s=8, k_g=4):  # noqa: F811
    m_s, s_s, m_g, s_g, _ = packed["scan"]
    sel = dict(t_real=24, bm=128, n_valid=B, mode="range")
    idx_s, _ = jh.select_tiles(m_s, s_s, m_g, s_g, k_tiles=k_s, j_sem=3, j_geo=2, **sel)
    idx_g, _ = jh.select_tiles(m_g, s_g, m_s, s_s, k_tiles=k_g, j_sem=2, j_geo=3, **sel)
    return idx_s, idx_g


FORMS = ["rrlr_sem", "rrlr_geo", "rr_sem", "rr_geo", "sel", "dedup_sem", "dedup_geo"]


def _form(form, packed, jhb, thb):  # noqa: F811
    """Both packages' operands and keywords of one rr form on the test bank
    (8 groups a tile of 128 rows, Dv 128): the JAX call's (its arrays) and
    the port's (tensors), and the bm of the lists."""
    geo = form.endswith("geo")
    idx_s, idx_g = _selections(packed)
    idx = idx_g if geo else idx_s
    q = packed["q_cat"]
    bm, dedup, sel = 128, form.startswith("dedup"), form == "sel"
    g_j, g_t = (jhb.g_geo_cat, thb.g_geo_cat) if geo else (jhb.g_sem_cat, thb.g_sem_cat)
    if sel:  # a rank-64 sketch: its query columns appended past the keys'
        rng = np.random.default_rng(7)
        p = rng.standard_normal((64, 256)).astype(np.float32) / 16
        qs = jnp.asarray(np.asarray(q[:, :256], np.float32) @ p.T).astype(q.dtype)
        q = jnp.concatenate([q, qs], 1)
        g_j = jnp.asarray(rng.standard_normal((jhb.g_sem_cat.shape[0], 64)).astype(np.float32)
                          * 0.2).astype(jnp.bfloat16)
        g_t = _t(g_j)
    if dedup:  # two blocks' lists merged (the second the first's tiles in
        # another order), the union's repeat padding in each row
        idx = np.asarray(idx)
        idx = np.stack([idx[0], np.roll(idx[0], 1)])
        idx = np.asarray(th._dedup_union(_t(idx).to(torch.int32), 2, 2 * idx.shape[1]))
        assert (idx[:, 1:] == idx[:, :-1]).sum() == idx.shape[1] // 2
        bm = 256
    lr = not form.startswith("rr_")
    if lr:
        vw_j, vw_t = ((jhb.g_geo_vw_lr, thb.g_geo_vw_lr) if geo
                      else (jhb.g_sem_vw_lr, thb.g_sem_vw_lr))
    else:
        vw_j, vw_t = (jhb.g_geo_vw, thb.g_geo_vw) if geo else (jhb.g_sem_vw, thb.g_sem_vw)
    z_j, z_t = (jhb.z_geo, thb.z_geo) if geo else (jhb.z_sem, thb.z_sem)
    jargs = (q, jhb.k_cat, jhb.values, None, jhb.mask_neg, jnp.asarray(idx), g_j, vw_j, z_j)
    jkw = dict(sem_d=256, bm=bm, bn=128, gpt=GPT, geo=geo, lr=lr, rr=1, lrr=128,
               dedup_pad=dedup, sel=sel)
    targs = (_t(q), thb.k_cat, thb.mask_neg, _t(idx).to(torch.int32), g_t, vw_t, z_t)
    tkw = dict(sem_d=256, bn=128, gpt=GPT, geo=geo, lrr=128, lr=lr, sel=sel)
    return jargs, jkw, targs, tkw, bm, dedup


@pytest.mark.parametrize("n_seg", [2, 3, 6])
@pytest.mark.parametrize("form", FORMS)
def test_segmented_plain_matches_one_pass(packed, jhb, thb, one_pass, form, n_seg):  # noqa: F811
    """Each rr form over several segments a list (6 a list: a tile each)
    against the one-pass plain version: the tiles are independent, so only
    the f32 additions re-associate: within 1e-5 of each element's sum of
    |terms| (a few roundings of the partial sums, each <= 2^-24 of it)."""
    _, _, targs, tkw, bm, dedup = _form(form, packed, jhb, thb)
    got = _segmented_plain(*targs, n_seg=n_seg, bm=bm, dedup_pad=dedup, **tkw)
    ref = one_pass(form, targs, bm, dedup, tkw)
    mag = one_pass(form, targs, bm, dedup, tkw, magnitude=True)
    assert got.shape == ref.shape
    assert ((got - ref).abs() <= 1e-5 * mag + 1e-30).all()


@pytest.fixture(scope="module")
def one_pass():
    """The one-pass plain version of an rr form and its terms' magnitudes,
    once a form: every segment count and the JAX check read the same
    ones."""
    cache = {}

    def get(form, targs, bm, dedup, tkw, magnitude=False):
        if (form, magnitude) not in cache:
            cache[form, magnitude] = th._hier_parts_family_plain(
                *targs, bm=bm, dedup_pad=dedup, magnitude=magnitude, **tkw)
        return cache[form, magnitude]
    return get


@pytest.mark.parametrize("form", FORMS)
def test_segmented_plain_matches_jax(packed, jhb, thb, one_pass, form):  # noqa: F811
    """The segmented arithmetic (the plan's cut of a 256-query batch, and 3
    segments a list) against JAX's kernel in interpret mode on the same
    operands, every output column by the terms rule (`_within_terms`)."""
    jargs, jkw, targs, tkw, bm, dedup = _form(form, packed, jhb, thb)
    want = _np(jh._hier_parts_family_call(*jargs, **jkw, interpret=True))
    sh = th._parts_shapes(*targs, bm=bm, **tkw,
                          geo_cols=9 if tkw["geo"] else None)
    plan = th._parts_plan(B, targs[3].shape[1], 128, GPT, sh["kf"], sh["gwe"], sh["share"],
                          128, sh["acols"], sh["out_w"])
    mag = one_pass(form, targs, bm, dedup, tkw, magnitude=True).numpy()
    for n_seg in sorted({plan.n_seg, 3}):
        got = _segmented_plain(*targs, n_seg=n_seg, bm=bm, dedup_pad=dedup, **tkw).numpy()
        assert got.shape == want.shape
        _within_terms(got, want, mag)


def test_dedup_repeat_across_a_segment_boundary_is_skipped(packed, jhb, thb):  # noqa: F811
    """A list whose repeat falls where a cut of the raw entries would start
    a segment ([a, b, c | c, d, e] in two): the repeat is dropped before
    the split, so the segments hold [a, b | c, d, e] and the answer is the
    one-pass plain version's over the list without the repeat; counting it
    again (the raw split) doubles that tile's term."""
    _, _, targs, tkw, _, _ = _form("rrlr_sem", packed, jhb, thb)
    idx = targs[3][:, :5]
    rep = torch.cat([idx[:, :3], idx[:, 2:3], idx[:, 3:5]], 1).contiguous()  # c repeated
    args = targs[:3] + (rep,) + targs[4:]
    got = _segmented_plain(*args, n_seg=2, bm=128, dedup_pad=True, **tkw)
    clean = th._hier_parts_family_plain(*targs[:3], idx.contiguous(), *targs[4:], bm=128,
                                        **tkw)
    mag = th._hier_parts_family_plain(*targs[:3], idx.contiguous(), *targs[4:], bm=128,
                                      magnitude=True, **tkw)
    assert ((got - clean).abs() <= 1e-5 * mag + 1e-30).all()
    raw = _segmented_plain(*args, n_seg=2, bm=128, dedup_pad=False, **tkw)
    assert not torch.allclose(raw, clean, rtol=1e-3, atol=1e-3)


def test_geo_family_over_its_first_k16_step(packed, thb):  # noqa: F811
    """On the built bank the geo block's columns past its 9 real ones are
    zeros (`pack_bank`), so the geo family's plain version over the first
    k16 step of its row and group logits (geo_cols=9: what the card's rr
    kernel reads) equals the one over all 128, up to the f32 summation
    order of the zero products (1e-6 of each element's terms)."""
    assert not thb.k_cat[:, 256 + 9:].any() and not thb.g_geo_cat[:, 9:].any()
    _, idx_g = _selections(packed)
    for lr, vw, lrr in ((True, thb.g_geo_vw_lr, 128), (False, thb.g_geo_vw, 128)):
        args = (_t(packed["q_cat"]), thb.k_cat, thb.mask_neg, _t(idx_g).to(torch.int32),
                thb.g_geo_cat, vw, thb.z_geo)
        kw = dict(sem_d=256, bm=128, bn=128, gpt=GPT, geo=True, lrr=lrr, lr=lr)
        full = th._hier_parts_family_plain(*args, **kw)
        cut = th._hier_parts_family_plain(*args, **kw, geo_cols=9)
        mag = th._hier_parts_family_plain(*args, **kw, magnitude=True)
        assert ((cut - full).abs() <= 1e-6 * mag + 1e-30).all()


# ---- a bank of groups of 4 rows: 128 groups a tile


@pytest.fixture(scope="module")
def gsz4(jbank, tmp_path_factory):  # noqa: F811
    """The test bank built by JAX at bn 512 with groups of 4 sem rows (128
    groups a tile), with and without the lr / rr / lr_geo knobs, and the
    port's load of each archive (the rows in JAX's order)."""
    out = {}
    for name, kw in (("defaults", {}), ("knobs", dict(lr_rank=128, res_rank=128, lr_geo=128))):
        jb = jh.build_hier_bank(jbank, bn=512, gsz_sem=4, gsz_geo=64, **kw)
        path = str(tmp_path_factory.mktemp("gsz4") / f"{name}.npz")
        jh.save_hier_bank(jb, path)
        out[name] = (jb, th.load_hier_bank(path, device="cpu"))
    assert out["defaults"][1].bn // out["defaults"][1].gsz_sem == 128
    return out


def _queries(jbank, seed):  # noqa: F811
    """B queries near 8 bank rows (`tests/test_torch_hier_plain.py`)."""
    rng = np.random.default_rng(seed)
    locs, keys = _np(jbank.locs_lonlat), _np(jbank.keys_sem)
    rows = np.repeat(rng.integers(0, 3000, 8), B // 8)
    ll = locs[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = keys[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
    return q, np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)


@pytest.mark.parametrize("bank,mode,k_geo", [("defaults", "range+", 0), ("defaults", "range", 0),
                                             ("knobs", "range+", 2)])
def test_gsz4_bank_serves_as_jax(jbank, gsz4, bank, mode, k_geo):  # noqa: F811
    """`retrieve_hier` over the 128-groups-a-tile bank: at the defaults the
    merged branch (kernel 15's plain variant at gpt 128), with the knobs
    the family split (kernel 14's rr + lr shape at gpt 128): JAX's answer
    within 2e-4, as `tests/test_torch_hier_plain.py` holds each bank."""
    jb, tb = gsz4[bank]
    q, x = _queries(jbank, seed=3)
    xs = None if mode == "range" else x
    kw = dict(mode=mode, k_tiles=4, k_geo=k_geo, bm=128, j_sem=3,
              sem_temp=15.0 if mode == "range" else 12.0)
    want = _np(jh.retrieve_hier(jnp.asarray(q), None if xs is None else jnp.asarray(xs), jb,
                                concat_query=jnp.asarray(q), interpret=True, **kw))
    got = th.retrieve_hier(_t(q), None if xs is None else _t(xs), tb, concat_query=_t(q),
                           **kw).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_gsz4_parts_plain_match_jax(jbank, gsz4):  # noqa: F811
    """The parts kernels' plain versions at 128 groups a tile against JAX's
    kernels in interpret mode: the merged one (kernel 15, lr off) and the
    family one's rr + lr shape, the latter also over segments."""
    q, x = _queries(jbank, seed=4)
    from range_tpu.ops.retrieval_pallas import pack_queries as jax_pack_queries
    jb, tb = gsz4["knobs"]
    q_cat = jax_pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier="fast")
    stats = jh._hier_scan_stats_call(q_cat, jb.g_sem_cat, jb.g_geo_cat, bm=128, tc=4,
                                     gpt_s=128, gpt_g=8, interpret=True)
    idx, _ = jh.select_tiles(*stats, t_real=jb.t_real, k_tiles=4, bm=128, n_valid=B, j_sem=3,
                             j_geo=2, mode="range")
    jd, td = gsz4["defaults"]
    margs_j = (q_cat, jd.k_cat, jd.values, None, jd.mask_neg, idx, jd.g_sem_cat, jd.g_geo_cat,
               jd.g_sem_vw, jd.g_geo_vw)
    want = _np(jh._hier_parts_call(*margs_j, sem_d=256, bm=128, bn=512, gpt_s=128, gpt_g=8,
                                   interpret=True))
    margs_t = (_t(q_cat), td.k_cat, td.values, None, td.mask_neg, _t(idx).to(torch.int32),
               td.g_sem_cat, td.g_geo_cat, td.g_sem_vw, td.g_geo_vw)
    mkw = dict(sem_d=256, bm=128, bn=512, gpt_s=128, gpt_g=8, lr=False)
    got = th._hier_parts_plain(*margs_t, **mkw).numpy()
    mag = th._hier_parts_plain(*margs_t, **mkw, magnitude=True).numpy()
    _within_terms(got, want, mag)
    want = _np(jh._hier_parts_family_call(q_cat, jb.k_cat, jb.values, None, jb.mask_neg, idx,
                                          jb.g_sem_cat, jb.g_sem_vw_lr, jb.z_sem, sem_d=256,
                                          bm=128, bn=512, gpt=128, lr=True, rr=1, lrr=128,
                                          interpret=True))
    targs = (_t(q_cat), tb.k_cat, tb.mask_neg, _t(idx).to(torch.int32), tb.g_sem_cat,
             tb.g_sem_vw_lr, tb.z_sem)
    tkw = dict(sem_d=256, bn=512, gpt=128, geo=False, lrr=128, lr=True)
    mag = th._hier_parts_family_plain(*targs, bm=128, magnitude=True, **tkw).numpy()
    for n_seg in (1, 2, 4):
        _within_terms(_segmented_plain(*targs, n_seg=n_seg, bm=128, **tkw).numpy(), want, mag)


# ---- a bank of tiles of no whole number of 64-row steps, through load_model


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
def test_bn96_gsz12_bank_serves_through_load_model_as_jax(tmp_path, name):
    """96-row tiles of 12-row groups in both families (8 a tile: a masked
    last step on the card) with lr / rr / lr_geo, so RANGE+ takes kernel
    14's rr + lr shape for both families: JAX builds the bank and saves its
    hier cache, the port's `load_model(retrieval="hier", device="cpu")`
    loads that archive (the build signatures are equal) and answers as
    JAX's `load_model` does, the tower's weights carried across.
    Tolerance: the kernels' row cap, 4e-3 x row max, on every element (a
    bf16-rounded weight that the f32 summation order moves across a
    rounding boundary moves its row by one ulp of that term: RANGE's
    sharper softmax shows a few such rows at ~1.4e-3 x row max), and a
    mean error of f32 summation order (< 1e-5 on outputs ~0.3)."""
    import range_tpu
    from range_tpu.bank.bank import GeoBank as JaxGeoBank
    from range_tpu_torch import load_model
    from range_tpu_torch.convert.from_jax import geobank_from_arrays, siren_params_from_jax

    jb = JaxGeoBank.synthetic_informative(5, 3000, key_dim=256, value_dim=128, pad_to=96,
                                          value_dtype=jnp.bfloat16)
    kw = dict(retrieval="hier", hier_bn=96, gsz_sem=12, gsz_geo=12, lr_rank=128, lr_geo=128,
              res_rank=128, k_tiles=8, k_geo=4, hier_cache=str(tmp_path / "hb.npz"),
              chunk=512, seed=0)
    jenc = range_tpu.load_model(name, db_path=jb, **kw)
    enc = load_model(name, db_path=geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem,
                                                       jb.values, jb.n_valid),
                     device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    hb = enc.model.bank
    assert (hb.bn, hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo) == (96, 8, 8)
    rng = np.random.default_rng(7)
    rows = np.repeat(rng.integers(0, 3000, 8), 32)
    c = np.asarray(jb.locs_lonlat)[rows] + rng.normal(0, 3.0, (256, 2))
    c[:, 0] = (c[:, 0] + 180) % 360 - 180
    c[:, 1] = np.clip(c[:, 1], -89.9, 89.9)
    c = c.astype(np.float32)
    want = np.asarray(jenc(jnp.asarray(c)))
    got = enc(c).numpy()
    assert got.shape == want.shape == (256, 384) and np.isfinite(got).all()
    err = np.abs(got - want)
    assert np.all(err <= 4e-3 * np.abs(want).max(axis=1, keepdims=True)), err.max()
    assert err.mean() < 1e-5


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
def test_bn288_gsz3_bank_serves_through_load_model_as_jax(tmp_path, name):
    """288-row tiles of 3-row sem groups (96 a tile: two chunks, the last
    of 32 groups ending in a masked last step on the card) and 36-row geo
    groups (8 a tile), with lr / rr / lr_geo: JAX builds the bank and saves
    its hier cache, the port's `load_model(retrieval="hier", device="cpu")`
    loads that archive and answers as JAX's `load_model` does, the tower's
    weights carried across.  Tolerance as the bn 96 bank's above."""
    import range_tpu
    from range_tpu.bank.bank import GeoBank as JaxGeoBank
    from range_tpu_torch import load_model
    from range_tpu_torch.convert.from_jax import geobank_from_arrays, siren_params_from_jax

    jb = JaxGeoBank.synthetic_informative(5, 3000, key_dim=256, value_dim=128, pad_to=288,
                                          value_dtype=jnp.bfloat16)
    kw = dict(retrieval="hier", hier_bn=288, gsz_sem=3, gsz_geo=36, lr_rank=128, lr_geo=128,
              res_rank=128, k_tiles=6, k_geo=3, hier_cache=str(tmp_path / "hb.npz"),
              chunk=512, seed=0)
    jenc = range_tpu.load_model(name, db_path=jb, **kw)
    enc = load_model(name, db_path=geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem,
                                                       jb.values, jb.n_valid),
                     device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    hb = enc.model.bank
    assert (hb.bn, hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo) == (288, 96, 8)
    rng = np.random.default_rng(11)
    rows = np.repeat(rng.integers(0, 3000, 8), 32)
    c = np.asarray(jb.locs_lonlat)[rows] + rng.normal(0, 3.0, (256, 2))
    c[:, 0] = (c[:, 0] + 180) % 360 - 180
    c[:, 1] = np.clip(c[:, 1], -89.9, 89.9)
    c = c.astype(np.float32)
    want = np.asarray(jenc(jnp.asarray(c)))
    got = enc(c).numpy()
    assert got.shape == want.shape == (256, 384) and np.isfinite(got).all()
    err = np.abs(got - want)
    assert np.all(err <= 4e-3 * np.abs(want).max(axis=1, keepdims=True)), err.max()
    assert err.mean() < 1e-5
