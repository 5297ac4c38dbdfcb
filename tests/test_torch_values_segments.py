"""The Python around the Hopper values kernel (`csrc/hier_parts_sm90.cu`:
kernel 15, the merged parts kernel, and kernel 14's value shapes on one
body): its plan (`_values_plan`: 64 or 128 queries a block, segments of
each block's tile list, the ring), its walk of a tile's groups in chunks
of 64 (`_values_chunks`: the last chunk what is left, box rows past it
zeroed), the alr blocks' column split (`_alr_slices`), and a plain version
of its segmented arithmetic (each segment's partial over its share of the
block's distinct list entries, the partials added in segment order) in
every form: the merged launch (lr or plain sem groups, with and without
the geo family), the family launch (plain or lr, sem or geo, sel,
dedup_pad), bf16 values and int8 codes; held against the one-pass plain
version and against JAX's `_hier_parts_call` / `_hier_parts_family_call`
in interpret mode on the banks of tests/test_torch_hier.py (and their
int8 quantization).  Inputs are made from numpy seeds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import GPT, KW, B, archive, jbank, jhb, packed, thb  # noqa: F401

from range_tpu.bank.bank import quantize_values as jax_quantize
from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.convert.from_jax import _tensor
from range_tpu_torch.ops import retrieval_hier as th

SMEM = 232_448  # a block's shared memory on the card
Dv = 128


def _np(x):
    return np.asarray(x).astype(np.float32)


def _t(x):
    return _tensor(np.asarray(x))


def _split(n: int, n_seg: int):
    """The kernel's split of a block's n distinct entries: segment s takes
    [s n / n_seg, (s + 1) n / n_seg)."""
    return [(s * n // n_seg, (s + 1) * n // n_seg) for s in range(n_seg)]


def _distinct(row):
    keep = np.ones(len(row), bool)
    keep[1:] = row[1:] != row[:-1]
    return row[keep]


# ---- the plan

# (K, bn, bm, Dv, Wa, two, kb, kbs, kbg, has_kg, egmax) of each values
# launch the paths make on the 100,000-row bank: RANGE's flagship merged
# launch (lr, no geo: 32 tiles, groups of 16 rows, 256 alr columns), the
# same with its geo family (chip_smoke holds it), RANGE+ at the JAX
# defaults (plain, both families: 16 tiles, 64 sem and 8 geo groups a
# tile), the two-level feature path's (48 tiles of 64 groups), the knob
# banks' family launches (lr sem and geo with 256 / 384 alr columns,
# plain, sel over 64 sketch columns, dedup's merged lists of 2 x 32), and
# the gsz_sem=4 bank's 128 groups a tile
SHAPES = {
    "range_flagship": (32, 512, 128, 1024, 256, False, 4, 0, 4, False, 32),
    "range_flagship_geo": (32, 512, 128, 1024, 256, True, 4, 0, 4, True, 32),
    "defaults": (16, 512, 128, 1024, 0, True, 4, 0, 4, True, 64),
    "two_level": (48, 512, 128, 1024, 0, True, 4, 0, 4, True, 64),
    "family_lr_sem": (32, 512, 128, 1024, 256, False, 4, 0, 4, False, 32),
    "family_lr_geo": (16, 512, 128, 1024, 384, False, 0, 0, 0, True, 16),
    "family_plain_sem": (32, 512, 128, 1024, 0, False, 4, 0, 4, False, 32),
    "family_plain_geo": (16, 512, 128, 1024, 0, False, 0, 0, 0, True, 16),
    "sel": (32, 512, 128, 1024, 256, False, 4, 1, 1, False, 32),
    "dedup": (64, 512, 256, 1024, 256, False, 4, 0, 4, False, 32),
    "gsz4": (16, 512, 128, 1024, 0, True, 4, 0, 4, True, 64),
}
# padded batches: B = 1 and 37 (one 128-query block), 1,000, 10,000; the
# rescue's re-run (384 queries in blocks of 128)
BATCHES = [128, 1024, 10_112, 384]


def _plan(Bp, shape):
    K, bn, bm, Dv_, Wa, two, kb, kbs, kbg, has_kg, egmax = SHAPES[shape]
    Bp = max(Bp, bm) // bm * bm
    return Bp, th._values_plan(Bp, K, bn, bm, Dv_, Wa, two, kb, kbs, kbg, has_kg, egmax)


@pytest.mark.parametrize("Bp", BATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_values_plan_covers_every_entry_once(shape, Bp):
    """Lists with dedup_pad repeats (numpy seeds): each block's distinct
    entries fall in exactly one segment each, in list order, no segment
    over PARTS_ROWS_MAX rows; the block's shared memory within the card's
    232,448 bytes, 128 queries a block only for one-family launches whose
    bm it divides."""
    K, bn, bm, Dv_, Wa, two, kb, kbs, kbg, has_kg, egmax = SHAPES[shape]
    Bp, plan = _plan(Bp, shape)
    assert 1 <= plan.n_seg <= K and plan.S in (2, 3, 4) and plan.bmb in (64, 128)
    assert plan.bmb == 64 or (not two and bm % 128 == 0)
    assert -(-K // plan.n_seg) * bn <= th.PARTS_ROWS_MAX
    lay = th._values_layout(K, plan.bmb, kb, kbs, kbg, has_kg, egmax, plan.S)
    assert lay.total <= SMEM
    rng = np.random.default_rng(Bp + K)
    for _ in range(8):
        row = np.sort(rng.permutation(400)[:K])
        row[rng.random(K) < 0.3] = -1  # repeats of the entry before
        row = np.maximum.accumulate(row)
        distinct = _distinct(row)
        segs = [distinct[lo:hi] for lo, hi in _split(len(distinct), plan.n_seg)]
        assert all(len(s) * bn <= th.PARTS_ROWS_MAX for s in segs)
        assert np.array_equal(np.concatenate(segs), distinct)


@pytest.mark.parametrize("Bp", BATCHES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_values_plan_fills_the_card(shape, Bp):
    """Every SM gets a block wherever the lists allow it: a block a value
    slice (ceil(Dv / 256)) and an alr slice (ceil(Wa / 256)) of every
    query block and segment."""
    K, bn, bm, Dv_, Wa, *_ = SHAPES[shape]
    Bp, plan = _plan(Bp, shape)
    slices = -(-Dv_ // 256) + -(-Wa // 256)
    blocks = Bp // plan.bmb * slices
    assert blocks * plan.n_seg >= min(th.SM90_SMS, blocks * K)


def test_values_plan_splits_the_flagship_list():
    """RANGE's flagship lists (32 tiles of 512 rows, 16,384 rows) exceed
    one chain: two segments at least, 128 queries a block."""
    _, plan = _plan(10_112, "range_flagship")
    assert plan.n_seg >= 2 and plan.bmb == 128


def test_values_plan_is_a_function_of_the_shape():
    args = (10_112,) + SHAPES["range_flagship"]
    a = th._values_plan(*args)
    th._values_plan.cache_clear()
    assert th._values_plan(*args) == a
    assert th._values_plan(128, *args[1:]) != a  # the batch changes the cut
    tight = th._values_plan(*args, rows_max=2048)
    assert -(-32 // tight.n_seg) * 512 <= 2048 and tight.n_seg > a.n_seg


def test_values_plan_raises_what_no_block_holds():
    """A tile list of 40,000 entries (160 KB in shared memory) leaves no
    room for two stages beside it, even with 4 query boxes resident: the
    plan raises its shape error.  (12 boxes, the `high` tier's 768
    columns, fit since the deep chains' passes, and 24, 1,536 columns,
    since the passes past the resident boxes stream theirs.)"""
    with pytest.raises(ValueError, match="unsupported shapes"):
        th._values_plan(1024, 40_000, 512, 128, 1024, 0, True, 24, 0, 24, True, 64)
    assert th._values_plan(1024, 16, 512, 128, 1024, 0, True, 12, 0, 12, True, 64).bmb == 64
    assert th._values_plan(1024, 16, 512, 128, 1024, 0, True, 24, 0, 24, True, 64).qres < 24


# ---- a tile's groups, chunk by chunk


def _values_chunks(gpt: int):
    """A tile's chunks in the kernel's walk (`csrc/hier_parts_sm90.cu`:
    chunks = ceil(gpt / 64), each of 64 groups but the last, which holds
    what is left, its centroid box `_values_eg(gpt)` rows): (first group,
    groups, box rows) of each."""
    n = -(-gpt // 64)
    return [(64 * c, min(64, gpt - 64 * c), th._values_eg(gpt)) for c in range(n)]


def _alr_slices(W: int):
    """The alr blocks' columns (the kernel's `c0` of block y past the value
    slices): [a, min(a + 256, W)) for a = 0, 256, ..."""
    return [(a, min(a + 256, W)) for a in range(0, W, 256)]

GPTS = [1, 4, 8, 16, 24, 32, 64, 96, 128, 160, 224, 256, 384, 512]


@pytest.mark.parametrize("gpt", GPTS)
def test_values_chunk_walk_covers_each_group_once(gpt):
    """The kernel's walk of a tile's gpt groups (`_values_chunks`): every
    group in exactly one chunk,
    in order, each chunk's groups within its centroid box (16, 32 or 64
    rows: a wgmma N)."""
    chunks = _values_chunks(gpt)
    assert len(chunks) == -(-gpt // 64)
    seen = []
    for c, (first, n, rows) in enumerate(chunks):
        assert first == 64 * c and rows in (16, 32, 64) and n <= rows
        assert n == (64 if c + 1 < len(chunks) else gpt - 64 * (len(chunks) - 1))
        seen += list(range(first, first + n))
    assert seen == list(range(gpt))
    assert chunks[0][2] == th._values_eg(gpt)


@pytest.mark.parametrize("gpt", GPTS)
def test_values_chunk_walk_replays_the_approximation(gpt):
    """The chunk walk's arithmetic replayed on random operands (numpy
    seeds): each chunk's box rows read from the tile's first group on
    (rows past the tile's groups are the next tile's, rows past the bank
    TMA's zeros), e = exp2(min(q . g, 86)) over them, zero past the
    chunk's groups, bf16, times the box's vw rows, the chunks' products
    added in order; against bf16(e) @ vw over the tile's groups: within
    1e-6 of the sum of |terms| (only the f32 additions re-associate)."""
    rng = np.random.default_rng(gpt)
    T, Bq, gk, W = 3, 16, 64, 40
    G = T * gpt
    q = torch.from_numpy(rng.standard_normal((Bq, gk)).astype(np.float32) * 0.3)
    g = torch.from_numpy(rng.standard_normal((G, gk)).astype(np.float32) * 0.3)
    vw = torch.from_numpy(rng.standard_normal((G, W)).astype(np.float32))

    def rows(t, a, b):  # the box rows [a, b) of tile t's groups, zeros past the bank
        lo, hi = t * gpt + a, min(t * gpt + b, G)
        pad = t * gpt + b - hi
        return (torch.cat([g[lo:hi], torch.zeros(pad, gk)]),
                torch.cat([vw[lo:hi], torch.zeros(pad, W)]))

    for t in range(T):
        want = (torch.exp2(torch.clamp_max(q @ g[t * gpt:(t + 1) * gpt].T, 86.0))
                .bfloat16().float() @ vw[t * gpt:(t + 1) * gpt])
        mag = (torch.exp2(torch.clamp_max(q @ g[t * gpt:(t + 1) * gpt].T, 86.0))
               .bfloat16().float() @ vw[t * gpt:(t + 1) * gpt].abs())
        got = torch.zeros(Bq, W)
        for first, n, box in _values_chunks(gpt):
            gb, vb = rows(t, first, first + box)
            e = torch.exp2(torch.clamp_max(q @ gb.T, 86.0))
            e[:, n:] = 0
            got += e.bfloat16().float() @ vb
        assert ((got - want).abs() <= 1e-6 * mag + 1e-30).all()


@pytest.mark.parametrize("W", [128, 256, 384, 512])
def test_alr_column_split_sums_to_the_plain_alr(packed, thb, W):  # noqa: F811
    """The alr blocks' slices (`_alr_slices`: 256 columns each) tile alr's
    W columns exactly once, and each slice's product over the segments of
    the list, set side by side, is the plain version's alr within 1e-5 of
    the sum of |terms|."""
    slices = _alr_slices(W)
    assert [a for a, _ in slices] == list(range(0, W, 256))
    assert slices[-1][1] == W and all(b - a <= 256 for a, b in slices)
    rng = np.random.default_rng(W)
    vw = _t(rng.standard_normal((thb.g_sem_vw_lr.shape[0], W)).astype(np.float32)).bfloat16()
    idx_s, _ = _selections(packed)
    args = list(_merged_args(packed, thb, lr=True))
    args[8] = vw
    kw = dict(sem_d=256, bn=128, gpt_s=GPT, gpt_g=GPT, geo=False, lr=True)
    ref = th._hier_parts_plain(*args, bm=128, **kw)[:, 2 * Dv + 128:]
    mag = th._hier_parts_plain(*args, bm=128, **kw, magnitude=True)[:, 2 * Dv + 128:]
    got = torch.cat([_segmented(th._hier_parts_plain, args, 5, kw, n_seg=3, bm=128)
                     [:, 2 * Dv + 128 + a:2 * Dv + 128 + b] for a, b in slices], 1)
    assert ((got - ref).abs() <= 1e-5 * mag + 1e-30).all()


# ---- the segmented arithmetic in plain PyTorch


def _segmented(plain, args, pos, kw, *, n_seg, bm, dedup_pad=False):
    """The kernel's arithmetic over n_seg segments: for each bm-query block,
    its list's distinct entries (dedup_pad: an entry equal to the one before
    it in its row dropped, across segment boundaries too) split as the
    kernel splits them, each segment's partial the plain version over its
    tiles (``args[pos]`` the list; a segment with no tile writes zeros), the
    partials added in segment order 0, 1, ..."""
    q_cat, idx = args[0], args[pos]
    Bp = q_cat.shape[0]
    kw = {k: v for k, v in kw.items() if k != "dedup_pad"}
    out = None
    for s in range(n_seg):
        part = []
        for b in range(Bp // bm):
            row = idx[b].numpy()
            distinct = _distinct(row) if dedup_pad else row
            lo, hi = _split(len(distinct), n_seg)[s]
            a = list(args)
            a[0] = q_cat[b * bm:(b + 1) * bm]
            part_idx = distinct[lo:hi] if hi > lo else distinct[:1]  # (its shape alone)
            a[pos] = torch.from_numpy(np.ascontiguousarray(part_idx[None]))
            seg = plain(*a, bm=bm, **kw)
            part.append(seg if hi > lo else torch.zeros_like(seg))
        part = torch.cat(part)
        out = part if out is None else out + part
    return out


def _within_terms(got, ref, mag, frac=4e-3):
    """`tests/test_torch_hier.py::_within_terms`: each element within
    min(frac x its row's max |ref|, 2^-7 x its sum of |terms|) + 1e-6."""
    err = np.abs(got - ref)
    tol = np.minimum(frac * np.abs(ref).max(axis=1, keepdims=True), 2.0 ** -7 * mag) + 1e-6
    assert (err <= tol).all(), float((err / tol).max())


def _selections(packed, k_s=8, k_g=4):  # noqa: F811
    m_s, s_s, m_g, s_g, _ = packed["scan"]
    sel = dict(t_real=24, bm=128, n_valid=B, mode="range")
    idx_s, _ = jh.select_tiles(m_s, s_s, m_g, s_g, k_tiles=k_s, j_sem=3, j_geo=2, **sel)
    idx_g, _ = jh.select_tiles(m_g, s_g, m_s, s_s, k_tiles=k_g, j_sem=2, j_geo=3, **sel)
    return idx_s, idx_g


@pytest.fixture(scope="module")
def banks8(jbank, tmp_path_factory):  # noqa: F811
    """The test bank's int8 quantization built by JAX, and the port's load
    of its archive (the rows in JAX's order)."""
    jb = jh.build_hier_bank(jax_quantize(jbank), **KW)
    path = str(tmp_path_factory.mktemp("hier8") / "jax_hb8.npz")
    jh.save_hier_bank(jb, path)
    return jb, th.load_hier_bank(path, device="cpu")


def _merged_args(packed, hb, lr, idx=None):  # noqa: F811
    if idx is None:
        idx = _selections(packed)[0]
    return (_t(packed["q_cat"]), hb.k_cat, hb.values, hb.value_scale, hb.mask_neg,
            _t(idx).to(torch.int32), hb.g_sem_cat, hb.g_geo_cat,
            hb.g_sem_vw_lr if lr else hb.g_sem_vw, hb.g_geo_vw)


MERGED = [f"{v}_{g}_{q}" for v in ("lr", "plain") for g in ("geo", "nogeo")
          for q in ("bf16", "int8")]
FAMILY = ([f"{v}_{f}_{q}" for v in ("lr", "plain") for f in ("sem", "geo")
           for q in ("bf16", "int8")] + ["sel_lr", "sel_plain", "dedup_lr", "dedup_plain"])


def _merged_form(form, packed, jhb, thb, banks8):  # noqa: F811
    lr, geo, i8 = form.startswith("lr"), "_geo_" in form, form.endswith("int8")
    jb, tb = banks8 if i8 else (jhb, thb)
    idx = _selections(packed)[0]
    jargs = (packed["q_cat"], jb.k_cat, jb.values, jb.value_scale, jb.mask_neg, idx,
             jb.g_sem_cat, jb.g_geo_cat, jb.g_sem_vw_lr if lr else jb.g_sem_vw, jb.g_geo_vw)
    jkw = dict(sem_d=256, bm=128, bn=128, gpt_s=GPT, gpt_g=GPT, lr=lr)
    targs = _merged_args(packed, tb, lr, idx)
    tkw = dict(sem_d=256, bn=128, gpt_s=GPT, gpt_g=GPT, geo=geo, lr=lr)
    # the columns JAX computes that the launch writes (without geo its
    # columns are zeros, which RANGE mode never reads)
    cols = [slice(0, Dv), slice(2 * Dv, 2 * Dv + 1)] + (
        [slice(Dv, 2 * Dv), slice(2 * Dv + 1, 2 * Dv + 2)] if geo else []) + (
        [slice(2 * Dv + 128, None)] if lr else [])
    return jargs, jkw, targs, tkw, 128, False, cols


def _family_form(form, packed, jhb, thb, banks8):  # noqa: F811
    """Both packages' operands of one value shape (`tests/
    test_torch_parts_segments.py::_form` without z): sel over a rank-64
    sketch appended to the queries, dedup_pad over two blocks' merged
    lists (bm 256) with the union's repeats."""
    i8 = form.endswith("int8")
    jb, tb = banks8 if i8 else (jhb, thb)
    geo = "_geo" in form
    lr = "_lr" in form
    sel, dedup = form.startswith("sel"), form.startswith("dedup")
    idx_s, idx_g = _selections(packed)
    idx = idx_g if geo else idx_s
    q = packed["q_cat"]
    bm = 128
    g_j, g_t = (jb.g_geo_cat, tb.g_geo_cat) if geo else (jb.g_sem_cat, tb.g_sem_cat)
    if sel:
        rng = np.random.default_rng(7)
        p = rng.standard_normal((64, 256)).astype(np.float32) / 16
        qs = jnp.asarray(np.asarray(q[:, :256], np.float32) @ p.T).astype(q.dtype)
        q = jnp.concatenate([q, qs], 1)
        g_j = jnp.asarray(rng.standard_normal((jb.g_sem_cat.shape[0], 64)).astype(np.float32)
                          * 0.2).astype(jnp.bfloat16)
        g_t = _t(g_j)
    if dedup:
        idx = np.asarray(idx)
        idx = np.stack([idx[0], np.roll(idx[0], 1)])
        idx = np.asarray(th._dedup_union(_t(idx).to(torch.int32), 2, 2 * idx.shape[1]))
        assert (idx[:, 1:] == idx[:, :-1]).sum() == idx.shape[1] // 2
        bm = 256
    if lr:
        vw_j, vw_t = (jb.g_geo_vw_lr, tb.g_geo_vw_lr) if geo else (jb.g_sem_vw_lr, tb.g_sem_vw_lr)
    else:
        vw_j, vw_t = (jb.g_geo_vw, tb.g_geo_vw) if geo else (jb.g_sem_vw, tb.g_sem_vw)
    jargs = (q, jb.k_cat, jb.values, jb.value_scale, jb.mask_neg, jnp.asarray(idx), g_j, vw_j,
             None)
    jkw = dict(sem_d=256, bm=bm, bn=128, gpt=GPT, geo=geo, lr=lr, rr=0,
               lrr=vw_j.shape[1] if lr else Dv, dedup_pad=dedup, sel=sel)
    targs = (_t(q), tb.k_cat, tb.mask_neg, _t(idx).to(torch.int32), g_t, vw_t, None)
    tkw = dict(sem_d=256, bn=128, gpt=GPT, geo=geo, lrr=0, lr=lr, values=tb.values,
               scale=tb.value_scale, sel=sel, dedup_pad=dedup)
    cols = [slice(0, Dv + 1)] + ([slice(Dv + 128, None)] if lr else [])
    return jargs, jkw, targs, tkw, bm, dedup, cols


def _form(form, packed, jhb, thb, banks8):  # noqa: F811
    kind, rest = form.split(":")
    if kind == "merged":
        return (th._hier_parts_plain, 5) + _merged_form(rest, packed, jhb, thb, banks8)
    return (th._hier_parts_family_plain, 3) + _family_form(rest, packed, jhb, thb, banks8)


FORMS = [f"merged:{m}" for m in MERGED] + [f"family:{f}" for f in FAMILY]


@pytest.fixture(scope="module")
def one_pass():
    """The one-pass plain version of a form and its terms' magnitudes, once
    a form: every segment count and the JAX check read the same ones."""
    cache = {}

    def get(form, plain, targs, bm, tkw, magnitude=False):
        if (form, magnitude) not in cache:
            cache[form, magnitude] = plain(*targs, bm=bm, **tkw, magnitude=magnitude)
        return cache[form, magnitude]
    return get


@pytest.mark.parametrize("n_seg", [2, 3, 6])
@pytest.mark.parametrize("form", FORMS)
def test_segmented_plain_matches_one_pass(packed, jhb, thb, banks8, one_pass, form,  # noqa: F811
                                          n_seg):
    """Each form over several segments a list (6 a list: a tile or none
    each) against the one-pass plain version: the tiles are independent,
    so only the f32 additions re-associate: within 1e-5 of each element's
    sum of |terms|."""
    plain, pos, _, _, targs, tkw, bm, dedup, _ = _form(form, packed, jhb, thb, banks8)
    got = _segmented(plain, targs, pos, tkw, n_seg=n_seg, bm=bm, dedup_pad=dedup)
    ref = one_pass(form, plain, targs, bm, tkw)
    mag = one_pass(form, plain, targs, bm, tkw, magnitude=True)
    assert got.shape == ref.shape
    assert ((got - ref).abs() <= 1e-5 * mag + 1e-30).all()


@pytest.fixture(scope="module")
def jax_parts(packed, jhb, banks8):  # noqa: F811
    """JAX's kernels in interpret mode, once a form."""
    cache = {}

    def get(form, jargs, jkw):
        if form not in cache:
            call = jh._hier_parts_call if form.startswith("merged") else jh._hier_parts_family_call
            cache[form] = _np(call(*jargs, **jkw, interpret=True))
        return cache[form]
    return get


@pytest.mark.parametrize("form", FORMS)
def test_segmented_plain_matches_jax(packed, jhb, thb, banks8, jax_parts, one_pass,  # noqa: F811
                                     form):
    """The segmented arithmetic (the plan's cut of the 256-query batch,
    and 3 segments a list) against JAX's kernel in interpret mode on the
    same operands, every column the launch writes by the terms rule
    (`_within_terms`); columns past them are zeros."""
    plain, pos, jargs, jkw, targs, tkw, bm, dedup, cols = _form(form, packed, jhb, thb, banks8)
    want = jax_parts(form, jargs, jkw)
    mag = one_pass(form, plain, targs, bm, tkw, magnitude=True).numpy()
    K = targs[pos].shape[1]
    merged = form.startswith("merged")
    geo = tkw["geo"]
    lr = tkw["lr"]
    two = merged and geo
    kb, kbs = (0 if geo and not merged else 4), (1 if tkw.get("sel") else 0)
    kbg = 0 if geo and not merged else kbs or kb
    Wa = targs[8].shape[1] if merged and lr else (targs[5].shape[1] if lr and not merged else 0)
    plan = th._values_plan(B, K, 128, bm, Dv, Wa, two, kb, kbs, kbg, two or (geo and not merged),
                           16)
    written = np.zeros(want.shape[1], bool)
    for c in cols:
        written[c] = True
    for n_seg in sorted({plan.n_seg, 3}):
        got = _segmented(plain, targs, pos, tkw, n_seg=n_seg, bm=bm, dedup_pad=dedup).numpy()
        assert got.shape == want.shape
        for c in cols:
            _within_terms(got[:, c], want[:, c], mag[:, c])
        assert not got[:, ~written].any()
