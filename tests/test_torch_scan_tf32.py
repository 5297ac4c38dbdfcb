"""Kernels 8 and 9 on `csrc/hier_scan_tf32_sm90.cu`, on the CPU: the scan
where an operand is f32 (the `exact` tier) and the stats scan in every
form, every f32 product three TF32 products (bf16 logits one), a launch a
family over segments of whole tiles, 32 groups a step.

A CUDA kernel cannot run here, so the arithmetic is held through a plain
version of it that reads the very images the kernel copies
(`ops.retrieval_hier._scan_tf32_plain`): the same TF32 halves, the same
chunk and step order, each 32-deep chunk's products in a fresh fragment
truncated toward zero (`ops._prep.tf32x3_matmul`), the launch's segments
folded in order.  Against range_tpu's `_hier_scan_call` and
`_hier_scan_stats_call` in interpret mode, on a small numpy-seeded `exact`
bank (both families, ``has_geo=False``, the lr tails, the full-width tails
of three 128-column slices, the tail_super segment sums) and a `fast`
bank (the stats scan's bf16 form).  Also: the images read back to their
operands, a cancelling tail that one truncated chain misses and the steps
hold, the plan covers every tile once, and the shape check takes every
shape the CUDA-core and mma.sync bodies' checks took and refuses what the
launch refuses.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.convert.from_jax import _tensor
from range_tpu_torch.ops import _prep
from range_tpu_torch.ops import retrieval_fused as rf
from range_tpu_torch.ops import retrieval_hier as th

SMEM_MAX = 232_448  # a block's shared memory on sm_90
N, B, DV = 2048, 128, 320  # full-width tails: 384 columns, three slices of 128
GPT_S, GPT_G = 16, 8       # bn 128 / gsz_sem 8, bn 128 / gsz_geo 16


def _j(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _queries(jb, tier: str, seed: int):
    """B regional queries near four bank rows, packed for ``tier``."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(rng.integers(0, N, 4), B // 4)
    ll = np.asarray(jb.locs_lonlat, np.float32)[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = np.asarray(jb.keys_sem, np.float32)[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)
    return rf.pack_queries(_tensor(q), _tensor(x), 12.0, 40.0, tier)


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """An informative bank of 2,048 rows (256-d keys, 320-d values) and its
    JAX HierBanks, loaded by the port: at `exact` (bn 128, gsz_sem 8,
    gsz_geo 16, lr_rank and lr_geo 128, tail_super 32: sup_r 4) and at
    `fast` (no knobs); regional queries packed for each tier."""
    jb = JaxGeoBank.synthetic_informative(7, N, key_dim=256, value_dim=DV, pad_to=512,
                                          value_dtype=jnp.bfloat16)
    out = {}
    for tier, knobs in (("exact", dict(lr_rank=128, lr_geo=128, tail_super=32)), ("fast", {})):
        jhb = jh.build_hier_bank(jb, bn=128, gsz_sem=8, gsz_geo=16, tier=tier, **knobs)
        path = str(tmp_path_factory.mktemp("scan_tf32") / f"{tier}.npz")
        jh.save_hier_bank(jhb, path)
        out[tier] = (jhb, th.load_hier_bank(path, device="cpu"), _queries(jb, tier, 4))
    return out


def _scan_case(banks, form):
    """(the port's args and kw, JAX's operands) of one scan form."""
    jhb, thb, q_cat = banks["exact"]
    vw = {"flagship": ("g_sem_vw_lr", "g_geo_vw_lr"), "range": ("g_sem_vw_lr", "g_geo_vw_lr"),
          "wide": ("g_sem_vw", "g_geo_vw"), "tail_super": ("g_sem_ts_vw", "g_geo_vw_lr")}[form]
    args = (q_cat, thb.g_sem_cat, thb.g_geo_cat, getattr(thb, vw[0]), getattr(thb, vw[1]))
    kw = dict(gpt_s=GPT_S, gpt_g=GPT_G, has_geo=form != "range",
              sup_r=4 if form == "tail_super" else 0)
    jargs = (_j(q_cat), jhb.g_sem_cat, jhb.g_geo_cat, getattr(jhb, vw[0]), getattr(jhb, vw[1]))
    return args, kw, jargs


def _hold_stats(name, got, ref):
    """m within 1e-5 of max(|m|, 1), s within 1e-5 of s: f32 logits (three
    TF32 products a term, ~2^-21 of each) in another summation order, and
    f32 exp2 sums in another order."""
    for i, (a, b) in enumerate(zip(got, ref)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape and np.isfinite(a).all(), (name, i)
        bar = 1e-5 * (np.maximum(np.abs(b), 1.0) if i % 2 == 0 else np.abs(b))
        assert (np.abs(a - b) <= bar).all(), (name, i, (np.abs(a - b) / bar).max())


def _hold_tail(name, got, ref, mag):
    """The exact tier's bar (chip_smoke.py `_hold_cores`): 1e-4 x the sum of
    the terms' magnitudes + 1e-6 (f32 products; p moves by ~1e-5 of itself
    with the logits' summation order at |l| <= 86)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref)
    assert got.shape == ref.shape and np.isfinite(got).all(), name
    assert (err <= 1e-4 * mag + 1e-6).all(), (name, (err / (1e-4 * mag + 1e-6)).max())


@pytest.mark.parametrize("form", ["flagship", "range", "wide", "tail_super"])
def test_scan_tf32_matches_jax(banks, form):
    """`_scan_tf32_plain` against JAX's `_hier_scan_call` in interpret mode
    and the port's one-pass `_hier_scan_plain` at the `exact` tier: both
    families (lr tails of 256 columns), the sem family alone (RANGE), the
    full-width tails (384 columns: three slices, wider than a block's two),
    the tail_super bank's supergroup tail (sup_r 4, the f32 sum of each
    four groups' p)."""
    args, kw, jargs = _scan_case(banks, form)
    got = th._scan_tf32_plain(*args, **kw)
    ref = th._hier_scan_plain(*args, **kw)
    mag = th._hier_scan_plain(*args[:3], args[3].abs(), args[4].abs(), **kw)[4].numpy()
    want = jh._hier_scan_call(*jargs, bm=128, tc=4, gpt_s=GPT_S, gpt_g=GPT_G,
                              has_geo=kw["has_geo"], sup_r_s=kw["sup_r"], interpret=True)
    n_stats = 4 if kw["has_geo"] else 2
    Ws = args[3].shape[1]
    assert len(got) == n_stats + 1 and got[-1].shape == ref[4].shape
    _hold_stats(form, got[:n_stats], [r for r in ref[:4] if r is not None])
    _hold_stats(form + " vs JAX", got[:n_stats], [np.asarray(w) for w in want[:n_stats]])
    _hold_tail(form, got[-1], ref[4], mag)
    tails_j = np.asarray(want[4], np.float32)
    _hold_tail(form + " vs JAX", got[-1], tails_j if kw["has_geo"] else tails_j[:, :Ws],
               mag)


@pytest.mark.parametrize("tier", ["exact", "fast"])
def test_stats_tf32_matches_jax(banks, tier):
    """The stats scan on the new body's stats pass: at `exact` (f32: three
    TF32 products a term) and at `fast` (bf16 logits: one, exact products),
    `_scan_tf32_plain` without tails against JAX's `_hier_scan_stats_call`
    in interpret mode and the port's `_hier_scan_stats_plain`."""
    jhb, thb, q_cat = banks[tier]
    assert thb.g_sem_cat.dtype == (torch.float32 if tier == "exact" else torch.bfloat16)
    args = (q_cat, thb.g_sem_cat, thb.g_geo_cat)
    got = th._scan_tf32_plain(*args, None, None, gpt_s=GPT_S, gpt_g=GPT_G)
    fams = th._scan_tf32_fams(*args, None, None, gpt_s=GPT_S, gpt_g=GPT_G)
    assert [fm.lx3 for fm in fams] == [tier == "exact"] * 2 and not any(fm.W for fm in fams)
    _hold_stats(tier, got, th._hier_scan_stats_plain(*args, gpt_s=GPT_S, gpt_g=GPT_G))
    want = jh._hier_scan_stats_call(_j(q_cat), jhb.g_sem_cat, jhb.g_geo_cat, bm=128, tc=4,
                                    gpt_s=GPT_S, gpt_g=GPT_G, interpret=True)
    _hold_stats(tier + " vs JAX", got, [np.asarray(w) for w in want])


def test_scan_tf32_images_read_back(banks):
    """The images the launches copy read back to their operands: the sem
    centroids (every 32-column chunk split hi | lo, within 2^-22 of each
    value), the geo centroids over their nonzero columns alone (the exact
    tier packs 3 real ones in 128, one chunk), the value pass's image of
    the supergroup vw at each supergroup's first group (zeros between and
    past G, to whole tiles of 64), the queries' family columns zero past
    them and past the batch; each image built once a bank."""
    _, thb, q_cat = banks["exact"]
    args, kw, _ = _scan_case(banks, "tail_super")
    fs, fg = th._scan_tf32_fams(*args, **kw)
    assert (fs.gwe, fs.GC, fs.ng, fs.nblk, fs.KT, fs.sup, fs.W, fs.NS) == (
        256, 8, 64, 8, 8, 4, 256, 2)
    assert (fg.qg0, fg.gwe, fg.GC, fg.nblk, fg.KT, fg.oc0) == (
        q_cat.shape[1] - 128, 3, 1, 4, 4, 256)
    assert fs.lx3 and fs.tx3 and not fs.tbf16
    for fm, g, vw in ((fs, thb.g_sem_cat, thb.g_sem_ts_vw), (fg, thb.g_geo_cat,
                                                             thb.g_geo_vw_lr)):
        G = g.shape[0]
        gimg, vimg = th._scan_tf32_images(g, vw, fm)
        assert gimg is th._scan_tf32_images(g, vw, fm)[0]
        assert gimg.shape == (1, fm.nblk, fm.GC, 2, fm.ng, 32)
        hi, lo = (x.reshape(fm.nblk * fm.ng, -1) for x in _prep.kmajor_tf32_read(gimg[0]))
        assert torch.equal(hi, _prep.tf32_rna(hi)) and torch.equal(lo, _prep.tf32_rna(lo))
        ref = g[:, :fm.gwe].float()
        assert ((ref - hi[:G, :fm.gwe] - lo[:G, :fm.gwe]).abs() <= 2.0 ** -22 * ref.abs()).all()
        assert not g[:, fm.gwe:].any() and not hi[G:].any() and not hi[:, fm.gwe:].any()
        assert vimg.shape == (fm.KT, 1, 2, fm.NS, 2, 128, 32)
        vh, vl = (x.permute(0, 1, 4, 2, 3).reshape(fm.KT * 64, -1)
                  for x in _prep.kmajor_tf32_read(vimg.transpose(2, 3)))
        rows = torch.zeros(G, vw.shape[1])
        rows[::fm.sup] = vw.float()
        assert ((rows - vh[:G, :fm.W] - vl[:G, :fm.W]).abs() <= 2.0 ** -22 * rows.abs()).all()
        assert not vh[G:].any() and not vh[:, fm.W:].any()
        q = th._scan_tf32_query(q_cat[:100], fm, 128)
        assert q.shape == (128, 32 * fm.GC)
        assert torch.equal(q[:100, :fm.gwe], q_cat[:100, fm.qg0:fm.qg0 + fm.gwe])
        assert not q[100:].any() and not q[:, fm.gwe:].any()


def test_scan_tf32_chunks_hold_a_cancelling_tail():
    """The scan's tail over 7,168 groups (the flagship's sem family: 224
    tiles of 32) whose vw columns cancel against p: the value pass over D
    (each 32 groups' twelve TF32 products in a fresh fragment, added in
    f32; the segments folded in order) holds 1e-5 of each row's largest
    |tail| against the f64 product, where one truncated chain over every
    group misses it."""
    g = torch.Generator().manual_seed(2)
    G, T = 7168, 224
    q = torch.randn(4, 32, generator=g)
    cents = torch.randn(G, 32, generator=g) * 0.3
    p = torch.exp2(torch.clamp_max(q.double() @ cents.double().T, 86.0)).float()
    v = torch.rand(G, 128, generator=g) + 0.5
    w = p.double().mean(0)
    v = (v.double() - (w @ v.double()) / w.sum()).float()  # each column's p-weighted mean out
    args = (q, cents, torch.zeros(T * 8, 16), v, torch.zeros(T * 8, 128))
    kw = dict(gpt_s=G // T, gpt_g=8, has_geo=False)
    got = th._scan_tf32_plain(*args, **kw)[-1]
    lg = _prep.tf32x3_matmul(q, *(x.T for x in _prep.tf32_split(cents)), "exact")
    e = torch.exp2(torch.clamp_max(lg, 86.0))
    ref = e.double() @ v.double()
    bar = 1e-5 * ref.abs().amax(1, keepdim=True)
    assert ((got.double() - ref).abs() / bar).max().item() < 0.5
    one = _prep.tf32x3_matmul(e, *_prep.tf32_split(v), "rz")
    assert ((one.double() - ref).abs() / bar).max().item() > 1.0


@pytest.mark.parametrize("B", [1, 37, 1000, 10_000])
@pytest.mark.parametrize("shape", [(7168, 32, 384), (1792, 8, 512), (14336, 64, 1152),
                                   (14336, 64, 0), (1792, 8, 0), (40 * 96, 96, 256),
                                   (40 * 6, 6, 128)])
def test_scan_tf32_plan_covers_every_tile_once(shape, B):
    """The launches' plan (`_scan_tf32_plan`, `_scan_tf32_segments`) at the
    main paths' shapes (G groups, gpt, tail width; 0: the stats scan) and
    odd groupings: the batch padded to whole blocks of 128 queries, the
    kernel's segments (`segment` in tf32_sm90.cuh: tiles [T s / n, T (s +
    1) / n)) cover every tile once and each is non-empty, each segment's
    steps of 64 groups cover its groups, the value pass's segments of its
    KT tiles of 64 groups (the whole of D, every step's columns) are 1 ..
    KT, and a block's shared memory fits the card with at least 3 ring
    stages at every depth of 1 to 48 chunks."""
    G, gpt, W = shape
    T, ng = G // gpt, 64
    fm = th.ScanTf32Fam(0, 256, 8, gpt, T, ng, -(-G // ng), W, -(-W // 128), 0, 1,
                        -(-G // ng) * ng // 64, True, True, False)
    Bq, n, n_v = th._scan_tf32_plan(fm, B)
    assert Bq % 128 == 0 and Bq - B < 128
    assert 1 <= n <= T and (1 <= n_v <= fm.KT if W else n_v == 0)
    assert 64 * fm.KT >= G and 64 * fm.KT % ng == 0
    segs = [(T * s // n, T * (s + 1) // n) for s in range(n)]
    assert segs[0][0] == 0 and segs[-1][1] == T
    assert all(a < b for a, b in segs) and all(s[1] == t[0] for s, t in zip(segs, segs[1:]))
    for a, b in segs:
        steps = range(a * gpt // ng, -(-b * gpt // ng))
        covered = {c for st in steps for c in range(ng * st, ng * st + ng)}
        assert set(range(a * gpt, b * gpt)) <= covered
    for GC, g in itertools.product(range(1, 49), (gpt, 6)):
        total, nsk = th._scan_tf32_smem(GC, g)
        assert total <= SMEM_MAX and nsk >= 3, (GC, g, total, nsk)


def _launch_takes(fm, Bq: int, n_seg: int, n_v: int, tails: bool) -> bool:
    """The launches' conditions on the ints a family passes, written out:
    `hier_scan_tf32_launch`'s, and for the scan `hier_values_tf32_v_launch`'s
    (its value width Dv the tail's, made even: `_scan_tf32`)."""
    ok = (Bq > 0 and Bq % 128 == 0 and 1 <= fm.GC <= 48 and fm.gpt >= 1 and fm.T >= 1
          and 1 <= n_seg <= fm.T and 1 <= fm.sup <= 32 and 32 % fm.sup == 0
          and fm.gpt % fm.sup == 0 and th._scan_tf32_smem(fm.GC, fm.gpt)[0] <= SMEM_MAX
          and th._scan_tf32_smem(fm.GC, fm.gpt)[1] >= 3 and fm.ng == (64 if fm.lx3 else 128))
    if not tails:
        return ok and fm.sup == 1 and not fm.tbf16 and n_v == 0
    Dv = fm.W + fm.W % 2
    return (ok and 64 * fm.KT >= fm.T * fm.gpt and 64 * fm.KT % fm.ng == 0
            and fm.NS >= 1 and 128 * (fm.NS - 1) < Dv <= 128 * fm.NS and 1 <= n_v <= fm.KT
            and fm.tbf16 == (not fm.tx3))


def _old_takes(q, gs, gg, vs, vg, *, gpt_s, gpt_g, has_geo, sup_r) -> bool:
    """Whether the parent's wrappers served the shape on the card: the
    CUDA-core body's checks (`_scan_cores_shapes` + `_cores_fits`) for
    the scan's f32 form and for the stats scan at f32 or past the mma.sync
    stats kernel's shared memory; that kernel's checks below it."""
    tails = vs is not None
    depth = max(gs.shape[1], gg.shape[1] if has_geo else 0)
    f32 = any(t is not None and t.dtype == torch.float32 for t in (q, gs, gg, vs, vg))
    try:
        if not tails and not f32 and th._stats_smem(depth) <= th._SM90_MAX_SMEM:
            T = gs.shape[0] // gpt_s
            return not (not th._gpt_ok(gpt_s) or not th._gpt_ok(gpt_g) or gs.shape[0] != T * gpt_s
                        or gg.shape[0] != T * gpt_g or gs.shape[0] % 32 or gg.shape[0] % 32
                        or gs.shape[1] % 16 or gg.shape[1] % 16 or gs.shape[1] > q.shape[1]
                        or gg.shape[1] > q.shape[1] or q.shape[1] % 8)
        th._scan_cores_shapes(q, gs, gg, vs, vg, gpt_s=gpt_s, gpt_g=gpt_g,
                              has_geo=has_geo or not tails, sup_r=sup_r)
        for g, vw in ((gs, vs), (gg, vg)) if has_geo or not tails else ((gs, vs),):
            th._cores_fits("hier_groups", g.shape[1], q.dtype == g.dtype == torch.bfloat16,
                           tails and vw.dtype == torch.bfloat16, tails, 0)
    except ValueError:
        return False
    return True


def test_scan_tf32_shape_check_takes_what_served_and_refuses_what_the_launch_refuses():
    """Over logit depths of 16 to 1,600 columns, groups a tile of 1 to 160,
    f32 and bf16 logits and vw, supergroups of 0 to 16 (and 3), tails of 1
    to 1,152 columns, ± the geo family, the scan and the stats scan: every
    shape the parent served (`_old_takes`: the f32 scan up to ~450 f32 /
    ~1,024 bf16 logit columns, the stats scan up to 1,536 bf16 ones, any
    grouping, the odd groupings of bn 96 / gsz 12, 384 / 3, 288 / 3,
    96 / 1, 480 / 3) passes `_scan_tf32_fams`; whatever it passes the
    launch takes (`_launch_takes`, at the plan's batch and segments); and
    it raises on what the launch would refuse (logits over 1,536 columns,
    a supergroup that divides neither the step nor the tile)."""
    f32, bf = torch.float32, torch.bfloat16
    T, served = 3, 0
    for depth, gpt, ldt, vdt, sup, W, geo, tails in itertools.product(
            (16, 64, 256, 384, 448, 512, 768, 1024, 1152, 1280, 1536, 1600),
            (1, 3, 6, 8, 12, 32, 96, 128, 160), (f32, bf), (f32, bf), (0, 2, 3, 16),
            (1, 384, 1152), (True, False), (True, False)):
        if not tails and (sup or vdt == bf or W != 1 or not geo):
            continue
        if tails and ldt == bf and vdt == bf:
            continue  # the bf16 scan: csrc/hier_scan_sm90.cu and the CUDA-core deep form
        cat_d = depth + 128
        q = torch.ones(2, cat_d, dtype=ldt)
        gs = torch.ones(T * gpt, depth, dtype=ldt)
        gg = torch.ones(T * 8, 128, dtype=ldt)
        vs = torch.ones(T * gpt // max(sup, 1), W, dtype=vdt) if tails else None
        vg = torch.ones(T * 8, W, dtype=vdt) if tails else None
        kw = dict(gpt_s=gpt, gpt_g=8, has_geo=geo, sup_r=sup)
        old = _old_takes(q, gs, gg, vs, vg, **kw)
        try:
            fams = th._scan_tf32_fams(q, gs, gg, vs, vg, **kw)
        except ValueError as err:
            assert "unsupported shapes" in str(err)
            assert not old, (depth, gpt, ldt, vdt, sup, W, geo, tails)
            assert depth > th.SCAN_TF32_COLS or sup == 3 or gpt % max(sup, 1), kw
            continue
        served += old
        for fm in fams:
            assert _launch_takes(fm, *th._scan_tf32_plan(fm, 2), tails), (fm, depth, tails)
            assert fm.lx3 == (ldt == f32) and fm.tx3 == (tails and vdt == f32)
    assert served > 500
