"""Kernel 12 (the refine) on its Hopper body, `csrc/hier_refine_sm90.cu`,
on the CPU, in every form: f32 logits (`exact`) three TF32 products a term,
bf16 logits (`high`'s 768 columns, `fast`'s 256) bf16 wgmma; stats only and
has_parts, whose parts the value pass of `csrc/hier_values_tf32_sm90.cu`
computes over D written once, with f32 or bf16 vw.

A CUDA kernel cannot run here, so the arithmetic is held through a plain
version that reads the very images the kernels copy
(`ops.retrieval_hier._refine_sm90_plain`): the same TF32 halves, each
32-deep chunk's products in a fresh fragment truncated toward zero
(`ops._prep.tf32x3_matmul`), a tile's fine and supergroup rows in 64-row
steps, the exp2 sums in the quad lanes' order, D's units a list entry and
the value pass's segments added in order.  Against range_tpu's
`_hier_refine_call` in interpret mode on two-level banks JAX builds from a
numpy-seeded informative bank (bn 128, gsz_sem 8, gsz_super 16: 16 fine
groups and 8 supergroups a tile) at each tier, the port loading its
archive.  Also: the images read back to their operands, the segments cover
every listed tile once, and the shape check takes every shape the old
bodies took and refuses what the launch refuses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import _within_terms

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.convert.from_jax import _tensor
from range_tpu_torch.ops import _prep
from range_tpu_torch.ops import retrieval_fused as rf
from range_tpu_torch.ops import retrieval_hier as th

N, B, DV, M = 2048, 128, 96, 6
GPT_F, GPT_SUP = 16, 8  # bn 128 / gsz_sem 8, bn 128 / gsz_super 16
FORMS = [("exact", "f32"), ("exact", "bf16"), ("high", "bf16"), ("fast", "bf16")]


def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def banks(tmp_path_factory):
    """The informative bank's two-level HierBanks at each tier (the port's
    loaded from JAX's archives), regional queries packed for each, and each
    64-query block's list of M distinct tiles."""
    jb = JaxGeoBank.synthetic_informative(11, N, key_dim=256, value_dim=DV, pad_to=512,
                                          value_dtype=jnp.bfloat16)
    rng = np.random.default_rng(5)
    rows = np.repeat(rng.integers(0, N, 4), B // 4)
    ll = np.asarray(jb.locs_lonlat, np.float32)[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = np.asarray(jb.keys_sem, np.float32)[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)
    out = {}
    for tier in ("exact", "high", "fast"):
        jhb = jh.build_hier_bank(jb, bn=128, gsz_sem=8, gsz_geo=16, gsz_super=16, tier=tier)
        path = str(tmp_path_factory.mktemp("refine") / f"{tier}.npz")
        jh.save_hier_bank(jhb, path)
        q_cat = rf.pack_queries(_tensor(q), _tensor(x), 12.0, 40.0, tier)
        out[tier] = (jhb, th.load_hier_bank(path, device="cpu"), q_cat)
    T = out["exact"][1].t_real
    idx = np.stack([rng.permutation(T)[:M] for _ in range(B // 64)]).astype(np.int32)
    return out, idx


def _operands(banks, tier, vw, bm):
    """(port args, JAX args) of a refine at ``tier`` with ``vw``-dtype value
    sums, over the lists of blocks of ``bm`` queries."""
    out, idx = banks
    _, thb, q_cat = out[tier]
    idx = torch.from_numpy(idx[::bm // 64].copy())
    dt = torch.float32 if vw == "f32" else torch.bfloat16
    targs = (q_cat, idx, thb.g_sem_cat, thb.g_sup_cat, thb.g_sem_vw.to(dt),
             thb.g_sup_vw.to(dt))
    return targs, tuple(_j(t) for t in targs)


@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("tier,vw", FORMS)
def test_refine_plain_matches_jax(banks, tier, vw, bm):
    """Both forms against JAX's kernel in interpret mode (and the one-pass
    plain version): the max logits within 1e-4, the exp2 sums within 1e-4
    of themselves, parts within 1e-4 of its terms' magnitudes where every
    rounding point is f32, else within one bf16 ulp of each term
    (`_within_terms`): a weight within the logits' difference of a bf16
    boundary rounds the other way."""
    targs, jargs = _operands(banks, tier, vw, bm)
    kw = dict(bm=bm, gpt_f=GPT_F, gpt_sup=GPT_SUP)
    sh = th._refine_shape(*targs, **kw, stats_only=False)
    assert (sh.x3, sh.tx3) == (tier == "exact", vw == "f32")
    assert sh.nw == bm // 64 and (sh.R, sh.spt, sh.nu) == (24, 1, 1)
    for stats_only in (True, False):
        got = th._refine_sm90_plain(*targs, **kw, stats_only=stats_only)
        ref = jh._hier_refine_call(*jargs, **kw, stats_only=stats_only, interpret=True)
        one = th._hier_refine_plain(*targs[:3], bm=bm, gpt_f=GPT_F) if stats_only else (
            th._hier_refine_plain(*targs[:3], bm=bm, gpt_f=GPT_F, g_sup_cat=targs[3],
                                  g_sem_vw=targs[4], g_sup_vw=targs[5], gpt_sup=GPT_SUP))
        for r in (ref, one):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(r[0], np.float32), rtol=0,
                                       atol=1e-4)
            np.testing.assert_allclose(got[1].numpy(), np.asarray(r[1], np.float32),
                                       rtol=1e-4, atol=0)
        if stats_only:
            assert got[2] is None
            continue
        mag = th._hier_refine_plain(*targs[:3], bm=bm, gpt_f=GPT_F, g_sup_cat=targs[3],
                                    g_sem_vw=targs[4], g_sup_vw=targs[5], gpt_sup=GPT_SUP,
                                    magnitude=True)[2].numpy()
        assert got[2].shape == (B, targs[4].shape[1])
        for r in (np.asarray(ref[2], np.float32), one[2].numpy()):
            if tier == "exact" and vw == "f32":
                assert (np.abs(got[2].numpy() - r) <= 1e-4 * mag + 1e-6).all()
            else:
                _within_terms(got[2].numpy(), r, mag)


def test_refine_steps_of_a_tall_tile(banks):
    """A tile of more rows than one step (32 fine groups and 40
    supergroups: 72 rows in two 64-row steps, three 32-row D chunks at f32)
    and an odd parts width (through the buffer): the same answers as the
    one-pass plain version."""
    out, idx = banks
    _, thb, q_cat = out["exact"]
    g, vw = thb.g_sem_cat, thb.g_sem_vw[:, :95]
    T = g.shape[0] // 32
    g_s = torch.cat([g, g[:T * 8]])[:T * 40]
    vs = 0.5 * torch.cat([vw, vw[:T * 8]])[:T * 40]
    lst = torch.from_numpy(idx % T)
    kw = dict(bm=64, gpt_f=32, gpt_sup=40)
    sh = th._refine_shape(q_cat, lst, g, g_s, vw, vs, **kw, stats_only=False)
    assert (sh.R, sh.spt, sh.nu, sh.W) == (72, 2, 3, 95)
    got = th._refine_sm90_plain(q_cat, lst, g, g_s, vw, vs, **kw, stats_only=False)
    pk = dict(bm=64, gpt_f=32, g_sup_cat=g_s, g_sem_vw=vw, g_sup_vw=vs, gpt_sup=40)
    one = th._hier_refine_plain(q_cat, lst, g, **pk)
    mag = th._hier_refine_plain(q_cat, lst, g, **pk, magnitude=True)[2]
    torch.testing.assert_close(got[0], one[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], one[1], rtol=1e-4, atol=0)
    assert ((got[2] - one[2]).abs() <= 1e-4 * mag + 1e-6).all()


@pytest.mark.parametrize("tier,vw", FORMS)
def test_images_read_back(banks, tier, vw):
    """The centroid image holds each tile's fine groups then its
    supergroups (TF32 halves summing to the f32 centroids, or the bf16
    ones), zero past the tile's rows and the columns; the value image the
    same rows of [g_sem_vw | -g_sup_vw]; both made once per bank."""
    targs, _ = _operands(banks, tier, vw, 128)
    q_cat, idx, g, gs, vw_f, vw_s = targs
    sh = th._refine_shape(*targs, bm=128, gpt_f=GPT_F, gpt_sup=GPT_SUP, stats_only=False)
    cimg, vimg = th._refine_images(g, gs, vw_f, vw_s, sh)
    T, w = sh.T, g.shape[1]
    if sh.x3:
        hi, lo = _prep.kmajor_tf32_read(cimg)  # [T, spt, 64, 32 C]
        rows = (hi + lo).reshape(T, 64, -1)
        tol = dict(rtol=2 ** -21, atol=0)
    else:
        rows = _prep.swizzle128(cimg).transpose(2, 3).reshape(T, 64, -1).float()
        tol = dict(rtol=0, atol=0)
    torch.testing.assert_close(rows[:, :GPT_F, :w], g.float().reshape(T, GPT_F, w), **tol)
    torch.testing.assert_close(rows[:, GPT_F:24, :w], gs.float()[:T * GPT_SUP].reshape(
        T, GPT_SUP, w), **tol)
    assert not rows[:, 24:].any() and not rows[:, :, w:].any()
    W = sh.W
    if sh.tx3:
        vh, vl = _prep.kmajor_tf32_read(vimg.unsqueeze(3))  # [T, nu, VS, 128, 32]
        v = (vh + vl).permute(0, 1, 4, 2, 3).reshape(T, 32 * sh.nu, -1)
    else:
        v = _prep.swizzle128(vimg).float().permute(0, 1, 4, 2, 3, 5).reshape(T, 64 * sh.nu, -1)
    want = torch.cat([vw_f.float().reshape(T, GPT_F, W),
                      -vw_s.float()[:T * GPT_SUP].reshape(T, GPT_SUP, W)], 1)
    torch.testing.assert_close(v[:, :24, :W], want, **tol)
    assert not v[:, 24:].any() and not v[:, :, W:].any()
    again = th._refine_images(g, gs, vw_f, vw_s, sh)
    assert again[0] is cimg and again[1] is vimg


@pytest.mark.parametrize("Bp,K,W", [(64, 1, 96), (128, 6, 1152), (1024, 96, 1152),
                                    (10_112, 96, 1152), (256, 300, 200)])
def test_segments_cover_every_entry_once(Bp, K, W):
    """Each pass's segments of a list (the list pass's blocks of 128
    queries, the value pass's of 64 queries and a pair of slices) take
    every entry once, in order, none empty."""
    g = torch.zeros(16 * 8, 32)
    vw = torch.zeros(16 * 8, W)
    sh = th._refine_shape(torch.zeros(Bp, 40), torch.zeros((Bp // 64, K), dtype=torch.int32),
                          g, g[:64], vw, vw[:64], bm=64, gpt_f=8, gpt_sup=4, stats_only=False)
    for n in th._refine_segments(sh, Bp, K):
        cuts = [(K * i // n, K * (i + 1) // n) for i in range(n)]
        assert 1 <= n <= K and cuts[0][0] == 0 and cuts[-1][1] == K
        assert all(b > a for a, b in cuts) and all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))


def _shape(Bp=256, cat_d=384, G=64 * 8, wf=256, ws=256, gpt_f=8, gpt_sup=2, W=256, bm=128,
           K=5, dt=torch.bfloat16, vdt=torch.bfloat16, Gs=None):
    Gs = G // gpt_f * gpt_sup if Gs is None else Gs
    args = (torch.zeros(Bp, cat_d, dtype=dt), torch.zeros((Bp // bm, K), dtype=torch.int32),
            torch.zeros(G, wf, dtype=dt), torch.zeros(Gs, ws, dtype=dt),
            torch.zeros(G, W, dtype=vdt), torch.zeros(Gs, W, dtype=vdt))
    return args, dict(bm=bm, gpt_f=gpt_f, gpt_sup=gpt_sup)


@pytest.mark.parametrize("shape", [
    {}, dict(gpt_f=12, G=12 * 20, gpt_sup=3), dict(gpt_f=3, G=3 * 40, gpt_sup=1),
    dict(gpt_f=160, G=160 * 3, gpt_sup=20), dict(bm=64), dict(bm=192, Bp=384),
    dict(wf=768, ws=768, cat_d=896), dict(wf=1536, ws=1536, cat_d=1664),
    dict(dt=torch.float32, vdt=torch.float32), dict(dt=torch.float32, wf=1536, ws=1536,
                                                    cat_d=1664),
    dict(vdt=torch.float32, wf=768, ws=768, cat_d=896), dict(W=1), dict(W=1153), dict(K=1),
    dict(wf=48, ws=16), dict(Gs=64 * 2 + 16)])
def test_shape_check_takes_the_old_bodies_shapes(shape):
    """Every shape the mma.sync body's check (bf16 operands of at most 256
    columns, gpt_f 8, 16, 32 or a multiple of 32, W a multiple of 128) and
    the CUDA-core body's (`_list_shapes`: any gpt, any width up to q's, a
    bm multiple of 64; shared memory to ~450 f32 / ~1,290 bf16 columns)
    took, both forms: the Hopper body takes any gpt, 1,536 columns, and
    fits its shared memory (the kernel's `layout`)."""
    args, kw = _shape(**shape)
    for stats_only in (True, False):
        sh = th._refine_shape(*args, **kw, stats_only=stats_only)
        q_bytes = (sh.nw * 64 * (32 * min(sh.C, 8) + 8) * 4 if sh.x3 else sh.nw * sh.C * 8192)
        smem = -(-q_bytes // 1024) * 1024 + 4 * (16384 if sh.x3 else 8192) + 8 * 9 + 1024
        assert smem <= 232_448 and sh.C <= (48 if sh.x3 else 24)
        assert sh.spt == -(-sh.R // 64) and sh.nu * (32 if sh.tx3 else 64) >= sh.R


@pytest.mark.parametrize("shape", [
    dict(bm=96, Bp=192), dict(Bp=200, bm=100), dict(G=64 * 8 + 3), dict(wf=1568, ws=16,
                                                                          cat_d=1664),
    dict(wf=400, cat_d=384), dict(Gs=64 * 2 - 1), dict(gpt_f=0, G=0, Gs=16),
    dict(vdt=torch.float16)])
def test_shape_check_refuses(shape):
    """What the launch refuses raises ValueError before any launch: a batch
    of other than whole blocks of a multiple of 64 queries, tiles of no
    whole number of groups, logits past 1,536 columns or wider than the
    queries, fewer supergroups than the fine tiles need, vw neither bf16
    nor f32."""
    args, kw = _shape(**shape)
    with pytest.raises(ValueError):
        th._refine_shape(*args, **kw, stats_only=False)
    with pytest.raises(ValueError):
        th._refine_sm90_plain(*args, **kw, stats_only=False)


def test_mismatched_vw_refused():
    """vw of two widths or two dtypes raises (the old bodies refused the
    widths too)."""
    args, kw = _shape()
    bad = (args[:5] + (args[5][:, :128],), args[:5] + (args[5].float(),))
    for a in bad:
        with pytest.raises(ValueError):
            th._refine_shape(*a, **kw, stats_only=False)
