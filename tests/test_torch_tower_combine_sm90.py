"""The Hopper bodies of the SIREN tower's bf16 mode (`csrc/siren_tower_sm90.cu`)
and of the hierarchical combine (`csrc/combine_cat_sm90.cu`), on the CPU.

A CUDA kernel cannot run here, so each body's arithmetic is held through a
plain version of its decomposition that reads the very images the kernel
copies (`ops.sh._siren_tower_slabs`, `ops.retrieval_hier._combine_cat_tf32x3`,
unswizzling `ops._prep.swizzle128`'s tiles), against the one-pass plain
version and against range_tpu's Pallas kernels in interpret mode.  Also:
each block plan at B = 1, 37, 1,000 and 10,000, the TF32 split, and the
cache of prepared weights across in-place updates.  Inputs are made with
numpy from a seed; JAX inputs are float32 (conftest enables x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.ops import retrieval_hier as jh
from range_tpu.ops import sh as jsh
from range_tpu.ops.nets import SirenNet as JaxSirenNet
from range_tpu_torch.geometry import lonlat_deg_to_xyz
from range_tpu_torch.ops import _prep
from range_tpu_torch.ops import retrieval_fused as rf
from range_tpu_torch.ops import retrieval_hier as th
from range_tpu_torch.ops import sh as tsh
from range_tpu_torch.ops.nets import SirenNet

BATCHES = (1, 37, 1_000, 10_000)
SMEM_MAX = 232_448  # a block's shared memory on sm_90


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    ll = np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)], 1)
    ll[:4, 1] = [90.0, -90.0, 89.999, -89.999]  # poles and near-poles
    return ll.astype(np.float32)


def _torch_params(tree):
    return {"layers": [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
                       for layer in tree["layers"]],
            "last": {k: torch.from_numpy(np.array(v)) for k, v in tree["last"].items()}}


# ---------------------------------------------------------------- the tower

TOWER_SHAPES = [(8, 128), (8, 256), (40, 128), (40, 256)]


@pytest.fixture(scope="module")
def towers():
    """Per (L, H): the JAX params' port copy, 256 coordinates, the JAX tower
    kernel's bf16 answer (interpret mode) and the port's plain one."""
    out = {}
    for L, H in TOWER_SHAPES:
        p = JaxSirenNet(dim_in=L * L, dim_hidden=H, dim_out=H, num_layers=2).init(
            jax.random.PRNGKey(L + H), dtype=jnp.float32)
        ll = _coords(256, seed=L + H)
        jax_out = np.asarray(jsh.siren_tower_pallas(jnp.asarray(ll), L, p,
                                                    matmul_dtype=jnp.bfloat16, interpret=True))
        params = _torch_params(p)
        plain = tsh._siren_tower_plain(torch.from_numpy(ll), L, params,
                                       matmul_dtype=torch.bfloat16)
        out[L, H] = dict(params=params, ll=torch.from_numpy(ll), jax=jax_out, plain=plain)
    return out


# bf16: the same operand rounding points as the plain version and the JAX
# kernel, but an f32 sum that lands near a bf16 tie (P, or a layer's sum
# in another order) rounds the other way, 2^-8 relative, amplified by
# sin(30 h): test_torch_sh.py's bf16 tolerance against JAX, 5e-3.
@pytest.mark.parametrize("L,H", TOWER_SHAPES)
def test_tower_slabs_match_plain_and_jax(towers, L, H):
    t = towers[L, H]
    images = tsh._tower_images(L, t["params"], "analytic")
    got = tsh._siren_tower_slabs(t["ll"], L, images)
    assert got.shape == (256, H) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), t["plain"].numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(got.numpy(), t["jax"], rtol=0, atol=5e-3)


@pytest.mark.parametrize("L,H", [(8, 128), (40, 256), (21, 128)])
def test_tower_images_hold_the_plain_operands(L, H):
    """Unswizzled, each image holds the plain version's bf16 operands
    exactly, zero in every pad row and column: the Fourier slab of row k
    at [r][j] (cos j in j < L, sin j in Lq + j), the folded weights at
    [wc rows | ws rows from Lq], the further layers chunk by chunk."""
    net = SirenNet(L * L, H, H, 3, device="cpu", generator=torch.Generator().manual_seed(L))
    params = net.tower_params()
    ft, w1, hid, bpack = tsh._tower_images(L, params, "analytic")
    lq, ks, kb2, kc = tsh._tower_shape(L, H)
    bf = torch.bfloat16
    assert ft.shape == (L, kb2, lq, 64) and w1.shape == (L, H // 64, ks, 64)
    assert hid.shape == (3, H // kc, H // 64, kc, 64) and bpack.shape == (4, H)
    T = _prep.swizzle128(ft).permute(0, 2, 1, 3).reshape(L, lq, kb2 * 64)
    ftab = tsh._fourier_table(L, torch.float32, torch.device("cpu")).to(bf)
    ftab = ftab.reshape(2 * L, L, L)  # [j, k, r]
    assert torch.equal(T[:, :L, :L], ftab[:L].permute(1, 2, 0))
    assert torch.equal(T[:, :L, lq:lq + L], ftab[L:].permute(1, 2, 0))
    rest = T.clone()
    rest[:, :L, :L] = 0
    rest[:, :L, lq:lq + L] = 0
    assert not rest.any()
    W1 = _prep.swizzle128(w1).permute(0, 2, 1, 3).reshape(L, ks, H)
    wc, ws = tsh._fold_first_layer(params["layers"][0]["w"], L, "analytic", torch.float32)
    assert torch.equal(W1[:, :L], wc.to(bf).reshape(L, L, H))
    assert torch.equal(W1[:, lq:lq + L], ws.to(bf).reshape(L, L, H))
    assert not W1[:, L:lq].any() and not W1[:, lq + L:].any()
    HW = _prep.swizzle128(hid).permute(0, 1, 3, 2, 4).reshape(3, H, H)
    for got, layer in zip(HW, params["layers"][1:] + [params["last"]]):
        assert torch.equal(got, layer["w"].to(bf))


@pytest.mark.parametrize("B", BATCHES)
def test_tower_plans(B):
    """The block plan at each batch: two consumer warpgroups of 64 queries
    each where their regions fit beside the rings (one at Lq = 64 and H =
    256), a producer warpgroup, two 2-stage rings (a recurrence row's Fourier
    slab; its first-layer slab or a further layer's chunk); the shared
    memory is what the kernel's `Shape::TOTAL` gives on the card
    (`siren_tower_sm90_smem`, held there by
    test_torch_cuda.py::test_tower_sm90_plan_matches_the_kernel), and a
    block fits the SM's 227 KB at every L the kernel takes."""
    for L, H, wgs, smem in ((40, 256, 2, 207_936), (40, 128, 2, 158_784), (8, 128, 2, 56_384),
                            (64, 256, 1, 215_104), (21, 256, 2, 140_352)):
        plan = tsh._tower_plan(B, L, H)
        assert plan["warpgroups"] == wgs and plan["threads"] == 128 * wgs + 128
        assert plan["grid"] == -(-B // (64 * wgs))
        assert plan["smem"] == smem and plan["stages"] == 2
        lq, ks, _, kc = tsh._tower_shape(L, H)
        assert plan["stage_bytes"] == (-(-ks // 64) * lq * 128, ks * H * 2)
        assert plan["chunks"] * kc == H and kc % 16 == 0
    assert max(tsh._tower_plan(B, L, H)["smem"] for L in range(2, 65)
               for H in (128, 256)) <= SMEM_MAX


# ---------------------------------------------------------------- the combine

COMBINE_KW = dict(bn=128, gsz_sem=16, gsz_geo=16, lr_rank=256, lr_geo=384,
                  res_rank=128, topk_gsz=8)
CB = 256  # queries


@pytest.fixture(scope="module")
def combine_case(tmp_path_factory):
    """A JAX-built bank with the flagship's knobs (res_rank 128, lr_rank
    256, lr_geo 384; Dv = 512, bn = 128), loaded into the port; the fused
    combine's partials of CB geo-sorted queries from the port's plain
    versions, in both geo forms: the low-rank tail (rg = 384) and the
    full-width one (rg = 0, the rr-shape geo parts)."""
    jbank = JaxGeoBank.synthetic_informative(11, 3000, key_dim=256, value_dim=512,
                                             pad_to=512, value_dtype=jnp.bfloat16)
    path = str(tmp_path_factory.mktemp("comb") / "hb.npz")
    jh.save_hier_bank(jh.build_hier_bank(jbank, **COMBINE_KW), path)
    hb = th.load_hier_bank(path, device="cpu")
    rng = np.random.default_rng(3)
    ll = torch.from_numpy(_coords(CB, seed=3))
    q = torch.from_numpy(rng.standard_normal((CB, 256)).astype(np.float32))
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    q_s, q_x = th._pad_queries(q, lonlat_deg_to_xyz(ll), 128)
    order = th._hybrid_order(q_x, CB)
    q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[order].contiguous()
    ps, pg, tails = th._hier_partials(q_cat, hb, raw=True, k_tiles=8, bm=128, j_sem=3,
                                      j_geo=2, n_valid=CB, k_geo=4)
    q_srt = q_s[order].contiguous()
    Ws, Dv = hb.g_sem_vw_lr.shape[1], hb.value_dim
    low = dict(kw=dict(Ws=Ws, r=256, rrp=128, Dv=Dv, beta=0.5, rg=384,
                       Wg=hb.g_geo_vw_lr.shape[1]),
               args=(ps, pg, tails, q_srt, hb.w_sem, hb.u_sem, hb.w_geo, hb.u_geo))
    # rg = 0: the geo family's full-width tail and its rr-shape parts
    stats = th._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr,
                                hb.g_geo_vw, gpt_s=8, gpt_g=8)
    idx_g, _ = th.select_tiles(stats[2], stats[3], stats[0], stats[1], t_real=hb.t_real,
                               k_tiles=4, bm=128, n_valid=CB, mode="range")
    pg0 = th._hier_parts_family_plain(q_cat, hb.k_cat, hb.mask_neg, idx_g, hb.g_geo_cat,
                                      hb.g_geo_vw, hb.z_geo, sem_d=256, bm=128, bn=128,
                                      gpt=8, geo=True, lrr=Dv, lr=False)
    full = dict(kw=dict(low["kw"], rg=0, Wg=hb.g_geo_vw.shape[1]),
                args=(ps, pg0, stats[4], q_srt, hb.w_sem, hb.u_sem, hb.w_geo, None))
    return dict(hb=hb, low=low, full=full)


def _held(got, ref):
    """The card's bar for the combine (chip_smoke, test_torch_cuda.py):
    |got - ref| <= 1e-5 + 1e-5 |ref|; returns the largest error over it."""
    ratio = ((got - ref).abs() / (1e-5 + 1e-5 * ref.abs())).max().item()
    assert ratio <= 1.0, ratio
    return ratio


# The split carries each product to ~2^-21 relative; the kernel's sums
# (modelled pessimistically: each step truncated toward zero, a fresh
# fragment a 32-deep chunk) stay within the card's f32 bar, 1e-5 + 1e-5 |ref|.
@pytest.mark.parametrize("form", ["low", "full"], ids=["rg384", "rg0"])
@pytest.mark.parametrize("chain", ["exact", "chunks"])
def test_combine_split_matches_plain(combine_case, form, chain):
    c = combine_case[form]
    img = th._combine_images(*c["args"][4:])
    ref = th._combine_cat_plain(*c["args"], **c["kw"])
    got = th._combine_cat_tf32x3(*c["args"][:4], img, **c["kw"], chain=chain)
    assert got.shape == ref.shape
    assert torch.equal(got[:, c["kw"]["Dv"]:], ref[:, c["kw"]["Dv"]:])  # the queries
    _held(got, ref)


def test_combine_split_matches_jax(combine_case):
    """The split against JAX's combine kernel (interpret mode) on the same
    partials, rg = 384: f32 products in another order, at the same bar."""
    c = combine_case["low"]
    np_args = [jnp.asarray(t.numpy()) for t in c["args"]]
    ref = torch.from_numpy(np.array(jh._combine_cat_call(*np_args, bm=128, interpret=True,
                                                         **c["kw"])))
    img = th._combine_images(*c["args"][4:])
    _held(th._combine_cat_tf32x3(*c["args"][:4], img, **c["kw"]), ref)


def test_combine_split_on_cancelling_rows(combine_case):
    """Rows built to cancel: each sem coefficient row is the bank's partials
    plus a pair of large opposite terms on two basis rows that nearly
    coincide, and the corr columns are differences of nearly equal tails
    and approximations, so the products' sum is far below the sum of their
    magnitudes.  The chunked model still holds the card's bar; one
    truncated chain over all 336 steps (the design the kernel does not
    use) drifts further than the chunked one."""
    c = combine_case["low"]
    ps, pg, tails, q_srt, w_sem, u_sem, w_geo, u_geo = c["args"]
    kw = c["kw"]
    g = torch.Generator().manual_seed(7)
    ps, tails, u_sem = ps.clone(), tails.clone(), u_sem.clone()
    u_sem[1] = u_sem[0] * (1 + 1e-3 * torch.randn(u_sem.shape[1], generator=g))
    big = 50.0 * torch.rand(ps.shape[0], generator=g)
    tails[:, 0] += big  # corr column 0: +big against ...
    tails[:, 1] -= big * (1 + 1e-4 * torch.randn(ps.shape[0], generator=g))  # ... -big
    tails[:, 2:kw["r"]] += 30.0  # corr = (tails + 30) - approx: cancels against ...
    ps[:, kw["rrp"] + 128 + 2:kw["rrp"] + 128 + kw["r"]] += 30.0  # ... approx + 30
    args = (ps, pg, tails, q_srt, w_sem, u_sem, w_geo, u_geo)
    ref = th._combine_cat_plain(*args, **kw)
    img = th._combine_images(w_sem, u_sem, w_geo, u_geo)
    chunks = th._combine_cat_tf32x3(*args[:4], img, **kw, chain="chunks")
    one = th._combine_cat_tf32x3(*args[:4], img, **kw, chain="rz")
    _held(chunks, ref)
    assert (one - ref).abs().max() > (chunks - ref).abs().max()


def test_combine_images_hold_the_split_bases(combine_case):
    hb = combine_case["hb"]
    img = th._combine_images(hb.w_sem, hb.u_sem, hb.w_geo, hb.u_geo)
    B = torch.cat(th._stacked_bases(hb.w_sem, hb.u_sem, hb.w_geo, hb.u_geo), 0)
    K, Dv = B.shape
    assert img.shape == (Dv // 128, K // 32, 2, 128, 32)
    hi, lo = _prep.swizzle128(img).permute(2, 1, 4, 0, 3).reshape(2, K, Dv)
    assert torch.equal(hi, th._tf32_rna(B)) and torch.equal(lo, th._tf32_rna(B - hi))
    assert ((B - hi - lo).abs() <= 2.0 ** -22 * B.abs()).all()


@pytest.mark.parametrize("B", BATCHES)
def test_combine_plans(B):
    """128 rows x 128 columns a block (two consumer warpgroups, a producer
    warpgroup), 2-stage rings of 32-deep chunks of the split bases and of
    the A sources; the shared
    memory is the kernel's `Layout::TOTAL` (held on the card by
    test_torch_cuda.py::test_combine_sm90_plan_matches_the_kernel)."""
    Bp = -(-B // 128) * 128
    plan = th._combine_plan(Bp, 1024, 896)
    assert plan["grid"] == (Bp // 128, 8) and plan["threads"] == 384
    assert plan["smem"] == 197_696 <= SMEM_MAX and plan["stages"] == 2
    assert plan["stage_bytes"] == (2 * 128 * 128, 2 * 128 * 128) and plan["chunks"] == 28


def test_tf32_rna_rounds_half_away_from_zero():
    """`_tf32_rna` is cvt.rna.tf32.f32: 10 stored mantissa bits, nearest,
    ties away from zero, on either sign; the split's halves add back to
    x within 2^-22 |x|."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    x = torch.tensor([1 + ulp / 2, -(1 + ulp / 2), 1 + ulp / 2 - 2.0 ** -20,
                      1 + 3 * ulp / 2, 3.0, 0.0, -0.0, 1e-30], dtype=torch.float32)
    want = torch.tensor([1 + ulp, -(1 + ulp), one, 1 + 2 * ulp, 3.0, 0.0, 0.0, 1e-30],
                        dtype=torch.float32)
    got = th._tf32_rna(x)
    assert torch.equal(got[:-1], want[:-1])
    assert (got.view(torch.int32) & 0x1FFF == 0).all()
    r = torch.randn(10_000, generator=torch.Generator().manual_seed(1)) * 1e3
    hi, lo = th._tf32_split(r)
    assert ((r - hi - lo).abs() <= 2.0 ** -22 * r.abs()).all()


# ---------------------------------------------------------------- the cache


def test_prepared_weights_follow_in_place_updates(combine_case):
    """The kernels' prepared layouts are built once and reused while their
    sources are unchanged (the same object back, nothing rebuilt); an
    optimizer step on the tower's parameters, or an in-place write to a
    bank's basis, makes the next call rebuild, so the next tower output
    (the bf16 body's decomposition) and the next combine change."""
    L, H = 8, 128
    net = SirenNet(L * L, H, H, 2, device="cpu", generator=torch.Generator().manual_seed(2))
    ll = torch.from_numpy(_coords(16, seed=2))
    builds = []

    def images():
        params = net.tower_params()  # fresh views of the parameters, as each call makes
        return _prep.prepared("siren_tower_sm90", tsh._tower_sources(params),
                              lambda: builds.append(1) or tsh._tower_images(L, params, "analytic"),
                              (L, "analytic", 1))

    first = images()
    assert images() is first and len(builds) == 1
    before = tsh._siren_tower_slabs(ll, L, first)
    opt = torch.optim.SGD(net.parameters(), lr=1e-3)
    tsh._siren_tower_ref(ll, L, net.tower_params()).sum().backward()
    opt.step()
    second = images()
    assert second is not first and len(builds) == 2
    after = tsh._siren_tower_slabs(ll, L, second)
    assert not torch.allclose(before, after)
    ref = tsh._siren_tower_plain(ll, L, net.tower_params(), matmul_dtype=torch.bfloat16)
    np.testing.assert_allclose(after.detach().numpy(), ref.detach().numpy(), rtol=0,
                               atol=5e-3)

    hb = combine_case["hb"]
    u_sem = hb.u_sem.clone()
    src = [hb.w_sem, u_sem, hb.w_geo, hb.u_geo]
    bases = _prep.prepared("combine_cat_sm90", src, lambda: th._combine_images(*src), (True,))
    assert _prep.prepared("combine_cat_sm90", src, lambda: None, (True,)) is bases
    u_sem.mul_(2.0)
    again = _prep.prepared("combine_cat_sm90", src, lambda: th._combine_images(*src), (True,))
    assert again is not bases and not torch.equal(again, bases)
