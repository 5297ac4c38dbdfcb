"""range_tpu_torch's CUDA kernels on the card: each against its plain
version, the launch counters, and the main path through `load_model`.

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a CUDA device every test skips.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu_torch import GeoBank, load_model
from range_tpu_torch.geometry import lonlat_deg_to_xyz
from range_tpu_torch.ops import retrieval
from range_tpu_torch.ops import retrieval_fused as rf
from range_tpu_torch.ops import sh
from range_tpu_torch.ops.nets import SirenNet

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _coords(n, seed, device):
    rng = np.random.default_rng(seed)
    ll = np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)], 1)
    ll[:2, 1] = [90.0, -90.0][:n]
    return torch.from_numpy(ll.astype(np.float32)).to(device)


# f32: the same f32 math in another summation order, amplified x30 by
# sin(30 h).  bf16: the same operand rounding points, but an f32 sum that
# lands near a bf16 tie rounds the other way (2^-8 relative).  Each mode on
# each body: f32 on `csrc/siren_tower.cu`; bf16 on the Hopper body
# `csrc/siren_tower_sm90.cu` (the wrapper's route) and, launched here
# alone, on the f32 body's bf16 form (chip_smoke.py's yardstick).
@pytest.mark.parametrize("H", [128, 256])
@pytest.mark.parametrize("bf16,atol,body", [(False, 1e-4, "cores"), (True, 2e-2, "sm90"),
                                            (True, 2e-2, "cores")])
def test_tower_kernel_matches_plain(cuda, H, bf16, atol, body):
    L = 40
    net = SirenNet(L * L, H, H, 3, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(H))
    ll = _coords(777, seed=0, device=cuda)  # no multiple of the 64-query block
    md = torch.bfloat16 if bf16 else None
    before = (sh.siren_tower.launches, sh.siren_tower.bf16_launches)
    with torch.no_grad():
        if bf16 and body == "cores":
            got = _tower_cores_bf16(ll, L, net.tower_params())
        else:
            got = sh.siren_tower(ll, L, net.tower_params(), matmul_dtype=md)
        ref = sh._siren_tower_plain(ll, L, net.tower_params(), matmul_dtype=md)
    torch.cuda.synchronize()
    wrapped = int(body == "sm90" or not bf16)
    assert (sh.siren_tower.launches, sh.siren_tower.bf16_launches) == (
        before[0] + wrapped, before[1] + int(body == "sm90"))
    torch.testing.assert_close(got, ref, rtol=0, atol=atol)


def _tower_cores_bf16(ll, L, params):
    """`csrc/siren_tower.cu`'s bf16 form (bf16_ops = 1), launched alone:
    no wrapper launches it."""
    import ctypes

    from range_tpu_torch.kernels._build import load_kernel_library

    H = params["layers"][0]["w"].shape[1]
    ftabT, wc, ws, deep, wl, bpack = sh._tower_f32(L, params, "analytic")
    out = torch.empty(ll.shape[0], H, device=ll.device)
    rc = load_kernel_library("siren_tower").siren_tower_launch(
        ll.data_ptr(), ftabT.data_ptr(), wc.data_ptr(), ws.data_ptr(), bpack.data_ptr(),
        deep.data_ptr(), wl.data_ptr(), out.data_ptr(), ll.shape[0], L, H,
        len(params["layers"]) - 1, ctypes.c_float(30.0), ctypes.c_float(1.0), 1,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


# The Hopper body at every count of 16-column P blocks (L = 2..64: one to
# four), ragged batches, one further layer or three: the same bf16 rule.
@pytest.mark.parametrize("L", [2, 8, 21, 40, 64])
@pytest.mark.parametrize("B,layers", [(1, 2), (37, 4), (1000, 3)])
@pytest.mark.parametrize("H", [128, 256])
def test_tower_sm90_every_depth(cuda, L, B, layers, H):
    net = SirenNet(L * L, H, H, layers, device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(L + B))
    ll = _coords(B, seed=L, device=cuda)
    with torch.no_grad():
        got = sh.siren_tower(ll, L, net.tower_params(), matmul_dtype=torch.bfloat16)
        ref = sh._siren_tower_plain(ll, L, net.tower_params(), matmul_dtype=torch.bfloat16)
        slabs = sh._siren_tower_slabs(ll, L, sh._tower_images(L, net.tower_params(),
                                                                "analytic"))
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=0, atol=2e-2)
    torch.testing.assert_close(got, slabs, rtol=0, atol=2e-2)


def test_tower_sm90_plan_matches_the_kernel(cuda):
    """`ops.sh._tower_plan`'s shared memory (the CPU tests' plans) is the
    kernel's own at every (L, H); the combine's likewise."""
    from range_tpu_torch.kernels._build import load_kernel_library
    from range_tpu_torch.ops import retrieval_hier as rh

    lib = load_kernel_library("siren_tower_sm90")
    for L in range(2, 65):
        for H in (128, 256):
            assert lib.siren_tower_sm90_smem(L, H) == sh._tower_plan(1, L, H)["smem"]
    assert lib.siren_tower_sm90_smem(65, 256) == -1 and lib.siren_tower_sm90_smem(40, 192) == -1
    assert (load_kernel_library("combine_cat_sm90").combine_cat_sm90_smem()
            == rh._combine_plan(128, 1024, 896)["smem"])


def test_tower_wrapper_never_launches_the_f32_body_in_bf16(cuda, monkeypatch):
    """`csrc/siren_tower.cu`'s bf16 form stays only as chip_smoke.py's
    yardstick: the bf16 mode (every L, both widths, the flagship's encoder)
    loads the Hopper body's library alone; the f32 mode the f32 body's."""
    from range_tpu_torch.kernels import _build

    loaded = []
    real = _build.load_kernel_library

    def spy(name):
        loaded.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load_kernel_library", spy)
    for L, H in ((8, 128), (40, 256), (64, 128)):
        net = SirenNet(L * L, H, H, 2, device=cuda,
                       generator=torch.Generator(device=cuda).manual_seed(L))
        with torch.no_grad():
            sh.siren_tower(_coords(100, seed=L, device=cuda), L, net.tower_params(),
                           matmul_dtype=torch.bfloat16)
    enc = load_model("RANGE+", db_path="synthetic:5000", device="cuda", tower_matmul="bf16")
    enc(_coords(300, seed=2, device=cuda))
    torch.cuda.synchronize()
    assert "siren_tower_sm90" in loaded and "siren_tower" not in loaded
    loaded.clear()
    net = SirenNet(64, 128, 128, 2, device=cuda, generator=torch.Generator(device=cuda))
    with torch.no_grad():
        sh.siren_tower(_coords(100, seed=1, device=cuda), 8, net.tower_params())
    assert loaded == ["siren_tower"]


def test_tower_kernel_is_forward_only(cuda):
    """The kernel computes the forward alone: inputs that require grad still
    launch it once, and the backward is autograd through the plain compose
    `_siren_tower_ref` (the JAX custom_vjp's), for the coordinates and every
    layer's w and b; it launches nothing."""
    gen = torch.Generator(device=cuda).manual_seed(1)
    net = SirenNet(64, 128, 128, 2, device=cuda, generator=gen)
    ll = _coords(100, seed=1, device=cuda).requires_grad_(True)
    g = torch.randn(100, 128, generator=gen, device=cuda)
    inputs = [ll] + list(net.parameters())
    before = sh.siren_tower.launches
    got = torch.autograd.grad(sh.siren_tower(ll, 8, net.tower_params()), inputs, g)
    torch.cuda.synchronize()
    assert sh.siren_tower.launches == before + 1
    ref = torch.autograd.grad(sh._siren_tower_ref(ll, 8, net.tower_params()), inputs, g)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())


# f32: true f32 FMAs against cuBLAS f32 products, another summation order:
# within 1e-5 of each element's sum of |terms| (1,600 terms at L=40).
# bf16: the same operand rounding points; an f32 sum that lands near a bf16
# tie rounds the other way, one bf16 ulp of that term (`_within_terms`).
@pytest.mark.parametrize("B,L,D", [(777, 40, 256), (512, 40, 256), (300, 6, 96),
                                   (70, 64, 512), (33, 2, 32)])
@pytest.mark.parametrize("bf16", [False, True])
def test_sh_times_kernel_matches_plain(cuda, B, L, D, bf16):
    gen = torch.Generator(device=cuda).manual_seed(L + D)
    w = torch.randn(L * L, D, generator=gen, device=cuda) * 0.05
    ll = _coords(B, seed=L, device=cuda)
    md = torch.bfloat16 if bf16 else None
    before = sh.spherical_harmonics_times_fused.launches
    got = sh.spherical_harmonics_times_fused(ll, L, w, matmul_dtype=md)
    torch.cuda.synchronize()
    assert sh.spherical_harmonics_times_fused.launches == before + 1
    ref = sh._sh_times_plain(ll, L, w, matmul_dtype=md)
    mag = sh._sh_times_plain(ll, L, w, matmul_dtype=md, magnitude=True)
    assert got.shape == (B, D) and got.dtype == torch.float32
    if bf16:
        _within_terms(got, ref, mag)
    else:
        assert ((got - ref).abs() <= 1e-5 * mag + 1e-7).all()


@pytest.mark.parametrize("nc,ks", [(1, 1), (8, 1), (8, 20), (2, 40), (4, 7)])
def test_sh_times_kernel_plans_agree(cuda, nc, ks):
    """Every plan the launch accepts (NC column slices x KS runs of the
    recurrence rows, the runs' partial sums added in a second pass) gives
    the plain version's sums, at the f32 tolerance above."""
    import ctypes

    from range_tpu_torch.kernels._build import load_kernel_library

    B, L, D = 300, 40, 256
    gen = torch.Generator(device=cuda).manual_seed(nc + ks)
    w = torch.randn(L * L, D, generator=gen, device=cuda) * 0.05
    ll = _coords(B, seed=ks, device=cuda)
    wc, ws = sh._fold_first_layer(w, L, "analytic", torch.float32)
    ftabT = sh._fourier_table(L, torch.float32, cuda, transposed=True)
    out = torch.full((B, D), float("nan"), device=cuda)
    work = torch.full((ks, B, D), float("nan"), device=cuda)
    rc = load_kernel_library("sh_times").sh_times_launch(
        ll.data_ptr(), ftabT.data_ptr(), wc.data_ptr(), ws.data_ptr(), out.data_ptr(),
        work.data_ptr(), B, L, D, nc, ks, 0, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    ref = sh._sh_times_plain(ll, L, w)
    mag = sh._sh_times_plain(ll, L, w, magnitude=True)
    assert ((out - ref).abs() <= 1e-5 * mag + 1e-7).all()
    plan = (ctypes.c_int * 2)()
    assert load_kernel_library("sh_times").sh_times_plan(B, L, D, ctypes.addressof(plan)) == 0
    assert plan[0] == 8 and 1 <= plan[1] <= L  # the widest slice; runs fill the card


def test_sh_times_gradients_are_the_plain_compose(cuda):
    """`spherical_harmonics_times_fused`'s gradients for w and the
    coordinates equal those of `spherical_harmonics_times` for the same
    upstream gradient (its backward is that compose)."""
    L, D = 40, 256
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = (torch.randn(L * L, D, generator=gen, device=cuda) * 0.05).requires_grad_(True)
    ll = _coords(512, seed=5, device=cuda).requires_grad_(True)
    g = torch.randn(512, D, generator=gen, device=cuda)
    for md in (None, torch.bfloat16):
        got = torch.autograd.grad(sh.spherical_harmonics_times_fused(ll, L, w, matmul_dtype=md),
                                  (ll, w), g)
        ref = torch.autograd.grad(sh.spherical_harmonics_times(ll, L, w, matmul_dtype=md),
                                  (ll, w), g)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * b.abs().max().item())


def test_sh_times_kernel_rejects_bad_input(cuda):
    w = torch.zeros(64, 48, device=cuda)  # D not a multiple of 32
    with pytest.raises(ValueError, match="multiple of 32"):
        sh.spherical_harmonics_times_fused(torch.zeros(4, 2, device=cuda), 8, w)
    with pytest.raises(ValueError, match="float32"):
        sh.spherical_harmonics_times_fused(torch.zeros(4, 2, device=cuda, dtype=torch.float64),
                                           8, torch.zeros(64, 32, device=cuda))


def test_training_step_launches_sh_times_per_microbatch(cuda):
    """A SatCLIP train step on the card (a tiny ResNet, L=8 location tower)
    launches the SH-times kernel once per microbatch and the tower kernel
    never; its loss is finite."""
    from range_tpu_torch.models.resnet_std import StdResNetConfig
    from range_tpu_torch.models.satclip import SatClipLocationConfig
    from range_tpu_torch.train import satclip as tr

    gen = torch.Generator(device=cuda).manual_seed(6)
    model = tr.SatClipModel(tr.SatClipConfig(
        vision=StdResNetConfig(layers=(1, 1, 1, 1), width=8, in_channels=4, output_dim=32),
        location=SatClipLocationConfig(embed_dim=32, legendre_polys=8, capacity=64)),
        device=cuda, generator=gen)
    step = tr.make_train_step(model, tr.make_optimizer(1e-3), accum_steps=3)
    batch = {"image": torch.randn(24, 4, 32, 32, generator=gen, device=cuda),
             "point": _coords(24, seed=6, device=cuda)}
    sh.spherical_harmonics_times_fused.launches = 0
    sh.siren_tower.launches = 0
    loss = step(batch, gen)
    torch.cuda.synchronize()
    assert sh.spherical_harmonics_times_fused.launches == 3
    assert sh.siren_tower.launches == 0
    assert torch.isfinite(loss)


# Same logits up to summation order; a p that sits within that difference
# of a bf16 rounding boundary rounds the other way before the value
# product, moving the outputs of that row by one bf16 ulp (<= 2^-7
# relative) of one weight times at most max |v|.  Such rows are rare.
@pytest.mark.parametrize("tier", ["exact", "high", "fast"])
@pytest.mark.parametrize("mode", ["range+", "range"])
def test_fused_kernel_matches_plain(cuda, tier, mode):
    """A ragged batch (77) and a masked bank whose 3,003 rows are no
    multiple of the 32-row tile."""
    bank = GeoBank.synthetic(0, 3001, key_dim=256, value_dim=1024, pad_to=7,
                             value_dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(77, 256, generator=g, device=cuda)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    x = lonlat_deg_to_xyz(_coords(77, seed=2, device=cuda))
    temp, beta = (12.0, 0.5) if mode == "range+" else (15.0, 1.0)
    before, before_exact = rf.retrieve_fused.launches, rf.retrieve_fused.exact_launches
    got = rf.retrieve_pallas(q, x, bank, sem_temp=temp, mode=mode, tier=tier)
    q_cat = rf.pack_queries(q, x if mode == "range+" else None, temp, 40.0, tier)
    ref = rf._retrieve_fused_plain(
        q_cat, rf.pack_bank(bank.keys_sem, bank.xyz, tier), bank.values,
        (rf.NEG * (1 - bank.row_mask()))[None], beta,
        sem_d=rf.packed_dims(256, tier)[0])
    torch.cuda.synchronize()
    # bf16 tiers: the Hopper kernel; 'exact' (f32 operands): the mma.sync body
    assert rf.retrieve_fused.launches == before + (tier != "exact")
    assert rf.retrieve_fused.exact_launches == before_exact + (tier == "exact")
    err = (got - ref).abs()
    assert err.max() <= bank.values.abs().max().float() / 128
    assert (err > 1e-4).any(dim=1).sum() <= 2


# The bars of test_fused_kernel_matches_plain: the segments' partials are
# the one-pass sums re-associated in f32, well inside them.
@pytest.mark.parametrize("B", [1, 77, 1000])
def test_fused_sm90_kernel_over_segments(cuda, B):
    """A 30,001-row bank: several segments of the Hopper kernel's plan (the
    last one ragged), at a request too small to fill the card alone (B = 1,
    77) and at B = 1,000; fast tier, RANGE+."""
    bank = GeoBank.synthetic(5, 30_001, key_dim=256, value_dim=1024, pad_to=1,
                             value_dtype=torch.bfloat16, device=cuda)
    plan = rf._segment_plan(B, bank.num_rows, 1024, 256)
    assert plan.n_seg > 1 and bank.num_rows % plan.seg_rows
    g = torch.Generator(device=cuda).manual_seed(B)
    q = torch.nn.functional.normalize(torch.randn(B, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(max(B, 2), seed=B, device=cuda)[:B])
    q_cat = rf.pack_queries(q, x, 12.0, 40.0, "fast")
    k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, "fast")
    mask = (rf.NEG * (1 - bank.row_mask()))[None]
    before = rf.retrieve_fused.launches
    got = rf.retrieve_fused(q_cat, k_cat, bank.values, mask, 0.5, sem_d=256)
    torch.cuda.synchronize()
    assert rf.retrieve_fused.launches == before + 1
    ref = rf._retrieve_fused_plain(q_cat, k_cat, bank.values, mask, 0.5, sem_d=256)
    # the plan's form (flat at this tier) and the cluster form over its segments
    cluster = rf._segment_plan(B, bank.num_rows, 1024, 256, form="cluster")
    assert plan.cs == 0 and cluster.cs == 4 and cluster.n_seg > 1
    for out in (got, rf._launch_sm90(q_cat, k_cat, bank.values, mask, 0.5, 256, cluster)):
        err = (out - ref).abs()
        assert err.max() <= bank.values.abs().max().float() / 128
        assert (err > 1e-4).any(dim=1).sum() <= max(2, B // 100)


def test_fused_f32_operands_launch_the_exact_body(cuda):
    """f32 packed operands (the 'exact' tier) go to the mma.sync body, whose
    counter moves; the Hopper kernel's does not."""
    bank = GeoBank.synthetic(0, 500, key_dim=256, value_dim=128, pad_to=1,
                             value_dtype=torch.bfloat16, device=cuda)
    q = torch.nn.functional.normalize(torch.randn(9, 256, device=cuda), dim=1)
    before = (rf.retrieve_fused.launches, rf.retrieve_fused.exact_launches)
    out = rf.retrieve_pallas(q, None, bank, mode="range", tier="exact")
    torch.cuda.synchronize()
    assert out.shape == (9, 128) and torch.isfinite(out).all()
    assert (rf.retrieve_fused.launches, rf.retrieve_fused.exact_launches) == (
        before[0], before[1] + 1)


@pytest.mark.parametrize("case", ["sem_d", "Dv"])
def test_fused_sm90_rejects_a_shape_it_does_not_take(cuda, case):
    """Operands that no padding of the packer cures raise, with no launch
    and no fallback to the plain version: bf16 operands packed by hand
    whose semantic group is no whole number of 64-column boxes (the
    packer pads it on the card, `retrieve_fused` takes the operands as
    they are), and values of no whole 16-byte copy (Dv = 100)."""
    sem_d, Dv = (96, 64) if case == "sem_d" else (256, 100)
    q = torch.zeros(4, 384, dtype=torch.bfloat16, device=cuda)
    k = torch.zeros(6, 384, dtype=torch.bfloat16, device=cuda)
    values = torch.zeros(6, Dv, dtype=torch.bfloat16, device=cuda)
    before = (rf.retrieve_fused.launches, rf.retrieve_fused.exact_launches)
    with pytest.raises(ValueError, match="sem_d % 64" if case == "sem_d" else "Dv % 8"):
        rf.retrieve_fused(q, k, values, torch.zeros(1, 6, device=cuda), 0.5, sem_d=sem_d)
    assert (rf.retrieve_fused.launches, rf.retrieve_fused.exact_launches) == before


# The bars of test_fused_kernel_matches_plain.  The plain version runs on
# JAX's packing (no padded columns); a zero column adds exactly 0 to every
# logit, so the padded kernel's answer is the same sum.
@pytest.mark.parametrize("key_dim,tier", [(16, "fast"), (32, "fast"), (40, "fast"),
                                          (96, "fast"), (16, "high"), (32, "high"),
                                          (40, "high"), (96, "high"), (40, "exact")])
def test_fused_serves_key_widths_of_no_whole_box(cuda, key_dim, tier):
    """Dense banks whose key width is no multiple of 64 (of 16 at 40-d,
    'exact'), served through `retrieve_pallas` on the card: the packer pads
    the semantic columns (`packed_dims(card=True)`) and the tier's kernel
    launches once; the answer matches the plain version over JAX's
    packing."""
    bank = GeoBank.synthetic(0, 3001, key_dim=key_dim, value_dim=256, pad_to=7,
                             value_dtype=torch.bfloat16, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(key_dim)
    q = torch.nn.functional.normalize(torch.randn(77, key_dim, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(77, seed=3, device=cuda))
    before = (rf.retrieve_fused.launches, rf.retrieve_fused.exact_launches)
    got = rf.retrieve_pallas(q, x, bank, tier=tier)
    torch.cuda.synchronize()
    assert (rf.retrieve_fused.launches, rf.retrieve_fused.exact_launches) == (
        before[0] + (tier != "exact"), before[1] + (tier == "exact"))
    ref = rf._retrieve_fused_plain(
        rf.pack_queries(q, x, 12.0, 40.0, tier), rf.pack_bank(bank.keys_sem, bank.xyz, tier),
        bank.values, (rf.NEG * (1 - bank.row_mask()))[None], 0.5,
        sem_d=rf.packed_dims(key_dim, tier)[0])
    err = (got - ref).abs()
    assert err.max() <= bank.values.abs().max().float() / 128
    assert (err > 1e-4).any(dim=1).sum() <= 2


def test_fused_kernel_rejects_f32_values(cuda):
    q = torch.zeros(4, 384, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="bf16 values"):
        rf.retrieve_fused(q, q, torch.zeros(4, 8, device=cuda),
                          torch.zeros(1, 4, device=cuda), 0.5, sem_d=256)


def test_main_path_launches_both_kernels(cuda):
    """load_model on the card serves through both kernels; the answers stay
    within the fast tier's tolerance of the exact f32 retrieve
    (tests/test_retrieval_pallas.py: bf16 semantic logits)."""
    enc = load_model("RANGE+", db_path="synthetic:5000", chunk=1024)
    coords = _coords(300, seed=3, device=cuda)
    sh.siren_tower.launches = 0
    rf.retrieve_fused.launches = 0
    out = enc(coords)
    torch.cuda.synchronize()
    assert sh.siren_tower.launches == 1 and rf.retrieve_fused.launches == 1
    assert out.shape == (300, 1280) and torch.isfinite(out).all()
    ref = retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), enc.model.bank)
    torch.testing.assert_close(out[:, :1024], ref, rtol=1e-1, atol=5e-2)


def test_float64_numpy_coords_launch_the_tower_kernel(cuda):
    """numpy's float64 coordinates are cast to f32 at the entry point and
    go through the tower kernel; an f64 tensor on the card that reaches the
    tower directly raises instead of taking the plain compose."""
    enc = load_model("RANGE+", db_path="synthetic:2000", chunk=1024)
    rng = np.random.default_rng(4)
    c64 = np.stack([rng.uniform(-180, 180, 50), rng.uniform(-90, 90, 50)], 1)
    sh.siren_tower.launches = 0
    out = enc(c64)
    torch.cuda.synchronize()
    assert sh.siren_tower.launches == 1
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    with pytest.raises(TypeError, match="float32"):
        enc.model.query_encoder(torch.from_numpy(c64).to(cuda))


# ---- the hierarchical flagship slice: scan, family parts, combine


@pytest.fixture
def hier_bank(cuda):
    """A small informative bank built on the card with the flagship knobs
    cut to bn=128 (value width 1024, so every kernel sees its real widths)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 9000, pad_to=512,
                                         value_dtype=torch.bfloat16, device=cuda)
    return rh.build_hier_bank(bank, bn=128, gsz_sem=16, gsz_geo=16, lr_rank=256,
                              lr_geo=384, res_rank=128, topk_gsz=8)


def _within_terms(got, ref, mag, frac=4e-3, rows_off_max=0):
    """|got - ref| <= min(frac * the row's max |ref|, 2^-7 * mag) + 1e-6, with
    mag the sum of each element's terms' magnitudes (the plain version over
    |operands|): one bf16 ulp (<= 2^-7) of every term bounds each element by
    its own terms, small low-rank columns included.  Up to ``rows_off_max``
    rows may exceed the row cap, each element within 2^-7 * mag: a weight at
    a bf16 rounding boundary that rounds the other way moves its element by
    one ulp of that term, over the cap where that one term dominates the
    row (ROADMAP Queue 3, "bf16 flips of a dominant term")."""
    err = (got - ref).abs()
    flip = 2.0 ** -7 * mag + 1e-6
    tol = torch.minimum(frac * ref.abs().amax(dim=1, keepdim=True), flip - 1e-6) + 1e-6
    over = (err > tol).any(dim=1)
    assert int(over.sum()) <= rows_off_max
    assert (err <= torch.where(over[:, None], flip, tol)).all()


# Tolerances: the logits are f32 sums of the same bf16 products in another
# order (~1e-6 relative); an exp2 that this moves across a bf16 boundary
# rounds the other way before a value product, one bf16 ulp of that one
# term (`_within_terms`).  The combine is f32 products in another order.
def test_hier_kernels_match_plain(cuda, hier_bank):
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    B, bm = 700, 128  # a ragged batch: 768 padded rows, 6 selection blocks
    g = torch.Generator(device=cuda).manual_seed(5)
    q = torch.nn.functional.normalize(torch.randn(B, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(B, seed=5, device=cuda))
    q_s, q_x = rh._pad_queries(q, x, bm)
    order = rh._hybrid_order(q_x, B)
    q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, "fast")[order].contiguous()
    scan_args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw_lr)
    n0 = (rh._hier_scan_call.launches, rh._hier_parts_family_call.launches,
          rh._combine_cat_call.launches)
    got = rh._hier_scan_call(*scan_args, gpt_s=8, gpt_g=8)
    ref = rh._hier_scan_plain(*scan_args, gpt_s=8, gpt_g=8)
    for i in (0, 2):
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=1e-4)
    for i in (1, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-4, atol=0)
    mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(),
                              hb.g_geo_vw_lr.abs(), gpt_s=8, gpt_g=8)[4]
    for cols in (slice(0, 384), slice(384, None)):  # sem, geo
        _within_terms(got[4][:, cols], ref[4][:, cols], mag[:, cols])
    m_s, s_s, m_g, s_g, tails = ref
    parts = []
    for geo, k, g_cat, vw, z, lrr in ((False, 24, hb.g_sem_cat, hb.g_sem_vw_lr, hb.z_sem, 256),
                                       (True, 12, hb.g_geo_cat, hb.g_geo_vw_lr, hb.z_geo, 384)):
        stats = (m_g, s_g, m_s, s_s) if geo else (m_s, s_s, m_g, s_g)
        idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=k, bm=bm, n_valid=B,
                                 mode="range")
        args = (q_cat, hb.k_cat, hb.mask_neg, idx, g_cat, vw, z)
        kw = dict(sem_d=256, bm=bm, bn=128, gpt=8, geo=geo, lrr=lrr)
        got = rh._hier_parts_family_call(*args, **kw)
        ref = rh._hier_parts_family_plain(*args, **kw)
        mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
        for cols in (slice(0, 128), slice(256, None)):  # az, alr
            _within_terms(got[:, cols], ref[:, cols], mag[:, cols])
        assert not got[:, 128:256].any()
        parts.append(ref)
    q_srt = torch.nn.functional.pad(q, (0, 0, 0, 768 - B))[order].contiguous()
    ck = dict(Ws=384, r=256, rrp=128, Dv=1024, beta=0.5, rg=384, Wg=512)
    c_args = (*parts, tails, q_srt, hb.w_sem, hb.u_sem, hb.w_geo, hb.u_geo)
    ref = rh._combine_cat_plain(*c_args, **ck)
    # both bodies: the TF32-split Hopper body (fast / high) and the f32 one (exact)
    for tier in ("fast", "exact"):
        torch.testing.assert_close(rh._combine_cat_call(*c_args, **ck, tier=tier), ref,
                                   rtol=1e-5, atol=1e-5)
    torch.cuda.synchronize()
    assert (rh._hier_scan_call.launches, rh._hier_parts_family_call.launches,
            rh._combine_cat_call.launches) == (n0[0] + 1, n0[1] + 2, n0[2] + 2)


def test_hier_kernels_reject_f32_operands(cuda, hier_bank):
    """The Hopper scan takes bf16 operands only: f16 ones raise before any
    launch, and f32 ones (the exact tier's) take the CUDA-core body."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    q = torch.zeros(128, 384, device=cuda)
    n0 = rh._hier_scan_call.launches
    with pytest.raises(ValueError, match="bfloat16"):
        rh._hier_scan_call(q.half(), hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr,
                           hb.g_geo_vw_lr, gpt_s=8, gpt_g=8)
    with pytest.raises(ValueError, match="bfloat16"):
        rh._launch_scan_sm90(q, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw_lr,
                             gpt_s=8, gpt_g=8)
    assert rh._hier_scan_call.launches == n0
    f0 = rh._hier_scan_call.f32_launches
    rh._hier_scan_call(q, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw_lr,
                       gpt_s=8, gpt_g=8)
    torch.cuda.synchronize()
    assert rh._hier_scan_call.f32_launches == f0 + 1


def test_flagship_main_path_launches_the_hier_kernels(cuda, hier_bank):
    """load_model(profile="flagship") on the card: one scan, two parts and
    one combine launch per request, within the fidelity bars' order of the
    exact f32 retrieve (a small bank and a global batch: the bars
    themselves are for the 100k bank at B=10,000, chip_smoke.py)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    enc = load_model("RANGE+", db_path=hier_bank, profile="flagship", hier_bn=128,
                     gsz_geo=16)
    coords = _coords(3000, seed=6, device=cuda)
    c = rh._combine_cat_call
    count = lambda: (rh._hier_scan_call.launches, rh._hier_parts_family_call.launches,  # noqa
                     c.launches, c.exact_launches, sh.siren_tower.launches,
                     sh.siren_tower.bf16_launches)
    n0 = count()
    out = enc(coords)
    torch.cuda.synchronize()
    # the tower and the combine on their Hopper bodies, once each
    assert [a - b for a, b in zip(count(), n0)] == [1, 2, 1, 0, 1, 1]
    assert out.shape == (3000, 1280) and torch.isfinite(out).all()
    ref = retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), hier_bank.bank)
    rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.mean() < 0.1


# ---- the top-k endpoint: stats scan, argmax, k-carry top-k, exact_nn

# Tolerances: the stats as above.  The hi/lo logits (|l| <= ~1, cosines)
# are f32 sums of 768 bf16 products, in the kernel's tensor-core order and
# cuBLAS's: scores within 1e-5, rows equal wherever the rival rows' logits
# are more than 1e-5 apart.
KLIST_TOL = 1e-5


def _klist_operands(hb, B, bm, k_tiles, device):
    """Hi/lo queries of B random unit vectors, geo-sorted, and the tiles
    `hier_topk` would select (stats over g_topk_cat, mode 'range')."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    g = torch.Generator(device=device).manual_seed(7)
    q = torch.nn.functional.normalize(torch.randn(B, 256, generator=g, device=device), dim=1)
    x = lonlat_deg_to_xyz(_coords(B, seed=7, device=device))
    q_s, q_x = rh._pad_queries(q, x, bm)
    order = rh._hybrid_order(q_x, B)
    q_cat = rf.pack_queries(q_s, None, 12.0, 40.0, "fast")[order].contiguous()
    qh, ql = rf._split_hilo(q_s)
    q2 = torch.cat([qh, qh], 1)[order].contiguous()
    stats = rh._hier_scan_stats_plain(q_cat, hb.g_topk_cat, hb.g_geo_cat, gpt_s=16, gpt_g=8)
    idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=k_tiles, bm=bm, n_valid=B,
                             j_sem=6, mode="range")
    return q_cat, q2, ql[order].contiguous(), idx


def _row_logits(q2, ql, khl, mask, rows):
    """f64 hi/lo logits of rows [Bp, k] of each query."""
    kr = khl[rows.long()].double()
    Dk = ql.shape[1]
    return ((q2.double()[:, None, :] * kr).sum(-1)
            + (ql.double()[:, None, :] * kr[..., :Dk]).sum(-1) + mask[0, rows.long()].double())


@pytest.mark.parametrize("operand,gpt", [("g_topk_cat", 16), ("g_sem_cat", 8), ("rand64", 64),
                                         ("rand32", 32)])
def test_scan_stats_kernel_matches_plain(cuda, hier_bank, operand, gpt):
    """The bank's operands, and random ones with the flagship's 64 and 32
    groups per tile at bn = 512; a ragged batch (700 of 768 rows)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    q_cat = _klist_operands(hb, 700, 128, 24, cuda)[0]
    if operand.startswith("rand"):
        g = torch.Generator(device=cuda).manual_seed(gpt)
        gs = (0.1 * torch.randn(8 * gpt, 256, generator=g, device=cuda)).bfloat16()
        gg = (0.5 * torch.randn(64, 128, generator=g, device=cuda)).bfloat16()
        q_cat = torch.randn(q_cat.shape, generator=g, device=cuda).bfloat16()
    else:
        gs, gg = getattr(hb, operand), hb.g_geo_cat
    n0 = rh._hier_scan_stats_call.launches
    got = rh._hier_scan_stats_call(q_cat, gs, gg, gpt_s=gpt, gpt_g=8)
    ref = rh._hier_scan_stats_plain(q_cat, gs, gg, gpt_s=gpt, gpt_g=8)
    torch.cuda.synchronize()
    assert rh._hier_scan_stats_call.launches == n0 + 1
    for i in (0, 2):
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=1e-4)
    for i in (1, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-4, atol=0)


def test_scan_stats_kernel_equals_the_fused_scans_stats(cuda, hier_bank):
    """hier_nn reads the stats-only kernel where JAX reads the fused scan:
    on the same operands the two kernels' stats agree to summation order."""
    from range_tpu_torch.ops import retrieval_hier as rh

    from range_tpu_torch.ops import retrieval_fused as rf

    hb = hier_bank
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.nn.functional.normalize(torch.randn(768, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(768, seed=8, device=cuda))
    q_cat = rf.pack_queries(q, x, 12.0, 40.0, "fast")
    got = rh._hier_scan_stats_call(q_cat, hb.g_sem_cat, hb.g_geo_cat, gpt_s=8, gpt_g=8)
    ref = rh._hier_scan_call(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr,
                             hb.g_geo_vw_lr, gpt_s=8, gpt_g=8)
    for i in (0, 2):
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=1e-4)
    for i in (1, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-4, atol=0)


@pytest.mark.parametrize("k", [1, 2, 5, 8])
def test_klist_kernels_match_plain(cuda, hier_bank, k):
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    _, q2, ql, idx = _klist_operands(hb, 700, 128, 24, cuda)
    args = (q2, ql, hb.khl_sem, hb.mask_neg, idx)
    kw = dict(Dk=256, bm=128, bn=128)
    n0 = (rh._hier_argmax_call.launches, rh._hier_topk_call.launches)
    if k == 1:
        (gs, gr), (rs, rr) = rh._hier_argmax_call(*args, **kw), rh._hier_argmax_plain(*args, **kw)
        gs, gr, rs, rr = gs[:, None], gr[:, None], rs[:, None], rr[:, None]
    else:
        gs, gr = rh._hier_topk_call(*args, k=k, **kw)
        rs, rr = rh._hier_topk_plain(*args, k=k, **kw)
    torch.cuda.synchronize()
    assert (rh._hier_argmax_call.launches, rh._hier_topk_call.launches) == \
        (n0[0] + (k == 1), n0[1] + (k > 1))
    assert gr.dtype == torch.int32 and gr.shape == rr.shape == (768, k)
    torch.testing.assert_close(gs, rs, rtol=0, atol=KLIST_TOL)
    off = gr != rr
    rival = _row_logits(q2, ql, hb.khl_sem, hb.mask_neg, gr)
    assert not (off & ((rival - rs.double()).abs() > KLIST_TOL)).any()


def _klist_call(args, kw, k, plan=None, sort=True):
    """The new body's list through `_klist_kernel` (``plan`` overrides the
    segments) and the plain version's, both [Bp, k]; ``sort``: each sorted
    as the wrappers sort it (a near-tie between two minima of a running
    list moves the next entry to the other one's slot, so only the sorted
    lists compare on random data)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    entry = "hier_argmax_sm90_launch" if k == 1 else "hier_topk_sm90_launch"
    got = rh._klist_kernel(entry, *args, k=k, plan=plan, **kw)
    ref = rh._hier_klist_plain(*args, k=k, **kw)
    return (rh._sort_klist(*got), rh._sort_klist(*ref)) if sort else (got, ref)


def _klist_random(cuda, *, nB, bm, bn, Dk, K, T, seed):
    """Hi/lo operands of random unit queries and keys (a tenth of the rows
    masked), nB blocks of bm queries, T tiles of bn rows, each block's K
    distinct tiles in random order."""
    from range_tpu_torch.ops import retrieval_fused as rf

    g = torch.Generator(device=cuda).manual_seed(seed)

    def unit(n):
        return torch.nn.functional.normalize(torch.randn(n, Dk, generator=g, device=cuda), dim=1)

    qh, ql = rf._split_hilo(unit(nB * bm))
    kh, kl = rf._split_hilo(unit(T * bn))
    mask = torch.where(torch.rand(1, T * bn, generator=g, device=cuda) < 0.1, -1e30, 0.0)
    idx = torch.stack([torch.randperm(T, generator=g, device=cuda)[:K] for _ in range(nB)])
    return (torch.cat([qh, qh], 1).contiguous(), ql.contiguous(),
            torch.cat([kh, kl], 1).contiguous(), mask, idx.to(torch.int32))


# (bm, bn, Dk, K, T): every bm, bn, Dk and K of the issue's grid at least
# once: the selection block sizes, tiles of one masked step (32), one and a
# half steps (96) and eight (512), key widths of a short box (48), of no
# whole box or k16 step (200) and the endpoint's (256)
KLIST_SHAPES = [(64, 32, 48, 1, 3), (128, 96, 200, 24, 30), (256, 512, 256, 144, 150),
                (64, 512, 200, 24, 24), (128, 32, 256, 144, 160), (256, 96, 48, 24, 40),
                (128, 512, 48, 1, 2), (64, 96, 256, 144, 144)]


@pytest.mark.parametrize("k", range(1, 9))
@pytest.mark.parametrize("shape", KLIST_SHAPES, ids=lambda s: "bm{}-bn{}-Dk{}-K{}-T{}".format(*s))
def test_klist_sm90_matches_plain(cuda, shape, k):
    """The Hopper body at each shape of the grid, over its plan's segments
    and over one segment a tile: scores within KLIST_TOL of the plain
    version's, rows equal outside near-ties."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bm, bn, Dk, K, T = shape
    args = _klist_random(cuda, nB=3, bm=bm, bn=bn, Dk=Dk, K=K, T=T, seed=100 * k + Dk)
    kw = dict(Dk=Dk, bm=bm, bn=bn)
    plan = rh._klist_plan(3 * bm, bm, K, bn, Dk, k)
    for p in (plan, plan._replace(n_seg=K)):
        (gs, gr), (rs, rr) = _klist_call(args, kw, k, p)
        torch.cuda.synchronize()
        assert gr.dtype == torch.int32 and gr.shape == rr.shape == (3 * bm, k)
        torch.testing.assert_close(gs, rs, rtol=0, atol=KLIST_TOL)
        rival = _row_logits(args[0], args[1], args[2], args[3], gr)
        assert not ((gr != rr) & ((rival - rs.double()).abs() > KLIST_TOL)).any()


# keys wider than 256 columns (passes of 128): 264 (a partial last box), 384,
# 512, at each selection block size and a tile of a masked last step
KLIST_WIDE_SHAPES = [(128, 512, 264, 24, 30), (256, 96, 384, 24, 40), (64, 512, 512, 24, 24),
                     (128, 96, 512, 144, 150), (256, 512, 264, 1, 2)]


@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("shape", KLIST_WIDE_SHAPES,
                         ids=lambda s: "bm{}-bn{}-Dk{}-K{}-T{}".format(*s))
def test_klist_sm90_wide_keys(cuda, shape, k):
    """Keys of 264, 384 and 512 columns: each step's logits in passes of
    128 columns (the pass's kh and kl through the ring, its qh fragments
    loaded for it, one accumulator), over the plan's segments and one
    segment a tile:
    scores within KLIST_TOL of the plain version's, rows equal outside
    near-ties; the argmax and the top-k through their wrappers, one count
    each."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bm, bn, Dk, K, T = shape
    args = _klist_random(cuda, nB=3, bm=bm, bn=bn, Dk=Dk, K=K, T=T, seed=100 * k + Dk)
    kw = dict(Dk=Dk, bm=bm, bn=bn)
    plan = rh._klist_plan(3 * bm, bm, K, bn, Dk, k)
    assert rh._klist_smem(plan.bmb, Dk, plan.S) <= rh._SM90_MAX_SMEM
    for p in (plan, plan._replace(n_seg=K)):
        (gs, gr), (rs, rr) = _klist_call(args, kw, k, p)
        torch.cuda.synchronize()
        assert gr.dtype == torch.int32 and gr.shape == rr.shape == (3 * bm, k)
        torch.testing.assert_close(gs, rs, rtol=0, atol=KLIST_TOL)
        rival = _row_logits(args[0], args[1], args[2], args[3], gr)
        assert not ((gr != rr) & ((rival - rs.double()).abs() > KLIST_TOL)).any()
    fn = rh._hier_argmax_call if k == 1 else rh._hier_topk_call
    n0 = fn.launches
    got = fn(*args, **kw) if k == 1 else fn(*args, k=k, **kw)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1 and got[1].shape[0] == 3 * bm


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("form", ["base", "bn96", "segments"])
def test_klist_kernels_tie_rules(cuda, k, form):
    """Duplicated key rows within and across the selected tiles and masked
    rows, on dyadic operands whose logits are exact in any order: rows and
    scores equal the plain version's exactly (lowest in-tile index, strict >
    across tiles, the list's first minimum, the stable final sort).  Forms:
    64-row tiles; 96-row tiles under a 128-query block (a masked last step,
    both warpgroups); and one segment a tile, so the fold alone carries the
    list from tile to tile, with every row of one tile masked."""
    from range_tpu_torch.ops import retrieval_hier as rh

    rng = np.random.default_rng(30 + k)
    Dk, bn, bm, nB, nT, K = 64, 64, 64, 3, 6, 4
    if form == "bn96":
        Dk, bn, bm, nB, nT, K = 48, 96, 128, 2, 9, 7
    pick = rng.integers(0, 4, nT * bn)
    khl = np.concatenate([rng.choice([-0.5, 0.0, 0.5], (4, Dk))[pick],
                          rng.choice([-2.0 ** -8, 0.0, 2.0 ** -8], (4, Dk))[pick]], 1)
    mask = np.where(rng.uniform(size=(1, nT * bn)) < 0.1, -1e30, 0.0)
    if form == "segments":
        mask[0, 2 * bn:3 * bn] = -1e30  # tile 2: every row masked
    qh = rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0], (nB * bm, Dk))
    ql = rng.choice([-2.0 ** -9, 0.0, 2.0 ** -9], (nB * bm, Dk))
    idx = np.stack([rng.permutation(nT)[:K] for _ in range(nB)])
    if form == "segments":
        idx[:, 1] = 2

    def dev(a, dtype):
        return torch.from_numpy(np.asarray(a, np.float64)).to(cuda, dtype)

    args = (dev(np.concatenate([qh, qh], 1), torch.bfloat16), dev(ql, torch.bfloat16),
            dev(khl, torch.bfloat16), dev(mask, torch.float32),
            torch.from_numpy(idx.astype(np.int32)).to(cuda))
    kw = dict(Dk=Dk, bm=bm, bn=bn)
    if form == "segments":
        plan = rh._klist_plan(nB * bm, bm, K, bn, Dk, k)._replace(n_seg=K)
        got, ref = _klist_call(args, kw, k, plan, sort=False)
    elif k == 1:
        got, ref = rh._hier_argmax_call(*args, **kw), rh._hier_argmax_plain(*args, **kw)
    else:
        got, ref = rh._hier_topk_call(*args, k=k, **kw), rh._hier_topk_plain(*args, k=k, **kw)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_klist_sm90_rejects_shapes_before_a_launch(cuda):
    """Shapes the Hopper body does not take raise ValueError before any
    launch: key widths of no multiple of 8 (260, 12) or over 512, a query
    block of no multiple of 64, tiles of no multiple of 32 rows, k outside
    1..8, an empty list; no launch count moves."""
    from range_tpu_torch.ops import retrieval_hier as rh

    counts = (rh._hier_argmax_call.launches, rh._hier_topk_call.launches)
    cases = [dict(Dk=260), dict(Dk=12), dict(Dk=520), dict(bm=96), dict(bn=48), dict(k=9),
             dict(k=0), dict(K=0)]
    for case in cases:
        c = dict(dict(bm=64, bn=64, Dk=64, K=2, k=2), **case)
        Dk, bm, bn = c["Dk"], c["bm"], c["bn"]
        q2 = torch.zeros(2 * bm, 2 * Dk, dtype=torch.bfloat16, device=cuda)
        ql = torch.zeros(2 * bm, Dk, dtype=torch.bfloat16, device=cuda)
        khl = torch.zeros(4 * bn, 2 * Dk, dtype=torch.bfloat16, device=cuda)
        mask = torch.zeros(1, 4 * bn, device=cuda)
        idx = torch.zeros(2 * bm // max(bm, 1), c["K"], dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="unsupported shapes"):
            if c["k"] == 1:
                rh._hier_argmax_call(q2, ql, khl, mask, idx, Dk=Dk, bm=bm, bn=bn)
            else:
                rh._hier_topk_call(q2, ql, khl, mask, idx, Dk=Dk, k=c["k"], bm=bm, bn=bn)
    assert (rh._hier_argmax_call.launches, rh._hier_topk_call.launches) == counts


def test_klist_wrappers_never_launch_the_mma_sync_body(cuda, monkeypatch):
    """`csrc/hier_argmax.cu` stays only as chip_smoke.py's yardstick: the
    argmax and every k of the top-k, at every bm, load the Hopper body's
    library alone."""
    from range_tpu_torch.kernels import _build
    from range_tpu_torch.ops import retrieval_hier as rh

    loaded = []
    real = _build.load_kernel_library

    def spy(name):
        loaded.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load_kernel_library", spy)
    for bm in (64, 128, 256):
        args = _klist_random(cuda, nB=2, bm=bm, bn=128, Dk=256, K=5, T=8, seed=bm)
        rh._hier_argmax_call(*args, Dk=256, bm=bm, bn=128)
        for k in range(2, 9):
            rh._hier_topk_call(*args, Dk=256, k=k, bm=bm, bn=128)
    torch.cuda.synchronize()
    assert set(loaded) == {"hier_argmax_sm90"}


def test_klist_and_stats_kernels_reject_f32_operands(cuda, hier_bank):
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    q = torch.zeros(128, 384, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):  # f32 takes the CUDA-core body
        rh._hier_scan_stats_call(q.half(), hb.g_topk_cat, hb.g_geo_cat, gpt_s=16, gpt_g=8)
    q2, ql = torch.zeros(128, 512, device=cuda), torch.zeros(128, 256, device=cuda)
    idx = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    for call in (rh._hier_argmax_call, rh._hier_topk_call):
        extra = {} if call is rh._hier_argmax_call else {"k": 4}
        with pytest.raises(ValueError, match="bfloat16"):
            call(q2, ql, hb.khl_sem, hb.mask_neg, idx, Dk=256, bm=128, bn=128, **extra)


def test_hier_topk_launches_and_recall(cuda, hier_bank):
    """hier_topk on the card: one stats and one argmax launch for k = 1,
    one stats and one top-k launch for k = 4; recall@1 against exact_nn
    with every tile selected is 1 up to near-ties."""
    from range_tpu_torch.ops import retrieval_hier as rh
    from range_tpu_torch.ops.retrieval import exact_nn

    hb = hier_bank
    g = torch.Generator(device=cuda).manual_seed(9)
    q = torch.nn.functional.normalize(torch.randn(3000, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(3000, seed=9, device=cuda))
    counters = (rh._hier_scan_stats_call, rh._hier_argmax_call, rh._hier_topk_call)
    for k, want in ((1, (1, 1, 0)), (4, (1, 0, 1))):
        n0 = [c.launches for c in counters]
        rows = rh.hier_topk(q, x, hb, k=k, k_tiles=hb.t_real)
        torch.cuda.synchronize()
        assert tuple(c.launches - n for c, n in zip(counters, n0)) == want
        assert rows.shape == ((3000,) if k == 1 else (3000, k))
    true = exact_nn(q, hb.bank)
    assert (rh.hier_topk(q, x, hb, k_tiles=hb.t_real) == true).float().mean() >= 0.999


def test_exact_nn_ignores_the_tf32_flag(cuda, hier_bank):
    """exact_nn forces true f32: the same rows with TF32 switched on
    globally, and the flag restored after the call."""
    from range_tpu_torch.ops.retrieval import exact_nn

    g = torch.Generator(device=cuda).manual_seed(10)
    q = torch.nn.functional.normalize(torch.randn(2000, 256, generator=g, device=cuda), dim=1)
    ref = exact_nn(q, hier_bank.bank)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = exact_nn(q, hier_bank.bank)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, ref)


# ---- hierarchical RANGE (the merged parts kernel) and int8 values


def _quantized(cuda, hb):
    """The same bank's int8 HierBank, built on the card."""
    from range_tpu_torch.bank import quantize_values
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 9000, pad_to=512, value_dtype=torch.bfloat16,
                                         device=cuda)
    return rh.build_hier_bank(quantize_values(bank), bn=128, gsz_sem=16, gsz_geo=16,
                              lr_rank=256, lr_geo=384, res_rank=128, topk_gsz=8)


# Same logits up to summation order; a p (times its row's scale) that this
# moves across a bf16 rounding boundary rounds the other way before the
# value product: one bf16 ulp of one weight times at most max |v|, in rare
# rows (the dense kernel's rule).
@pytest.mark.parametrize("tier", ["exact", "fast"])
@pytest.mark.parametrize("mode", ["range+", "range"])
def test_int8_fused_kernel_matches_plain(cuda, tier, mode):
    """A ragged batch (77) and a masked bank whose 3,003 rows are no
    multiple of the 32-row tile, with int8 values."""
    from range_tpu_torch.bank import dequantize_values, quantize_values

    bank = quantize_values(GeoBank.synthetic(0, 3001, key_dim=256, value_dim=1024, pad_to=7,
                                             device=cuda))
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.nn.functional.normalize(torch.randn(77, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(77, seed=2, device=cuda))
    temp, beta = (12.0, 0.5) if mode == "range+" else (15.0, 1.0)
    i8 = rf.retrieve_fused_i8
    n0 = (rf.retrieve_fused.launches, i8.launches, i8.exact_launches)
    got = rf.retrieve_pallas(q, x, bank, sem_temp=temp, mode=mode, tier=tier)
    q_cat = rf.pack_queries(q, x if mode == "range+" else None, temp, 40.0, tier)
    ref = rf._retrieve_fused_plain(
        q_cat, rf.pack_bank(bank.keys_sem, bank.xyz, tier), bank.values,
        (rf.NEG * (1 - bank.row_mask()))[None], beta, bank.value_scale,
        sem_d=rf.packed_dims(256, tier)[0])
    torch.cuda.synchronize()
    # bf16 operands: the Hopper kernel; 'exact' (f32 operands): the mma.sync body
    assert (rf.retrieve_fused.launches, i8.launches, i8.exact_launches) == (
        n0[0], n0[1] + (tier != "exact"), n0[2] + (tier == "exact"))
    err = (got - ref).abs()
    assert err.max() <= dequantize_values(bank).abs().max() / 128
    assert (err > 1e-4).any(dim=1).sum() <= 2


def _merged_operands(hb, cuda, B=700, bm=128, k_tiles=24):
    """Packed queries with their locations (both families live), geo
    sorted, and the merged path's selection over the plain stats."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.nn.functional.normalize(torch.randn(B, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(B, seed=11, device=cuda))
    q_s, q_x = rh._pad_queries(q, x, bm)
    q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, "fast")[rh._hybrid_order(q_x, B)].contiguous()
    stats = rh._hier_scan_stats_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, gpt_s=8, gpt_g=8)
    idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=k_tiles, bm=bm, n_valid=B)
    return q_cat, idx


@pytest.mark.parametrize("geo", [True, False], ids=["geo", "no_geo"])
@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_merged_parts_kernel_matches_plain(cuda, hier_bank, geo, quant):
    """The merged parts kernel (lr variant) against its plain version: all
    2 Dv + 2 + Ws columns with the geo family, the read ones (acc_s, d_s,
    alr) without it and the geo columns then zero.  Tolerances as the
    other parts kernel (`_within_terms`); the sums d are f32 sums of f32
    exponentials in another order."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank if quant == "bf16" else _quantized(cuda, hier_bank)
    q_cat, idx = _merged_operands(hb, cuda)
    args = (q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx, hb.g_sem_cat,
            hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw)
    kw = dict(sem_d=256, bm=128, bn=128, gpt_s=8, gpt_g=8, geo=geo)
    n0 = rh._hier_parts_call.launches
    got = rh._hier_parts_call(*args, **kw)
    ref = rh._hier_parts_plain(*args, **kw)
    mag = rh._hier_parts_plain(*args, **kw, magnitude=True)
    torch.cuda.synchronize()
    assert rh._hier_parts_call.launches == n0 + 1
    assert got.shape == (768, 2 * 1024 + 128 + 384)
    segs = [slice(0, 1024), slice(2048, 2049), slice(2176, None)]
    if geo:
        segs += [slice(1024, 2048), slice(2049, 2050)]
    else:
        assert not got[:, 1024:2048].any() and not got[:, 2049].any()
    assert not got[:, 2050:2176].any()
    for cols in segs:
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols])


def test_scan_without_geo_matches_plain(cuda, hier_bank):
    """The geo-less scan launch (RANGE mode: the full-width geo operand is
    passed and not touched): m_s, s_s and the sem tail against the plain
    version, and the sem stats equal to the two-family launch's."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    q_cat, _ = _merged_operands(hb, cuda)
    args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw)
    n0 = rh._hier_scan_call.launches
    got = rh._hier_scan_call(*args, gpt_s=8, gpt_g=8, has_geo=False)
    ref = rh._hier_scan_plain(*args, gpt_s=8, gpt_g=8, has_geo=False)
    mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(),
                              hb.g_geo_vw, gpt_s=8, gpt_g=8, has_geo=False)[4]
    both = rh._hier_scan_call(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr,
                              hb.g_geo_vw_lr, gpt_s=8, gpt_g=8)
    torch.cuda.synchronize()
    assert rh._hier_scan_call.launches == n0 + 2
    assert got[2] is None and got[4].shape == (768, 384)
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=0)
    _within_terms(got[4], ref[4], mag)
    assert torch.equal(got[0], both[0]) and torch.equal(got[1], both[1])


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_range_flagship_main_path_launches(cuda, hier_bank, quant):
    """load_model("RANGE", profile="flagship") on the card: one stats scan
    (the home-tile sort), one geo-less scan and one merged parts launch
    per request, no family parts and no combine; int8 within relerr 0.01
    of bf16 (`tests/test_hier.py:139-149`)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    encs = {k: load_model("RANGE", db_path=hb, profile="flagship", hier_bn=128, gsz_geo=16,
                          value_quant="int8" if k == "int8" else None)
            for k, hb in (("bf16", hier_bank), ("int8", _quantized(cuda, hier_bank)))}
    coords = _coords(3000, seed=12, device=cuda)
    counters = (rh._hier_scan_stats_call, rh._hier_scan_call, rh._hier_parts_call,
                rh._hier_parts_family_call, rh._combine_cat_call, sh.siren_tower)
    n0 = [c.launches for c in counters]
    out = encs[quant](coords)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, n0)] == [1, 1, 1, 0, 0, 1]
    assert out.shape == (3000, 1280) and torch.isfinite(out).all()
    torch.testing.assert_close(out[:, 1024:], encs["bf16"](coords)[:, 1024:])
    if quant == "int8":
        ref = encs["bf16"](coords)[:, :1024]
        rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
        assert rel.mean() < 0.01


def test_int8_dense_main_path(cuda):
    """value_quant="int8" on the dense path: the int8 kernel, once per
    request, within the fast tier's tolerance of the exact f32 retrieve
    over the dequantized bank (tests/test_retrieval_pallas.py:47)."""
    enc = load_model("RANGE+", db_path="synthetic:5000", chunk=1024, value_quant="int8")
    coords = _coords(300, seed=13, device=cuda)
    i8 = rf.retrieve_fused_i8
    n0 = (rf.retrieve_fused.launches, i8.launches, i8.exact_launches)
    out = enc(coords)
    torch.cuda.synchronize()
    assert (rf.retrieve_fused.launches, i8.launches, i8.exact_launches) == (
        n0[0], n0[1] + 1, n0[2])
    assert enc.model.bank.values.dtype == torch.int8
    ref = retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), enc.model.bank)
    torch.testing.assert_close(out[:, :1024], ref, rtol=1e-1, atol=5e-2)


# ---- the two-level top-k (the refine kernel) and tail_super (the corr
# kernel and the scan's segment-sum variant)


def _tail_super_bank(cuda, tail_super):
    """The hier_bank fixture's bank and knobs with tail_super, built on the
    card (bn=128, gsz_sem=16: sup_r = tail_super / 16)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 9000, pad_to=512, value_dtype=torch.bfloat16,
                                         device=cuda)
    return rh.build_hier_bank(bank, bn=128, gsz_sem=16, gsz_geo=16, lr_rank=256, lr_geo=384,
                              res_rank=128, topk_gsz=8, tail_super=tail_super)


@pytest.fixture
def two_level_bank(cuda):
    """The informative bank with two-level knobs (bn=128, gsz_sem=8,
    gsz_super=16: 8 supergroups of 2 fine groups a tile), built on the card."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 9000, pad_to=512, value_dtype=torch.bfloat16,
                                         device=cuda)
    return rh.build_hier_bank(bank, bn=128, gsz_sem=8, gsz_geo=16, gsz_super=16)


def _bf16_rand(shape, scale, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return (scale * torch.randn(shape, generator=g, device=device)).bfloat16()


# Tolerances: the stats as the stats scan's (f32 sums of the same bf16
# products in another order); the supergroup sums are f32 sums of f32
# exp2 rounded once to bf16, so one may land the other way: one ulp of one
# term (`_within_terms`).
@pytest.mark.parametrize("sup_r", [2, 4, 8, 16, 32])
def test_scan_sup_variant_matches_plain(cuda, sup_r):
    """Random operands at the flagship's 32 sem groups per tile (bn=512,
    gsz_sem=16), every supergroup ratio a 32-group step allows, a ragged
    batch (700 of 768 rows): the stats equal the plain scan's and the one-
    level launch's; the tails hold the segment-sum rule."""
    from range_tpu_torch.ops import retrieval_hier as rh

    q = _bf16_rand((768, 384), 1.0, 1, cuda)
    q[700:] = 0
    gs, gg = _bf16_rand((8 * 32, 256), 0.1, 2, cuda), _bf16_rand((8 * 8, 128), 0.5, 3, cuda)
    vs, vg = _bf16_rand((8 * 32 // sup_r, 384), 1.0, 4, cuda), _bf16_rand((64, 512), 1.0, 5, cuda)
    kw = dict(gpt_s=32, gpt_g=8, sup_r=sup_r)
    n0 = (rh._hier_scan_call.launches, rh._hier_scan_call.sup_launches)
    got = rh._hier_scan_call(q, gs, gg, vs, vg, **kw)
    torch.cuda.synchronize()
    assert (rh._hier_scan_call.launches, rh._hier_scan_call.sup_launches) == (n0[0] + 1, n0[1] + 1)
    ref = rh._hier_scan_plain(q, gs, gg, vs, vg, **kw)
    mag = rh._hier_scan_plain(q, gs, gg, vs.abs(), vg.abs(), **kw)[4]
    one = rh._hier_scan_call(q, gs, gg, _bf16_rand((8 * 32, 384), 1.0, 6, cuda), vg,
                             gpt_s=32, gpt_g=8)
    for i in (0, 2):
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=1e-4)
    for i in (1, 3):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-4, atol=0)
    for i in range(4):
        assert torch.equal(got[i], one[i])
    for cols in (slice(0, 384), slice(384, None)):
        _within_terms(got[4][:, cols], ref[4][:, cols], mag[:, cols])
    assert torch.equal(got[4][:, 384:], one[4][:, 384:])


def test_scan_sup_variant_on_the_bank(cuda):
    """The tail_super bank's own operands (sup_r = 64 / 16 = 4, 8 groups a
    tile): the sem tail against the plain version."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = _tail_super_bank(cuda, 64)
    q_cat, _ = _merged_operands(hb, cuda)
    args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_ts_vw, hb.g_geo_vw_lr)
    got = rh._hier_scan_call(*args, gpt_s=8, gpt_g=8, sup_r=4)
    ref = rh._hier_scan_plain(*args, gpt_s=8, gpt_g=8, sup_r=4)
    mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_ts_vw.abs(),
                              hb.g_geo_vw_lr.abs(), gpt_s=8, gpt_g=8, sup_r=4)[4]
    assert hb.g_sem_ts_vw.shape == (hb.g_sem_cat.shape[0] // 4, 384)
    for cols in (slice(0, 384), slice(384, None)):
        _within_terms(got[4][:, cols], ref[4][:, cols], mag[:, cols])


# Tolerances: max logits as the stats scan's; exp-masses f32 sums of f32
# exp2 in another order.
@pytest.mark.parametrize("gpt,M", [(64, 96), (32, 24), (16, 13), (8, 5)])
def test_refine_kernel_matches_plain(cuda, gpt, M):
    """Random fine centroids at 64 (the two-level top-k's bn=512, gsz_sem=8),
    32, 16 and 8 groups a tile; lists of M tiles, ragged where M * gpt is
    no multiple of 32; a ragged batch."""
    from range_tpu_torch.ops import retrieval_hier as rh

    T, bm = 120, 256
    q = _bf16_rand((768, 384), 1.0, 7, cuda)
    q[700:] = 0
    g_cat = _bf16_rand((T * gpt, 256), 0.1, 8, cuda)
    gen = torch.Generator(device=cuda).manual_seed(9)
    idx = torch.stack([torch.randperm(T, generator=gen, device=cuda)[:M]
                       for _ in range(3)]).to(torch.int32)
    n0 = rh._hier_refine_call.launches
    m_f, s_f, none = rh._hier_refine_call(q, idx, g_cat, None, None, None, bm=bm, gpt_f=gpt,
                                          gpt_sup=1, stats_only=True)
    torch.cuda.synchronize()
    assert rh._hier_refine_call.launches == n0 + 1 and none is None
    rm, rs = rh._hier_refine_plain(q, idx, g_cat, bm=bm, gpt_f=gpt)
    assert m_f.shape == (768, M)
    torch.testing.assert_close(m_f, rm, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_f, rs, rtol=1e-4, atol=0)


# Tolerances: the weights are bf16(exp2) of f32 logits summed in another
# order; one that this moves across a bf16 boundary rounds the other way:
# one ulp of one term, in at most max(2, B / 100) rows (`_within_terms`).
@pytest.mark.parametrize("gpt,M,bm", [(32, 64, 128), (8, 13, 128), (64, 7, 256)])
def test_corr_kernel_matches_plain(cuda, gpt, M, bm):
    """Random centroids and dvw rows (count column zero, as full groups
    build it), lists
    of M tiles (ragged ends for gpt < 32), a ragged batch."""
    from range_tpu_torch.ops import retrieval_hier as rh

    T, W = 60, 384
    q = _bf16_rand((768, 384), 1.0, 10, cuda)
    q[700:] = 0
    g_cat = _bf16_rand((T * gpt, 256), 0.1, 11, cuda)
    dvw = _bf16_rand((T * gpt, W), 0.3, 12, cuda)
    dvw[:, 256] = 0
    gen = torch.Generator(device=cuda).manual_seed(13)
    idx = torch.stack([torch.randperm(T, generator=gen, device=cuda)[:M]
                       for _ in range(768 // bm)]).to(torch.int32)
    n0 = rh._hier_corr_call.launches
    got = rh._hier_corr_call(q, idx, g_cat, dvw, bm=bm, gpt=gpt)
    torch.cuda.synchronize()
    assert rh._hier_corr_call.launches == n0 + 1
    ref = rh._hier_corr_plain(q, idx, g_cat, dvw, bm=bm, gpt=gpt)
    mag = rh._hier_corr_plain(q, idx, g_cat, dvw, bm=bm, gpt=gpt, magnitude=True)
    assert got.shape == (768, W) and not got[:, 256].any()
    _within_terms(got, ref, mag, rows_off_max=max(2, 768 // 100))


def test_two_level_kernels_reject_f32_operands(cuda):
    from range_tpu_torch.ops import retrieval_hier as rh

    # f16 operands raise before any launch (f32 ones take the CUDA-core body)
    q = torch.zeros(256, 384, device=cuda, dtype=torch.half)
    g = torch.zeros(64 * 8, 256, device=cuda, dtype=torch.half)
    idx = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        rh._hier_refine_call(q, idx, g, None, None, None, bm=256, gpt_f=8, gpt_sup=1,
                             stats_only=True)
    with pytest.raises(ValueError, match="bfloat16"):
        rh._hier_corr_call(q, idx, g, torch.zeros(64 * 8, 384, device=cuda).half(), bm=256,
                           gpt=8)
    with pytest.raises(ValueError, match="bfloat16"):
        rh._hier_scan_call(q, g, g[:, :128], torch.zeros(128, 384, device=cuda).half(),
                           torch.zeros(512, 512, device=cuda).half(), gpt_s=8, gpt_g=8,
                           sup_r=4)
    # the has_parts form (the two-level feature path) serves: its value
    # operands must be bf16 too, and bf16 ones launch it
    vw = torch.zeros(64 * 8, 384, device=cuda, dtype=torch.half)
    with pytest.raises(ValueError, match="bfloat16"):
        rh._hier_refine_call(q.bfloat16(), idx, g.bfloat16(), g[::8].bfloat16(), vw, vw[::8],
                             bm=256, gpt_f=8, gpt_sup=1)
    n0 = rh._hier_refine_call.parts_launches
    m_f, s_f, parts = rh._hier_refine_call(q.bfloat16(), idx, g.bfloat16(), g[::8].bfloat16(),
                                           vw.bfloat16(), vw[::8].bfloat16(), bm=256, gpt_f=8,
                                           gpt_sup=1)
    torch.cuda.synchronize()
    assert rh._hier_refine_call.parts_launches == n0 + 1
    assert parts.shape == (256, 384) and not parts.any() and m_f.shape == (256, 4)


def test_tail_super_flagship_launches(cuda):
    """load_model(profile="flagship", tail_super=32, m_corr=8) on the card:
    per request one scan (its segment-sum variant), one corr, two family
    parts and one combine launch, no refine; within the order of the
    fidelity bars of the exact f32 retrieve (a small bank and a global
    batch, as the flagship test)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = _tail_super_bank(cuda, 32)
    enc = load_model("RANGE+", db_path=hb, profile="flagship", hier_bn=128, gsz_geo=16,
                     tail_super=32, m_corr=8)
    coords = _coords(3000, seed=14, device=cuda)
    counters = (rh._hier_scan_call, rh._hier_corr_call, rh._hier_parts_family_call,
                rh._combine_cat_call, rh._hier_refine_call, sh.siren_tower)
    n0 = [c.launches for c in counters] + [rh._hier_scan_call.sup_launches]
    out = enc(coords)
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, n0)] == [1, 1, 2, 1, 0, 1]
    assert rh._hier_scan_call.sup_launches == n0[-1] + 1
    assert out.shape == (3000, 1280) and torch.isfinite(out).all()
    ref = retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), hb.bank)
    rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.mean() < 0.1


@pytest.mark.parametrize("k", [1, 8])
def test_two_level_hier_topk_launches(cuda, two_level_bank, k):
    """hier_topk on a two-level bank: one stats scan (over g_sup_cat), one
    refine, then one argmax (k = 1) or one top-k (k = 8) launch, no corr;
    with every tile in M and K the rows are exact_nn's up to near-ties."""
    from range_tpu_torch.ops import retrieval_hier as rh
    from range_tpu_torch.ops.retrieval import exact_nn

    hb = two_level_bank
    g = torch.Generator(device=cuda).manual_seed(15)
    q = torch.nn.functional.normalize(torch.randn(3000, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(3000, seed=15, device=cuda))
    counters = (rh._hier_scan_stats_call, rh._hier_refine_call, rh._hier_argmax_call,
                rh._hier_topk_call, rh._hier_corr_call)
    n0 = [c.launches for c in counters]
    rows = rh.hier_topk(q, x, hb, k=k, k_tiles=hb.t_real, m_tiles=hb.t_real)
    torch.cuda.synchronize()
    want = [1, 1, 1, 0, 0] if k == 1 else [1, 1, 0, 1, 0]
    assert [c.launches - n for c, n in zip(counters, n0)] == want
    top = rows if k == 1 else rows[:, 0]
    assert (top == exact_nn(q, hb.bank)).float().mean() >= 0.999


# ---- the general one-level path: the wide-tail scan, kernel 15's plain
# variant, kernel 14's plain / lr / rr shapes and the combine without lr_geo,
# at Dv = 1,024 (full-width group sums W = 1,152)


@pytest.mark.parametrize("case", ["full", "mixed", "no_geo"])
def test_scan_wide_tail_matches_plain(cuda, hier_bank, case):
    """The scan over the full-width group value sums (1,152 columns a
    family, in column slices): both families full width, the mixed launch
    (the 384-wide low-rank sem tail beside the full-width geo tail) and the
    geo-less launch; stats and tails against the plain version."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    q_cat, _ = _merged_operands(hb, cuda)
    sem = hb.g_sem_vw_lr if case == "mixed" else hb.g_sem_vw
    kw = dict(gpt_s=8, gpt_g=8, has_geo=case != "no_geo")
    args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, sem, hb.g_geo_vw)
    n0 = (rh._hier_scan_call.launches, rh._hier_scan_call.wide_launches)
    got = rh._hier_scan_call(*args, **kw)
    ref = rh._hier_scan_plain(*args, **kw)
    mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, sem.abs(),
                              hb.g_geo_vw.abs(), **kw)[4]
    torch.cuda.synchronize()
    assert (rh._hier_scan_call.launches, rh._hier_scan_call.wide_launches) == (
        n0[0] + 1, n0[1] + 1)
    Ws = sem.shape[1]
    assert got[4].shape == (768, Ws + (1152 if kw["has_geo"] else 0))
    for i in (0, 2) if kw["has_geo"] else (0,):
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=1e-4)
    for i in (1, 3) if kw["has_geo"] else (1,):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-4, atol=0)
    for cols in (slice(0, Ws), slice(Ws, None)) if kw["has_geo"] else (slice(0, Ws),):
        _within_terms(got[4][:, cols], ref[4][:, cols], mag[:, cols])


@pytest.mark.parametrize("geo", [True, False], ids=["geo", "no_geo"])
@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_merged_parts_plain_variant_matches_plain(cuda, hier_bank, geo, quant):
    """Kernel 15 without lr (the sem approximation over the full-width sums
    subtracted in the kernel, from acc_s and d_s): every column against
    the plain version; the bf16-flip allowance of the merged kernel."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank if quant == "bf16" else _quantized(cuda, hier_bank)
    q_cat, idx = _merged_operands(hb, cuda)
    args = (q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx, hb.g_sem_cat,
            hb.g_geo_cat, hb.g_sem_vw, hb.g_geo_vw)
    kw = dict(sem_d=256, bm=128, bn=128, gpt_s=8, gpt_g=8, geo=geo, lr=False)
    n0 = (rh._hier_parts_call.launches, rh._hier_parts_call.plain_launches)
    got = rh._hier_parts_call(*args, **kw)
    ref = rh._hier_parts_plain(*args, **kw)
    mag = rh._hier_parts_plain(*args, **kw, magnitude=True)
    torch.cuda.synchronize()
    assert (rh._hier_parts_call.launches, rh._hier_parts_call.plain_launches) == (
        n0[0] + 1, n0[1] + 1)
    assert got.shape == (768, 2 * 1024 + 128)
    segs = [slice(0, 1024), slice(2048, 2049)]
    if geo:
        segs += [slice(1024, 2048), slice(2049, 2050)]
    else:
        assert not got[:, 1024:2048].any() and not got[:, 2049].any()
    assert not got[:, 2050:].any()
    for cols in segs:
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols], rows_off_max=7)


FAMILY_SHAPES = [(v, f, q) for v in ("plain", "lr") for f in ("sem", "geo")
                 for q in ("bf16", "int8")] + [("rr", f, "bf16") for f in ("sem", "geo")]


@pytest.mark.parametrize("variant,fam,quant", FAMILY_SHAPES,
                         ids=["-".join(c) for c in FAMILY_SHAPES])
def test_family_parts_variants_match_plain(cuda, hier_bank, variant, fam, quant):
    """Kernel 14's plain ([acc | d | pad]) and lr ([acc | d | pad | alr])
    shapes, which stream the values (bf16, or int8 with the scale folded
    into p), and its rr shape ([acc | d | pad | az], the full-width sums in
    three 384-column passes), each against the plain version and counted
    in its own counter."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank if quant == "bf16" else _quantized(cuda, hier_bank)
    geo = fam == "geo"
    q_cat, _ = _merged_operands(hb, cuda)
    stats = rh._hier_scan_stats_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, gpt_s=8, gpt_g=8)
    if geo:
        stats = (stats[2], stats[3], stats[0], stats[1])
    idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=12 if geo else 24, bm=128,
                             n_valid=700, mode="range")
    lr = variant == "lr"
    vw = (hb.g_geo_vw_lr if geo else hb.g_sem_vw_lr) if lr else (
        hb.g_geo_vw if geo else hb.g_sem_vw)
    z = (hb.z_geo if geo else hb.z_sem) if variant == "rr" else None
    lrr = (384 if geo else 256) if lr else 1024
    args = (q_cat, hb.k_cat, hb.mask_neg, idx, hb.g_geo_cat if geo else hb.g_sem_cat, vw, z)
    kw = dict(sem_d=256, bm=128, bn=128, gpt=8, geo=geo, lrr=lrr, lr=lr, values=hb.values,
              scale=hb.value_scale)
    counter = f"{variant}_launches"
    n0 = (rh._hier_parts_family_call.launches, getattr(rh._hier_parts_family_call, counter))
    got = rh._hier_parts_family_call(*args, **kw)
    ref = rh._hier_parts_family_plain(*args, **kw)
    mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
    torch.cuda.synchronize()
    assert (rh._hier_parts_family_call.launches,
            getattr(rh._hier_parts_family_call, counter)) == (n0[0] + 1, n0[1] + 1)
    width = {"plain": 1152, "lr": 1152 + vw.shape[1], "rr": 1152 + 128}[variant]
    assert got.shape == (768, width)
    assert not got[:, 1025:1152].any()
    segs = [slice(0, 1024), slice(1024, 1025)] + ([slice(1152, None)]
                                                  if variant != "plain" else [])
    for cols in segs:
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols], rows_off_max=7)


@pytest.mark.parametrize("tier", ["fast", "exact"])
def test_combine_without_geo_lr_matches_plain(cuda, hier_bank, tier):
    """Kernel 16 with rg = 0: the geo family's rr-shape parts and its
    full-width tail (acc_g = pg[:, :Dv] + tails_g[:, :Dv] + az @ w_geo), on
    the TF32-split Hopper body (``fast``) and the f32 body (``exact``); f32
    products in another summation order."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    q_cat, _ = _merged_operands(hb, cuda)
    m_s, s_s, m_g, s_g, tails = rh._hier_scan_plain(
        q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw, gpt_s=8, gpt_g=8)
    parts = []
    for geo, stats, k in ((False, (m_s, s_s, m_g, s_g), 24), (True, (m_g, s_g, m_s, s_s), 12)):
        idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=k, bm=128, n_valid=700,
                                 mode="range")
        parts.append(rh._hier_parts_family_plain(
            q_cat, hb.k_cat, hb.mask_neg, idx, hb.g_geo_cat if geo else hb.g_sem_cat,
            hb.g_geo_vw if geo else hb.g_sem_vw_lr, hb.z_geo if geo else hb.z_sem,
            sem_d=256, bm=128, bn=128, gpt=8, geo=geo, lrr=1024 if geo else 256, lr=not geo))
    q_srt = torch.randn(768, 256, generator=torch.Generator(device=cuda).manual_seed(3),
                        device=cuda)
    ck = dict(Ws=384, r=256, rrp=128, Dv=1024, beta=0.5, rg=0, Wg=1152)
    c_args = (*parts, tails, q_srt, hb.w_sem, hb.u_sem, hb.w_geo, None)
    c = rh._combine_cat_call
    n0 = (c.launches, c.rg0_launches, c.exact_launches)
    got = c(*c_args, **ck, tier=tier)
    torch.cuda.synchronize()
    exact = int(tier == "exact")
    assert (c.launches, c.rg0_launches, c.exact_launches) == (
        n0[0] + 1, n0[1] + 1 - exact, n0[2] + exact)
    torch.testing.assert_close(got, rh._combine_cat_plain(*c_args, **ck), rtol=1e-5,
                               atol=1e-5)


def test_combine_sm90_ragged_and_cancelling_rows(cuda, hier_bank):
    """The Hopper combine at batches of no whole 128-row block (1, 37, 700
    padded rows) and on rows built to cancel (a pair of large opposite
    corr terms on two nearly equal basis rows, corr columns that are
    differences of nearly equal tails and approximations): within 1e-5 +
    1e-5 |ref| of the plain version, the queries copied exactly."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = hier_bank
    g = torch.Generator(device=cuda).manual_seed(11)
    ck = dict(Ws=384, r=256, rrp=128, Dv=1024, beta=0.3, rg=384, Wg=512)
    u_sem = hb.u_sem.clone()
    u_sem[1] = u_sem[0] * (1 + 1e-3 * torch.randn(1024, generator=g, device=cuda))
    for Bp in (1, 37, 700):
        ps = torch.rand(Bp, 640, generator=g, device=cuda) * 1e-2
        pg = torch.rand(Bp, 768, generator=g, device=cuda) * 1e-2
        tails = torch.rand(Bp, 896, generator=g, device=cuda) * 1e-2
        ps[:, 128] += 1.0  # d_s, d_g well away from 0
        pg[:, 128] += 1.0
        big = 50.0 * torch.rand(Bp, generator=g, device=cuda)
        tails[:, 0] += big
        tails[:, 1] -= big
        tails[:, 2:256] += 30.0
        ps[:, 258:512] += 30.0
        q = torch.randn(Bp, 256, generator=g, device=cuda)
        args = (ps, pg, tails, q, hb.w_sem, u_sem, hb.w_geo, hb.u_geo)
        got = rh._combine_cat_call(*args, **ck)
        ref = rh._combine_cat_plain(*args, **ck)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        assert torch.equal(got[:, 1024:], q)


def test_combine_routes_by_the_banks_tier(cuda, monkeypatch):
    """retrieve_hier passes the bank's tier to the combine: at ``exact`` the
    flagship's fused combine runs the f32 body `csrc/combine_cat.cu`
    (counted in ``.exact_launches``), at ``fast`` and ``high`` the Hopper
    body `csrc/combine_cat_sm90.cu`, whose library is the only combine
    library those tiers load."""
    from range_tpu_torch.kernels import _build
    from range_tpu_torch.ops import retrieval_hier as rh

    loaded = []
    real = _build.load_kernel_library

    def spy(name):
        loaded.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load_kernel_library", spy)
    coords = _coords(500, seed=12, device=cuda)
    c = rh._combine_cat_call
    for tier in ("exact", "high", "fast"):
        hb = _tier_bank(cuda, tier, None)
        enc = load_model("RANGE+", db_path=hb, profile="flagship", hier_bn=128, gsz_geo=16,
                         tier=tier)
        loaded.clear()
        n0 = (c.launches, c.exact_launches)
        out = enc(coords)
        torch.cuda.synchronize()
        exact = int(tier == "exact")
        assert (c.launches, c.exact_launches) == (n0[0] + 1, n0[1] + exact), tier
        combine = {n for n in loaded if n.startswith("combine_cat")}
        assert combine == {"combine_cat" if exact else "combine_cat_sm90"}, tier
        assert torch.isfinite(out).all()


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
def test_default_knob_path_launches(cuda, name):
    """load_model(name, retrieval="hier") at the JAX defaults (no lr_rank /
    res_rank / lr_geo; bn cut to 128) on the card: one wide scan and one
    plain merged parts launch a request (RANGE also its home-tile stats
    scan), no family parts and no combine; finite [B, 1280] answers."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 9000, pad_to=512, value_dtype=torch.bfloat16,
                                         device=cuda)
    enc = load_model(name, db_path=bank, retrieval="hier", hier_bn=128, gsz_geo=16,
                     chunk=512)
    coords = _coords(3000, seed=16, device=cuda)
    counters = (rh._hier_scan_stats_call, rh._hier_scan_call, rh._hier_parts_call,
                rh._hier_parts_family_call, rh._combine_cat_call, sh.siren_tower)
    n0 = [c.launches for c in counters] + [rh._hier_scan_call.wide_launches,
                                           rh._hier_parts_call.plain_launches]
    out = enc(coords)
    torch.cuda.synchronize()
    got = [c.launches for c in counters] + [rh._hier_scan_call.wide_launches,
                                            rh._hier_parts_call.plain_launches]
    stats = 1 if name == "RANGE" else 0
    assert [a - b for a, b in zip(got, n0)] == [stats, 1, 1, 0, 0, 1, 1, 1]
    assert out.shape == (3000, 1280) and torch.isfinite(out).all()


def test_corr_kernel_wide_matches_plain(cuda):
    """The correction kernel over a full-width dvw (1,152 columns, count
    column 1,024 zero: a tail_super bank without lr_rank), in column
    slices; tolerance as `test_corr_kernel_matches_plain`."""
    from range_tpu_torch.ops import retrieval_hier as rh

    T, W, gpt, M, bm = 60, 1152, 8, 13, 128
    q = _bf16_rand((768, 384), 1.0, 10, cuda)
    q[700:] = 0
    g_cat = _bf16_rand((T * gpt, 256), 0.1, 11, cuda)
    dvw = _bf16_rand((T * gpt, W), 0.3, 12, cuda)
    dvw[:, 1024] = 0
    gen = torch.Generator(device=cuda).manual_seed(13)
    idx = torch.stack([torch.randperm(T, generator=gen, device=cuda)[:M]
                       for _ in range(768 // bm)]).to(torch.int32)
    n0 = rh._hier_corr_call.launches
    got = rh._hier_corr_call(q, idx, g_cat, dvw, bm=bm, gpt=gpt)
    torch.cuda.synchronize()
    assert rh._hier_corr_call.launches == n0 + 1
    ref = rh._hier_corr_plain(q, idx, g_cat, dvw, bm=bm, gpt=gpt)
    mag = rh._hier_corr_plain(q, idx, g_cat, dvw, bm=bm, gpt=gpt, magnitude=True)
    assert got.shape == (768, W) and not got[:, 1024].any()
    _within_terms(got, ref, mag, rows_off_max=max(2, 768 // 100))


def test_scan_sup_variant_wide_matches_plain(cuda):
    """The segment-sum scan over a full-width supergroup operand (1,152
    columns, sup_r = 4) beside a full-width geo tail: both in column
    slices; the stats equal the one-level launch's."""
    from range_tpu_torch.ops import retrieval_hier as rh

    q = _bf16_rand((768, 384), 1.0, 1, cuda)
    q[700:] = 0
    gs, gg = _bf16_rand((8 * 32, 256), 0.1, 2, cuda), _bf16_rand((8 * 8, 128), 0.5, 3, cuda)
    vs, vg = _bf16_rand((8 * 32 // 4, 1152), 1.0, 4, cuda), _bf16_rand((64, 1152), 1.0, 5, cuda)
    kw = dict(gpt_s=32, gpt_g=8, sup_r=4)
    n0 = (rh._hier_scan_call.sup_launches, rh._hier_scan_call.wide_launches)
    got = rh._hier_scan_call(q, gs, gg, vs, vg, **kw)
    torch.cuda.synchronize()
    assert (rh._hier_scan_call.sup_launches, rh._hier_scan_call.wide_launches) == (
        n0[0] + 1, n0[1] + 1)
    ref = rh._hier_scan_plain(q, gs, gg, vs, vg, **kw)
    mag = rh._hier_scan_plain(q, gs, gg, vs.abs(), vg.abs(), **kw)[4]
    one = rh._hier_scan_call(q, gs, gg, _bf16_rand((8 * 32, 384), 1.0, 6, cuda), vg,
                             gpt_s=32, gpt_g=8)
    for i in range(4):
        assert torch.equal(got[i], one[i])
    for cols in (slice(0, 1152), slice(1152, None)):
        _within_terms(got[4][:, cols], ref[4][:, cols], mag[:, cols])


def test_tail_super_without_lr_launches(cuda):
    """A tail_super bank without lr_rank (bn=128, gsz_sem=16, tail_super=64)
    served RANGE+ at k_geo=4, m_corr=4: one scan (its segment-sum and
    wide-tail forms at once), one correction over the full-width dvw, two
    family parts launches of the plain shape, no combine kernel; relerr
    against the exact f32 retrieve within the flagship's test bar."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 9000, pad_to=512, value_dtype=torch.bfloat16,
                                         device=cuda)
    hb = rh.build_hier_bank(bank, bn=128, gsz_sem=16, gsz_geo=16, tail_super=64)
    assert hb.g_sem_ts_dvw.shape[1] == 1152
    enc = load_model("RANGE+", db_path=hb, retrieval="hier", hier_bn=128, gsz_sem=16,
                     gsz_geo=16, tail_super=64, k_geo=4, m_corr=4, chunk=512)
    coords = _coords(3000, seed=17, device=cuda)
    counters = (rh._hier_scan_call, rh._hier_corr_call, rh._hier_parts_family_call,
                rh._hier_parts_call, rh._combine_cat_call)
    n0 = [c.launches for c in counters] + [
        rh._hier_scan_call.sup_launches, rh._hier_scan_call.wide_launches,
        rh._hier_parts_family_call.plain_launches]
    out = enc(coords)
    torch.cuda.synchronize()
    got = [c.launches for c in counters] + [
        rh._hier_scan_call.sup_launches, rh._hier_scan_call.wide_launches,
        rh._hier_parts_family_call.plain_launches]
    assert [a - b for a, b in zip(got, n0)] == [1, 1, 2, 0, 0, 1, 1, 2]
    assert out.shape == (3000, 1280) and torch.isfinite(out).all()
    ref = retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), hb.bank)
    rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.mean() < 0.1


# ------------------------------------------- kernels 5, 6, 7: parts, pruned, hybrid
# Tolerances: the dense kernels' rule (`_within_terms`): the logits are f32
# sums of the same products in another order, and an exp2 that this moves
# across a bf16 boundary rounds the other way before a value product, one
# bf16 ulp of that one term, in at most max(2, B/100) rows.  The sums d are
# f32 sums of the same f32 exponentials in another order (1e-5 relative:
# the exponent's rounding, up to ~57 log2 units at geo temp 40, times ln 2).

def _dense_operands(cuda, tier, quant, n=3001, B=77, pad_to=7):
    """A masked bank (rows no multiple of the 32-row tile), a ragged batch,
    and their packed operands."""
    from range_tpu_torch.bank import quantize_values

    bank = GeoBank.synthetic(0, n, key_dim=256, value_dim=1024, pad_to=pad_to,
                             value_dtype=torch.float32 if quant else torch.bfloat16,
                             device=cuda)
    if quant:
        bank = quantize_values(bank)
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.nn.functional.normalize(torch.randn(B, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(B, seed=2, device=cuda))
    q_cat = rf.pack_queries(q, x, 12.0, 40.0, tier)
    k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, tier)
    mask = (rf.NEG * (1 - bank.row_mask()))[None]
    return bank, q_cat, k_cat, mask, rf.packed_dims(256, tier)[0]


@pytest.mark.parametrize("tier", ["exact", "fast"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_fused_parts_kernel_matches_plain(cuda, tier, quant):
    bank, q_cat, k_cat, mask, sem_d = _dense_operands(cuda, tier, quant)
    B, Dv = q_cat.shape[0], bank.value_dim
    v, s = bank.values, bank.value_scale
    fp = rf.retrieve_fused_parts
    n0 = (fp.launches, fp.i8_launches, fp.exact_launches)
    got = rf.retrieve_fused_parts(q_cat, k_cat, v, mask, s, sem_d=sem_d)
    torch.cuda.synchronize()
    # bf16 operands: the Hopper kernel's partials form; f32: the mma.sync body
    hopper = tier != "exact"
    assert (fp.launches, fp.i8_launches, fp.exact_launches) == (
        n0[0] + (hopper and not quant), n0[1] + (hopper and quant), n0[2] + (not hopper))
    ref = rf._retrieve_fused_parts_plain(q_cat, k_cat, v, mask, s, sem_d=sem_d)
    mag = rf._retrieve_fused_parts_plain(q_cat, k_cat, v.abs(), mask, s, sem_d=sem_d)
    assert got.shape == (B, 2 * Dv + 128)
    for cols in (slice(0, Dv), slice(Dv, 2 * Dv)):
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols], rows_off_max=2)
    d = slice(2 * Dv, 2 * Dv + 2)
    torch.testing.assert_close(got[:, d], ref[:, d], rtol=1e-5, atol=0)
    assert (got[:, 2 * Dv + 2:] == 0).all()


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_fused_parts_slabs_add_up_to_the_dense_kernel(cuda, quant):
    """The partials of 4 row slabs, added and normalized, give the dense
    kernel over the whole bank: the same tiles and weights, the tile sums
    re-associated across slabs (f32, ~1e-6 relative)."""
    bank, q_cat, k_cat, mask, sem_d = _dense_operands(cuda, "fast", quant, n=4000,
                                                      B=300, pad_to=1024)
    N, Dv = bank.num_rows, bank.value_dim
    parts = sum(rf.retrieve_fused_parts(
        q_cat, k_cat[r].contiguous(), bank.values[r].contiguous(), mask[:, r].contiguous(),
        None if bank.value_scale is None else bank.value_scale[:, r].contiguous(),
        sem_d=sem_d) for r in (slice(i * N // 4, (i + 1) * N // 4) for i in range(4)))
    got = (0.3 * parts[:, :Dv] / parts[:, 2 * Dv:2 * Dv + 1].clamp_min(1e-30)
           + 0.7 * parts[:, Dv:2 * Dv] / parts[:, 2 * Dv + 1:2 * Dv + 2].clamp_min(1e-30))
    ref = rf.retrieve_fused(q_cat, k_cat, bank.values, mask, 0.3, bank.value_scale,
                            sem_d=sem_d)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * ref.abs().max().item())


@pytest.fixture
def clustered(cuda):
    """An informative bank clustered on the card at bn=128 (padded
    packing), with queries near its rows (keys + noise), geo sorted, and
    the source bank."""
    from range_tpu_torch.bank.clustered import cluster_bank
    from range_tpu_torch.geometry import geo_sort_order

    bank = GeoBank.synthetic_informative(2, 6000, value_dim=512, pad_to=1024,
                                         value_dtype=torch.bfloat16, device=cuda)
    cb, st = cluster_bank(bank, bn=128)
    g = torch.Generator(device=cuda).manual_seed(4)
    rows = torch.nonzero(cb.row_mask() > 0)[:, 0]
    pick = rows[torch.randint(0, len(rows), (500,), generator=g, device=cuda)]
    q = torch.nn.functional.normalize(
        cb.keys_sem[pick].float() + 0.05 * torch.randn(500, 256, generator=g, device=cuda),
        dim=1)
    x = torch.nn.functional.normalize(
        cb.xyz[pick].float() + 0.02 * torch.randn(500, 3, generator=g, device=cuda), dim=1)
    order = geo_sort_order(x)
    return cb, st, q[order], x[order], bank


def _plan_operands(cb, st, q, x, family, bm, bn, tier="fast"):
    from range_tpu_torch.bank.clustered import compute_tile_plan

    q_cat = rf.pack_queries(q, x, 12.0, 40.0, tier)
    k_cat = rf.pack_bank(cb.keys_sem, cb.xyz, tier)
    sem_d = rf.packed_dims(256, tier)[0]
    cols = slice(0, sem_d) if family == "sem" else slice(sem_d, sem_d + 16)
    c, r, fq, temp = ((st.sem_centroid, st.sem_radius, q, 12.0) if family == "sem"
                      else (st.geo_centroid, st.geo_radius, x, 40.0))
    idx, cnt = compute_tile_plan(fq, c, r, temp=temp, bm=bm)
    return q_cat[:, cols], k_cat[:, cols], (rf.NEG * (1 - cb.row_mask()))[None], idx, cnt


@pytest.mark.parametrize("family", ["sem", "geo"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("bm,bn", [(16, 128), (80, 128), (256, 128)])
def test_family_pruned_kernel_matches_plain(cuda, clustered, family, quant, bm, bn):
    """Plan tiles narrower than, across and wider than the kernel's 64-query
    block (bm 16, 80, 256); column slices of the packed operands as they
    are; int8 values with their scales."""
    from range_tpu_torch.bank import quantize_values

    cb, st, q, x, _ = clustered
    if quant:
        cb = quantize_values(cb)
    qf, kf, mask, idx, cnt = _plan_operands(cb, st, q, x, family, bm, bn)
    # geo prunes where the plan's query tiles are regional
    assert family == "sem" or bm > 80 or cnt.float().mean() < idx.shape[1]
    v, s = cb.values, cb.value_scale
    n0 = (rf._family_pruned_call.launches, rf._family_pruned_call.i8_launches)
    got = rf._family_pruned_call(qf, kf, v, mask, idx, cnt, s, bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert (rf._family_pruned_call.launches, rf._family_pruned_call.i8_launches) == (
        n0[0] + (not quant), n0[1] + quant)
    ref = rf._family_pruned_plain(qf, kf, v, mask, idx, cnt, s, bm=bm, bn=bn)
    mag = rf._family_pruned_plain(qf, kf, v.abs(), mask, idx, cnt, s, bm=bm, bn=bn)
    _within_terms(got, ref, mag, rows_off_max=max(2, 500 // 100))


@pytest.mark.parametrize("bm,bn", [(16, 128), (80, 256), (256, 128)])
def test_hybrid_kernel_matches_plain(cuda, clustered, bm, bn):
    from range_tpu_torch.bank.clustered import cluster_bank, compute_keep_mask

    cb, st, q, x, bank = clustered
    if bn != 128:
        cb, st = cluster_bank(bank, bn=bn)
    q_cat = rf.pack_queries(q, x, 12.0, 40.0, "fast")
    k_cat = rf.pack_bank(cb.keys_sem, cb.xyz, "fast")
    mask = (rf.NEG * (1 - cb.row_mask()))[None]
    flags = compute_keep_mask(x, st.geo_centroid, st.geo_radius, temp=40.0,
                              bm=bm).to(torch.int32)
    # some tiles unflagged where the plan's query tiles are regional
    assert 0 < int(flags.sum()) and (bm > 80 or int(flags.sum()) < flags.numel())
    n0 = rf.retrieve_fused_hybrid.launches
    got = rf.retrieve_fused_hybrid(q_cat, k_cat, cb.values, mask, 0.5, flags, sem_d=256,
                                   bm=bm, bn=bn)
    torch.cuda.synchronize()
    assert rf.retrieve_fused_hybrid.launches == n0 + 1
    ref = rf._retrieve_fused_hybrid_plain(q_cat, k_cat, cb.values, mask, 0.5, flags,
                                          sem_d=256, bm=bm, bn=bn)
    mag = rf._retrieve_fused_hybrid_plain(q_cat, k_cat, cb.values.abs(), mask, 0.5,
                                          flags, sem_d=256, bm=bm, bn=bn)
    _within_terms(got, ref, mag, rows_off_max=max(2, 500 // 100))


def test_pruned_and_hybrid_track_the_dense_kernel(cuda, clustered):
    """retrieve_pruned (RANGE+: one launch a family; RANGE: one) and
    retrieve_hybrid (one launch) over the clustered bank stay within
    `tests/test_pruned.py:87`'s bar of the dense kernel over the same rows:
    |d| / max(|ref|, 0.1) < 5e-3."""
    cb, st, q, x, _ = clustered
    fam, hyb = rf._family_pruned_call, rf.retrieve_fused_hybrid
    for mode, want in (("range+", 2), ("range", 1)):
        temp = 12.0 if mode == "range+" else 15.0
        n0 = fam.launches
        got = rf.retrieve_pruned(q, x, cb, st, sem_temp=temp, mode=mode, bm=64, bn=128)
        torch.cuda.synchronize()
        assert fam.launches == n0 + want
        ref = rf.retrieve_pallas(q, x, cb, sem_temp=temp, mode=mode)
        assert ((got - ref).abs() / ref.abs().clamp_min(0.1)).max() < 5e-3
    n0 = hyb.launches
    got = rf.retrieve_hybrid(q, x, cb, st, bm=64, bn=128)
    torch.cuda.synchronize()
    assert hyb.launches == n0 + 1
    ref = rf.retrieve_pallas(q, x, cb)
    assert ((got - ref).abs() / ref.abs().clamp_min(0.1)).max() < 5e-3


def test_plan_kernels_reject_bad_input(cuda, clustered):
    cb, st, q, x, _ = clustered
    qf, kf, mask, idx, cnt = _plan_operands(cb, st, q, x, "sem", 8, 128)
    with pytest.raises(ValueError, match="bm % 16"):
        rf._family_pruned_call(qf, kf, cb.values, mask, idx, cnt, bm=8, bn=128)
    qf, kf, mask, idx, cnt = _plan_operands(cb, st, q, x, "sem", 16, 128)
    with pytest.raises(ValueError, match="int32 plan"):
        rf._family_pruned_call(qf, kf, cb.values, mask, idx.long(), cnt, bm=16, bn=128)
    from range_tpu_torch.bank import quantize_values

    q8 = quantize_values(cb)
    with pytest.raises(ValueError, match="bf16 values"):
        rf.retrieve_fused_hybrid(rf.pack_queries(q, x, 12.0, 40.0, "fast"),
                                 rf.pack_bank(cb.keys_sem, cb.xyz, "fast"), q8.values,
                                 mask, 0.5, torch.ones(8, cb.num_rows // 128,
                                                       dtype=torch.int32, device=cuda),
                                 sem_d=256, bm=64, bn=128)


def test_mesh_on_the_card(cuda, tmp_path):
    """A world-size-1 NCCL group (FileStore, no network): load_model(mesh=)
    serves through the parts kernel (one launch) and answers what the
    single-device model does (kernel 2): the same tiles and sums, the
    division and blend in torch instead of the kernel (1e-6 relative)."""
    import torch.distributed as dist

    from range_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        for quant in (None, "int8"):
            enc = load_model("RANGE+", db_path="synthetic:5000", chunk=1024,
                             value_quant=quant, mesh=make_mesh((1, 1)))
            one = load_model("RANGE+", db_path="synthetic:5000", chunk=1024,
                             value_quant=quant)
            coords = _coords(300, seed=3, device=cuda)
            n0 = (rf.retrieve_fused_parts.launches, rf.retrieve_fused_parts.i8_launches)
            got = enc(coords)
            torch.cuda.synchronize()
            assert (rf.retrieve_fused_parts.launches,
                    rf.retrieve_fused_parts.i8_launches) == (n0[0] + (quant is None),
                                                             n0[1] + (quant is not None))
            ref = one(coords)
            torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)
    finally:
        dist.destroy_process_group()


# ---- the rest of hierarchical serving: the refine kernel's has_parts form
# (the two-level feature path), kernel 14's sel and dedup_pad forms in its
# four shapes, and the paths that run them


# Tolerances: the stats as the stats-only form's; the partials' weights
# are bf16(exp2) of f32 logits summed in another order, so one that this
# moves across a bf16 boundary rounds the other way: one ulp of one term,
# in at most max(2, B / 100) rows (`_within_terms`).
@pytest.mark.parametrize("gpt,gpt_sup,M,W", [(64, 8, 48, 1152), (16, 8, 13, 384),
                                             (8, 2, 5, 128), (32, 3, 9, 640)])
def test_refine_parts_kernel_matches_plain(cuda, gpt, gpt_sup, M, W):
    """The has_parts form: fine stats plus sum over the M listed tiles of
    bf16(exp2(l_f)) @ vw - bf16(exp2(l_sup)) @ vw_sup, at the two-level
    feature path's shape (bn=512, gsz_sem=8, gsz_super=64: 64 fine and 8
    supergroups a tile, Dv + 128 = 1,152 columns in three slices) and
    smaller ones (ragged lists, a supergroup count that divides no step, a
    ragged batch)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    T, bm = 120, 256
    q = _bf16_rand((768, 384), 1.0, 17, cuda)
    q[700:] = 0
    g_cat = _bf16_rand((T * gpt, 256), 0.1, 18, cuda)
    g_sup = _bf16_rand((T * gpt_sup, 256), 0.1, 19, cuda)
    vw = _bf16_rand((T * gpt, W), 0.3, 20, cuda)
    vw_sup = _bf16_rand((T * gpt_sup, W), 0.3, 21, cuda)
    gen = torch.Generator(device=cuda).manual_seed(22)
    idx = torch.stack([torch.randperm(T, generator=gen, device=cuda)[:M]
                       for _ in range(3)]).to(torch.int32)
    args = (q, idx, g_cat, g_sup, vw, vw_sup)
    n0 = (rh._hier_refine_call.launches, rh._hier_refine_call.parts_launches)
    m_f, s_f, parts = rh._hier_refine_call(*args, bm=bm, gpt_f=gpt, gpt_sup=gpt_sup)
    torch.cuda.synchronize()
    assert (rh._hier_refine_call.launches, rh._hier_refine_call.parts_launches) == (
        n0[0] + 1, n0[1] + 1)
    kw = dict(bm=bm, gpt_f=gpt, g_sup_cat=g_sup, g_sem_vw=vw, g_sup_vw=vw_sup,
              gpt_sup=gpt_sup)
    rm, rs, rp = rh._hier_refine_plain(q, idx, g_cat, **kw)
    mag = rh._hier_refine_plain(q, idx, g_cat, **kw, magnitude=True)[2]
    torch.testing.assert_close(m_f, rm, rtol=0, atol=1e-4)
    torch.testing.assert_close(s_f, rs, rtol=1e-4, atol=0)
    assert parts.shape == (768, W)
    _within_terms(parts, rp, mag, rows_off_max=max(2, 768 // 100))


@pytest.fixture
def knob_bank(cuda):
    """The hier_bank fixture's bank and knobs plus the sel_lr (64) and
    topk_lr (64) sketches, built on the card."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 9000, pad_to=512, value_dtype=torch.bfloat16,
                                         device=cuda)
    return rh.build_hier_bank(bank, bn=128, gsz_sem=16, gsz_geo=16, lr_rank=256, lr_geo=384,
                              res_rank=128, topk_gsz=8, topk_lr=64, sel_lr=64)


def _family_operands(hb, shape, geo, sel):
    """Kernel 14's operands in ``shape`` (plain, lr, rr, rrlr) for one
    family; with ``sel`` the sem family's sketched centroids."""
    vw = {False: (hb.g_sem_vw, hb.g_sem_vw_lr), True: (hb.g_geo_vw, hb.g_geo_vw_lr)}[geo]
    lr = shape in ("lr", "rrlr")
    z = (hb.z_geo if geo else hb.z_sem) if shape in ("rr", "rrlr") else None
    lrr = (384 if geo else 256) if lr else 1024
    g = hb.g_geo_cat if geo else (hb.g_sem_sel if sel else hb.g_sem_cat)
    return g, vw[1] if lr else vw[0], z, lr, lrr


SHAPES = ("plain", "lr", "rr", "rrlr")


@pytest.mark.parametrize("shape", SHAPES)
def test_family_parts_sel_form_matches_plain(cuda, knob_bank, shape):
    """The sel form: the sem family over [q_cat | q_sel] (the query 64
    columns wider than the keys), its group logits from the last 64
    against g_sem_sel, at each shape; counted in .sel_launches (and
    .sel_rr_launches for the rr shapes).  Tolerances as the other
    shapes'."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = knob_bank
    q_cat, _ = _merged_operands(hb, cuda)
    q_sel = (q_cat[:, :256].float() @ hb.p_sel.T).bfloat16()
    q_wide = torch.cat([q_cat, q_sel], 1).contiguous()
    stats = rh._hier_scan_stats_plain(torch.cat([q_sel, q_cat[:, 256:]], 1), hb.g_sem_sel,
                                      hb.g_geo_cat, gpt_s=8, gpt_g=8)
    idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=24, bm=128, n_valid=700,
                             mode="range")
    g, vw, z, lr, lrr = _family_operands(hb, shape, False, True)
    args = (q_wide, hb.k_cat, hb.mask_neg, idx, g, vw, z)
    kw = dict(sem_d=256, bm=128, bn=128, gpt=8, geo=False, lrr=lrr, lr=lr, values=hb.values,
              scale=hb.value_scale, sel=True)
    fam = rh._hier_parts_family_call
    n0 = (fam.sel_launches, fam.sel_rr_launches)
    got = fam(*args, **kw)
    ref = rh._hier_parts_family_plain(*args, **kw)
    mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
    torch.cuda.synchronize()
    rr = z is not None
    assert (fam.sel_launches, fam.sel_rr_launches) == (n0[0] + 1, n0[1] + int(rr))
    assert got.shape == ref.shape
    _within_terms(got, ref, mag, rows_off_max=7)
    with pytest.raises(ValueError, match="unsupported shapes"):
        fam(q_cat, *args[1:], **kw)  # the sel form needs the sketch columns


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("geo", [False, True], ids=["sem", "geo"])
def test_family_parts_dedup_form(cuda, knob_bank, shape, geo):
    """The dedup_pad form on `_dedup_union` lists (2 blocks of 128 merged,
    k_union past the distinct count: repeat padding in every row) against
    the plain version; and a list with repeats appended equals, bit for
    bit, the kernel over the same list without them."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = knob_bank
    q_cat, idx = _merged_operands(hb, cuda, k_tiles=12)
    union = rh._dedup_union(idx, 2, 24)
    assert (union[:, 1:] == union[:, :-1]).any(dim=1).all()  # pad repeats in every row
    g, vw, z, lr, lrr = _family_operands(hb, shape, geo, False)
    kw = dict(sem_d=256, bn=128, gpt=8, geo=geo, lrr=lrr, lr=lr, values=hb.values,
              scale=hb.value_scale)
    fam = rh._hier_parts_family_call
    args = (q_cat, hb.k_cat, hb.mask_neg, union, g, vw, z)
    n0 = (fam.dedup_launches, fam.dedup_rr_launches)
    got = fam(*args, bm=256, dedup_pad=True, **kw)
    ref = rh._hier_parts_family_plain(*args, bm=256, dedup_pad=True, **kw)
    mag = rh._hier_parts_family_plain(*args, bm=256, dedup_pad=True, magnitude=True, **kw)
    torch.cuda.synchronize()
    assert (fam.dedup_launches, fam.dedup_rr_launches) == (n0[0] + 1, n0[1] + int(z is not None))
    _within_terms(got, ref, mag, rows_off_max=7)
    padded = torch.cat([idx, idx[:, -1:].repeat(1, 5)], 1)
    a = fam(q_cat, *args[1:3], padded, *args[4:], bm=128, dedup_pad=True, **kw)
    b = fam(q_cat, *args[1:3], idx, *args[4:], bm=128, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_knob_paths_launch_their_forms(cuda, knob_bank):
    """load_model's sel_lr, dedup and rescue knobs on the card: a sel_lr
    flagship request launches both family parts kernels once, the sem one
    in its sel form; dedup=2 at B = 8,192 both in the dedup_pad form; the
    rescue four family launches (two at bm 128); topk_lr's hier_topk one
    stats scan over g_topk_lr.  Answers finite, the rescue's un-rescued
    rows bit-identical to the rescue-off output."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = knob_bank
    fam = rh._hier_parts_family_call
    coords = _coords(8192, seed=23, device=cuda)
    kw = dict(profile="flagship", hier_bn=128, gsz_geo=16, topk_lr=64)
    plain_hb = dataclasses.replace(hb, sel_lr=0, g_sem_sel=None)
    cases = [("sel", dict(sel_lr=64), hb, (2, 1, 0)),
             ("dedup", dict(dedup=2), plain_hb, (2, 0, 2)),
             ("rescue", dict(adaptive_frac=0.1), plain_hb, (4, 0, 0))]
    outs = {}
    for name, knobs, bank, want in cases:
        enc = load_model("RANGE+", db_path=bank, **kw, **knobs)
        n0 = (fam.launches, fam.sel_launches, fam.dedup_launches)
        outs[name] = enc(coords)
        torch.cuda.synchronize()
        assert (fam.launches - n0[0], fam.sel_launches - n0[1],
                fam.dedup_launches - n0[2]) == want, name
        assert outs[name].shape == (8192, 1280) and torch.isfinite(outs[name]).all()
    base = load_model("RANGE+", db_path=plain_hb, **kw)(coords)
    same = (outs["rescue"] == base).all(dim=1)
    assert 0 < int((~same).sum()) <= int(0.1 * 8192)
    q = torch.nn.functional.normalize(torch.randn(512, 256, device=cuda), dim=1)
    n0 = rh._hier_scan_stats_call.launches
    rows = rh.hier_topk(q, None, hb, k_tiles=8)
    torch.cuda.synchronize()
    assert rh._hier_scan_stats_call.launches == n0 + 1 and rows.shape == (512,)


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
def test_two_level_feature_path_launches(cuda, two_level_bank, name):
    """load_model(name, retrieval="hier", gsz_super=16) over the two-level
    bank (no lr_rank): per request one scan over the supergroups, one
    refine in its has_parts form, one merged parts launch (its plain
    variant), no family parts and no combine; finite answers.  With every
    tile in M and K the telescope leaves the exact softmax up to the bf16
    weights of the exact parts, which at Dv = 1,024 over bf16 values is
    ~7e-3 of max(|ref|, 0.1) on the CPU in both the one- and the two-level
    path: the two-level answer is held within 1e-3 of the one-level merged
    path's over the same rows (3.6e-6 on the CPU; a weight rounding the
    other way moves one term by 2^-8) and both within 1e-2 of the exact
    f32 retrieve."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = two_level_bank
    enc = load_model(name, db_path=hb, retrieval="hier", hier_bn=128, gsz_sem=8,
                     gsz_geo=16, gsz_super=16, chunk=512)
    coords = _coords(3000, seed=24, device=cuda)
    counters = (rh._hier_scan_call, rh._hier_refine_call, rh._hier_parts_call,
                rh._hier_parts_family_call, rh._combine_cat_call)
    n0 = [c.launches for c in counters] + [rh._hier_refine_call.parts_launches,
                                           rh._hier_parts_call.plain_launches]
    out = enc(coords)
    torch.cuda.synchronize()
    got = [c.launches for c in counters] + [rh._hier_refine_call.parts_launches,
                                            rh._hier_parts_call.plain_launches]
    assert [a - b for a, b in zip(got, n0)] == [1, 1, 1, 0, 0, 1, 1]
    assert out.shape == (3000, 1280) and torch.isfinite(out).all()
    if name == "RANGE+":
        q = out[:, 1024:]
        x = lonlat_deg_to_xyz(coords)
        full = rh.retrieve_hier(q, x, hb, k_tiles=hb.t_real, m_tiles=hb.t_real, bm=128)
        one = dataclasses.replace(hb, gsz_super=0, g_sup_cat=None, g_sup_vw=None)
        base = rh.retrieve_hier(q, x, one, k_tiles=hb.t_real, bm=128)
        ref = retrieval.retrieve(q, x, hb.bank, sem_temp=12.0, beta=0.5)
        assert ((full - base).abs() / base.abs().clamp_min(0.1)).max() < 1e-3
        for out in (full, base):
            assert ((out - ref).abs() / ref.abs().clamp_min(0.1)).max() < 1e-2


# ---- kernel 8's Hopper kernel (csrc/hier_scan_sm90.cu) in each form
# Tolerances: the stats as the scan tests' above (f32 sums of the same bf16
# products, and of the same f32 exponentials, in another order); the tails
# one bf16 ulp of one term where an exponential (or a supergroup's f32 sum
# of them) lands the other way (`_within_terms`).

SCAN_FORMS = ["two", "geo_less", "sup4", "wide", "mixed", "sup_wide"]


def _scan_operands(cuda, form, gpt, Bp, seed, t_pad=12):
    """Random operands of one scan form: 256 + 128 packed query columns,
    sem centroids at ``gpt`` groups a tile, geo at 8, tails of 384 / 512
    columns or the full width 1,152 (wide: both; mixed: geo; sup_wide: a
    1,152-column supergroup operand of 8 groups a row), rows past 700 of
    the batch zero."""
    sup_r = {"sup4": 4, "sup_wide": 8}.get(form, 0)
    Ws = 1152 if form in ("wide", "sup_wide") else 384
    Wg = 1152 if form in ("wide", "mixed", "sup_wide") else 512
    q = _bf16_rand((Bp, 384), 1.0, seed, cuda)
    q[700:] = 0
    gs = _bf16_rand((t_pad * gpt, 256), 0.1, seed + 1, cuda)
    gg = _bf16_rand((t_pad * 8, 128), 0.5, seed + 2, cuda)
    vs = _bf16_rand((t_pad * gpt // max(sup_r, 1), Ws), 1.0, seed + 3, cuda)
    vg = _bf16_rand((t_pad * 8, Wg), 1.0, seed + 4, cuda)
    return (q, gs, gg, vs, vg), dict(gpt_s=gpt, gpt_g=8, has_geo=form != "geo_less",
                                     sup_r=sup_r)


def _hold_scan(got, args, kw):
    from range_tpu_torch.ops import retrieval_hier as rh

    ref = rh._hier_scan_plain(*args, **kw)
    q, gs, gg, vs, vg = args
    mag = rh._hier_scan_plain(q, gs, gg, vs.abs(), vg.abs(), **kw)[4]
    for i in (0, 2) if kw["has_geo"] else (0,):
        torch.testing.assert_close(got[i], ref[i], rtol=0, atol=1e-4)
    for i in (1, 3) if kw["has_geo"] else (1,):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-4, atol=0)
    Ws = vs.shape[1]
    assert got[4].shape == (q.shape[0], Ws + (vg.shape[1] if kw["has_geo"] else 0))
    for cols in (slice(0, Ws), slice(Ws, None)) if kw["has_geo"] else (slice(0, Ws),):
        _within_terms(got[4][:, cols], ref[4][:, cols], mag[:, cols])


@pytest.mark.parametrize("gpt", [8, 16, 32, 64])
@pytest.mark.parametrize("form", SCAN_FORMS)
def test_scan_sm90_matches_plain(cuda, form, gpt):
    """Every form at every groups-per-tile the scan takes, a ragged batch
    (700 real of 768 rows): stats and tails against the plain version, and
    the launch counters (the scan's, and its sup / wide forms')."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, kw = _scan_operands(cuda, form, gpt, 768, seed=gpt)
    c = rh._hier_scan_call
    n0 = (c.launches, c.sup_launches, c.wide_launches)
    got = c(*args, **kw)
    torch.cuda.synchronize()
    wide = max(args[3].shape[1], args[4].shape[1] if kw["has_geo"] else 0) > 512
    assert (c.launches, c.sup_launches, c.wide_launches) == (
        n0[0] + 1, n0[1] + bool(kw["sup_r"]), n0[2] + wide)
    if not kw["has_geo"]:
        assert got[2] is None and got[3] is None
    _hold_scan(got, args, kw)


@pytest.mark.parametrize("Bp", [1, 64, 77])
@pytest.mark.parametrize("form", ["two", "wide"])
def test_scan_sm90_small_and_ragged_batches(cuda, form, Bp):
    """A single query, one 64-query block, and a batch no multiple of it:
    the plan cuts many segments to fill the card; the answer holds."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, kw = _scan_operands(cuda, form, 32, Bp, seed=Bp, t_pad=40)
    fams = rh._scan_shapes(*args, **kw)
    assert rh._scan_plan(Bp, fams).fams[0].n_seg > 1
    _hold_scan(rh._hier_scan_call(*args, **kw), args, kw)


@pytest.mark.parametrize("ws,wg", [(80, 96), (32, 16), (192, 64)])
def test_scan_sm90_logit_widths_of_no_whole_box(cuda, ws, wg):
    """Centroid widths that are no whole number of 64-column boxes (the
    geo family of a 32-d bank has 96): the tiles are copied box by box,
    the columns past the width zero-filled, the query columns past it (the
    other family's) multiplied by those zeros."""
    from range_tpu_torch.ops import retrieval_hier as rh

    q = _bf16_rand((200, 272), 1.0, ws, cuda)
    gs, gg = _bf16_rand((12 * 16, ws), 0.2, 1, cuda), _bf16_rand((12 * 8, wg), 0.3, 2, cuda)
    vs, vg = _bf16_rand((12 * 16, 256), 1.0, 3, cuda), _bf16_rand((12 * 8, 384), 1.0, 4, cuda)
    kw = dict(gpt_s=16, gpt_g=8, has_geo=True, sup_r=0)
    _hold_scan(rh._hier_scan_call(q, gs, gg, vs, vg, **kw), (q, gs, gg, vs, vg), kw)


@pytest.mark.parametrize("form", ["two", "sup4", "wide"])
def test_scan_sm90_plans_agree(cuda, form):
    """The kernel under other plans (one chain a family, and segments of
    one step): the stats bit-equal (each tile's logits are the same
    products in the same order, in whichever block owns the tile), the
    tails the plain version's."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, kw = _scan_operands(cuda, form, 32, 256, seed=7, t_pad=40)
    fams = rh._scan_shapes(*args, **kw)
    base = rh._scan_plan(256, fams)
    tiles = [G // gpt for G, _, _, gpt, _ in fams]
    step = [max(1, base.bn // gpt) for _, _, _, gpt, _ in fams]  # the tiles of one step
    plans = [base._replace(fams=tuple(f._replace(n_seg=-(-T // n), seg_tiles=n)
                                      for f, T, n in zip(base.fams, tiles, per)))
             for per in (tiles, step)]
    outs = []
    for plan in plans:
        stats, tails = rh._launch_scan_sm90(*args, **kw, plan=plan)
        outs.append(stats + [tails])
    torch.cuda.synchronize()
    assert plans[0].fams[0].n_seg == 1 and plans[1].fams[0].n_seg == 40 // step[0]
    for a, b in zip(outs[0][:4], outs[1][:4]):
        assert torch.equal(a, b)
    for out in outs:
        _hold_scan(out, args, kw)


# ---- kernel 14's rr shapes on the Hopper body (csrc/hier_parts_family_sm90.cu)

# Tolerances as kernel 14's other checks (`_within_terms`): the logits are
# f32 sums of the same bf16 products in another order, so bf16(p) or D can
# land one ulp the other way: one bf16 ulp of that term, allowed in up to
# max(2, B / 100) rows over the row cap (ROADMAP Queue 3, "bf16 flips of a
# dominant term"); the segments only re-associate the f32 sums.


def _rr_operands(cuda, *, Bp, bm, bn, gpt, K, T, rrp=128, W=384, lr=True, sel=0, seed=0,
                 Dv=1024, geo=False, sem=256):
    """Random operands of kernel 14's rr shapes: ``sem`` (256; the `high`
    tier's 768) sem + 128 geo packed columns (9 real geo ones; the sem ones
    scaled so that a logit's spread is the 256 columns'), T tiles of bn
    rows and gpt groups, each
    query block's list K distinct tiles, z [N, rrp], vw [G, W] with the
    group's row count in column lrr (lr: W - 128 coefficients; rr: the
    full-width sums, lrr = Dv), the last 7 rows of the bank masked; with
    ``sel`` the query operand carries sel sketch columns past the keys';
    ``geo``: the centroids the geo family's [G, 128], 9 real columns."""
    rng = np.random.default_rng(seed)

    def bf(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
            cuda).bfloat16()

    N, G = T * bn, T * gpt
    sc = 0.35 * (256 / sem) ** 0.5
    q = bf((Bp, sem + 128 + sel), sc)
    k = bf((N, sem + 128), sc)
    q[:, sem + 9:sem + 128] = 0
    k[:, sem + 9:sem + 128] = 0
    mask = torch.zeros(1, N, device=cuda)
    mask[0, -7:] = -1e30
    idx = torch.from_numpy(np.stack([rng.permutation(T)[:K] for _ in range(Bp // bm)]).astype(
        np.int32)).to(cuda)
    lrr = W - 128 if lr else Dv
    vw = bf((G, W), 1.0)
    vw[:, lrr] = float(bn // gpt)
    vw[:, lrr + 1:] = 0
    z = bf((N, rrp), 1.0)
    g = bf((G, 128 if geo else sel or sem), sc)
    if geo:
        g[:, 9:] = 0
    return (q, k, mask, idx, g, vw, z), lrr


def _hold_rr(got, args, kw, rows_off_max=7):
    from range_tpu_torch.ops import retrieval_hier as rh

    ref = rh._hier_parts_family_plain(*args, **kw)
    mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    _within_terms(got, ref, mag, rows_off_max=max(rows_off_max, got.shape[0] // 100))


@pytest.mark.parametrize("form", ["rrlr", "rr", "sel", "dedup", "geo"])
@pytest.mark.parametrize("gpt", [8, 16, 32, 64, 128, 256])
def test_parts_sm90_matches_plain(cuda, form, gpt):
    """The Hopper body at every groups-a-tile the scan takes at bn 512
    (groups of 64 rows, one 64-row step, down to 2: the flagship's 16 and
    sizes no multiple of 8), each rr form: rr + lr, rr alone (1,152
    columns, three passes), sel (group logits over 64 sketch columns past
    the keys), dedup_pad (repeats in every row) and the geo family (its
    logits over the one k16 step of its 9 real columns)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    lr = form != "rr"
    args, lrr = _rr_operands(cuda, Bp=256, bm=128, bn=512, gpt=gpt, K=12, T=20,
                             W=384 if lr else 1152, lr=lr, sel=64 if form == "sel" else 0,
                             seed=gpt, geo=form == "geo")
    kw = dict(sem_d=256, bm=128, bn=512, gpt=gpt, geo=form == "geo", lrr=lrr, lr=lr,
              sel=form == "sel")
    if form == "dedup":
        idx = args[3]
        args = args[:3] + (torch.cat([idx[:, :3], idx[:, 2:3], idx[:, 3:9], idx[:, 8:9].repeat(
            1, 3)], 1).contiguous(),) + args[4:]
        kw.update(dedup_pad=True)
    fam = rh._hier_parts_family_call
    n0 = (fam.launches, fam.rrlr_launches, fam.rr_launches)
    got = fam(*args, **kw, geo_cols=9 if form == "geo" else None)
    torch.cuda.synchronize()
    assert (fam.launches, fam.rrlr_launches, fam.rr_launches) == (
        n0[0] + 1, n0[1] + int(lr), n0[2] + int(not lr))
    _hold_rr(got, args, kw)


# logits deeper than 256 columns: the `high` tier's 768 sem columns (three
# passes of 256), a wide-key bank's 384 and 1,024 at `fast` (1,024 with
# int8 codes, and the rr shapes, keep 12 or 8 query boxes resident and
# stream the rest) and the `high` tier of 384-d keys (1,152 columns)
DEEP_SEMS = [768, 384, 1024, 1152]


@pytest.mark.parametrize("sem", DEEP_SEMS)
@pytest.mark.parametrize("form", ["rrlr", "rr", "sel", "dedup", "geo"])
@pytest.mark.parametrize("gpt", [32, 64])
def test_parts_sm90_deep_matches_plain(cuda, form, gpt, sem):
    """Kernel 14's rr shapes over sem columns past 256 on the Hopper body:
    the row logits (and the sem family's group logits) in passes of 256
    columns, the accumulator carried; the geo family's logits at the sem
    columns' end.  Held to the plain version under the terms rule
    (`_hold_rr`: bf16 flips in at most max(7, B / 100) rows) over a plan of
    several segments; one count of `.launches` and of its shape's
    counter."""
    from range_tpu_torch.ops import retrieval_hier as rh

    lr = form != "rr"
    args, lrr = _rr_operands(cuda, Bp=384, bm=128, bn=512, gpt=gpt, K=12, T=20,
                             W=384 if lr else 1152, lr=lr, sel=64 if form == "sel" else 0,
                             seed=gpt + sem, geo=form == "geo", sem=sem)
    kw = dict(sem_d=sem, bm=128, bn=512, gpt=gpt, geo=form == "geo", lrr=lrr, lr=lr,
              sel=form == "sel")
    if form == "dedup":
        idx = args[3]
        args = args[:3] + (torch.cat([idx[:, :3], idx[:, 2:3], idx[:, 3:9], idx[:, 8:9].repeat(
            1, 3)], 1).contiguous(),) + args[4:]
        kw.update(dedup_pad=True)
    fam = rh._hier_parts_family_call
    n0 = (fam.launches, fam.rrlr_launches, fam.rr_launches, fam.f32_launches)
    got = fam(*args, **kw, geo_cols=9 if form == "geo" else None)
    again = fam(*args, **kw, geo_cols=9 if form == "geo" else None)
    torch.cuda.synchronize()
    assert (fam.launches, fam.rrlr_launches, fam.rr_launches, fam.f32_launches) == (
        n0[0] + 2, n0[1] + 2 * int(lr), n0[2] + 2 * int(not lr), n0[3])
    assert torch.equal(got, again)
    _hold_rr(got, args, kw)


def test_parts_sm90_deep_plans_agree(cuda):
    """The flagship's `high` shape (768 columns, 32 groups a tile of 512
    rows, 32 tiles a list) over the plan's segments and over one tile a
    segment: each holds the plain version."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, lrr = _rr_operands(cuda, Bp=1024, bm=128, bn=512, gpt=32, K=32, T=40, sem=768)
    kw = dict(sem_d=768, bm=128, bn=512, gpt=32, geo=False, lrr=lrr, lr=True, sel=False,
              dedup_pad=False)
    sh = rh._parts_shapes(*args, **{k: v for k, v in kw.items() if k != "dedup_pad"})
    plan = rh._parts_plan(1024, 32, 512, 32, sh["kf"], sh["gwe"], sh["share"], 128,
                          sh["acols"], sh["out_w"])
    outs = [rh._parts_family_rr(*args, **kw, plan=p)
            for p in (plan, plan._replace(n_seg=32, seg_cap=1))]
    torch.cuda.synchronize()
    for got in outs:
        _hold_rr(got, args, kw)


@pytest.mark.parametrize("lr", [True, False], ids=["rrlr", "rr"])
@pytest.mark.parametrize("bn", [1024, 2048])
def test_parts_sm90_groups_longer_than_a_step(cuda, bn, lr):
    """8 groups a tile of 1,024 or 2,048 rows: each group's sum of bf16(p)
    carries in the accumulator across its 2 or 4 64-row steps; the lists'
    24,576-row chains at bn 2,048 cut into segments."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, lrr = _rr_operands(cuda, Bp=256, bm=128, bn=bn, gpt=8, K=12, T=20,
                             W=384 if lr else 1152, lr=lr, seed=bn)
    kw = dict(sem_d=256, bm=128, bn=bn, gpt=8, geo=False, lrr=lrr, lr=lr, sel=False)
    _hold_rr(rh._hier_parts_family_call(*args, **kw), args, kw)


@pytest.mark.parametrize("lr", [True, False], ids=["rrlr", "rr"])
@pytest.mark.parametrize("bn,gpt", [(768, 8), (384, 8), (320, 16), (384, 32), (384, 64),
                                    (64, 16), (1536, 8)])
def test_parts_sm90_every_group_size(cuda, bn, gpt, lr):
    """Groups of no power of two: 96 rows (bn 768, 8 groups a tile: a bank
    the mma.sync body took), 48, 20, 12 and 6 (units of 32 to 2 rows whose
    sums are added through shared memory, a group ending inside a step), 192
    (three whole steps, carried in the accumulator); and groups of 4 rows
    at bn 64 (16 groups a tile of 16 units a step)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, lrr = _rr_operands(cuda, Bp=256, bm=128, bn=bn, gpt=gpt, K=12, T=20,
                             W=384 if lr else 1152, lr=lr, seed=bn + gpt)
    kw = dict(sem_d=256, bm=128, bn=bn, gpt=gpt, geo=False, lrr=lrr, lr=lr, sel=False)
    _hold_rr(rh._hier_parts_family_call(*args, **kw), args, kw)


@pytest.mark.parametrize("Bp,K", [(128, 96), (384, 96), (1024, 32)])
def test_parts_sm90_plans_agree(cuda, Bp, K):
    """The plan's cut (B = 1's two blocks over 96 tiles, the rescue's 6 x
    96, and a wide batch), the longest segments a block's shared memory
    holds, and a segment a tile: each the plain version's answer, a
    request's bits the same on every call."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, lrr = _rr_operands(cuda, Bp=Bp, bm=128, bn=512, gpt=32, K=K, T=100, seed=K)
    kw = dict(sem_d=256, bm=128, bn=512, gpt=32, geo=False, lrr=lrr, lr=True, sel=False,
              dedup_pad=False)
    sh = rh._parts_shapes(*args, **{k: v for k, v in kw.items() if k != "dedup_pad"})
    base = rh._parts_plan(Bp, K, 512, 32, sh["kf"], sh["gwe"], sh["share"], 128, sh["acols"],
                          sh["out_w"])
    assert Bp // 64 * base.n_seg >= min(132, Bp // 64 * K)
    longest = max(c for c in range(1, 26) if rh._parts_fits(rh._parts_layout(
        K, 512, 32, sh["kf"], sh["gwe"], sh["share"], 128, sh["acols"], c, 2)))
    for plan in (base, rh.PartsPlan(-(-K // longest), longest, 2), rh.PartsPlan(K, 1, 2)):
        got = rh._parts_family_rr(*args, **kw, plan=plan)
        again = rh._parts_family_rr(*args, **kw, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _hold_rr(got, args, kw)


def test_parts_sm90_rejects_what_it_does_not_take(cuda):
    """Fewer than 8 groups a tile (which the scan does not take) and f32
    operands raise; nothing falls back.  (Groups of one row at 512 a tile,
    which raised here before the D block in device memory, serve:
    test_parts_sm90_step_shapes.)"""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, lrr = _rr_operands(cuda, Bp=128, bm=128, bn=512, gpt=512, K=4, T=8)
    kw = dict(sem_d=256, bm=128, bn=512, gpt=4, geo=False, lrr=lrr)
    with pytest.raises(ValueError, match="unsupported shapes"):
        rh._hier_parts_family_call(*args, **kw)
    args, lrr = _rr_operands(cuda, Bp=128, bm=128, bn=512, gpt=32, K=4, T=8)
    with pytest.raises(ValueError, match="bfloat16"):  # f32 takes the CUDA-core body
        rh._hier_parts_family_call(args[0].half(), *args[1:], sem_d=256, bm=128, bn=512,
                                   gpt=32, geo=False, lrr=lrr)
    with pytest.raises(ValueError, match="bfloat16"):
        rh._parts_family_rr(args[0].float(), *args[1:], sem_d=256, bm=128, bn=512, gpt=32,
                            geo=False, lrr=lrr, lr=True, sel=False, dedup_pad=False)


def test_parts_wrapper_never_launches_the_mma_sync_body(cuda, monkeypatch):
    """`csrc/hier_parts_family.cu` stays only as chip_smoke.py's yardstick:
    the rr shapes, in every form, load the Hopper kernel's library alone."""
    from range_tpu_torch.kernels import _build
    from range_tpu_torch.ops import retrieval_hier as rh

    loaded = []
    real = _build.load_kernel_library

    def spy(name):
        loaded.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load_kernel_library", spy)
    for lr, sel, dedup in ((True, 0, False), (False, 0, False), (True, 64, False),
                           (True, 0, True)):
        args, lrr = _rr_operands(cuda, Bp=128, bm=128, bn=128, gpt=8, K=6, T=10,
                                 W=384 if lr else 1152, lr=lr, sel=sel)
        rh._hier_parts_family_call(*args, sem_d=256, bm=128, bn=128, gpt=8, geo=False,
                                   lrr=lrr, lr=lr, sel=bool(sel), dedup_pad=dedup)
    torch.cuda.synchronize()
    assert set(loaded) == {"hier_parts_family_sm90"}


@pytest.mark.parametrize("name,bar", [("RANGE+", 0.12), ("RANGE", 0.10)])
def test_gsz_sem_4_bank_serves(cuda, name, bar):
    """A bank of groups of 4 rows at bn 512 (128 groups a tile, which the
    card's parts kernels took at most 64 of): load_model(retrieval="hier",
    gsz_sem=4) serves within the defaults bank's relerr bar, through
    kernel 15 (the merged parts kernel) at 128 groups a tile; kernel 14's
    value and rr shapes at 128 groups a tile against their plain
    versions."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 20_000, pad_to=512, value_dtype=torch.bfloat16,
                                         device=cuda)
    enc = load_model(name, db_path=bank, retrieval="hier", gsz_sem=4)
    hb = enc.model.bank
    assert hb.bn // hb.gsz_sem == 128
    coords = _coords(2000, seed=41, device=cuda)
    n0 = rh._hier_parts_call.launches
    out = enc(coords)
    torch.cuda.synchronize()
    assert rh._hier_parts_call.launches == n0 + 1
    temp = enc.model.config.resolved_sem_temp()
    ref = (retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), bank, sem_temp=temp,
                              beta=0.5) if name == "RANGE+" else
           retrieval.retrieve(out[:, 1024:], None, bank, sem_temp=temp, mode="range"))
    rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.mean().item() <= bar
    if name == "RANGE":
        return
    from range_tpu_torch.ops import retrieval_fused as rf

    hb_rr = rh.build_hier_bank(bank, bn=512, gsz_sem=4, gsz_geo=64, lr_rank=256,
                               res_rank=128)
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.nn.functional.normalize(torch.randn(700, 256, generator=g, device=cuda), dim=1)
    q_s, q_x = rh._pad_queries(q, lonlat_deg_to_xyz(_coords(700, seed=11, device=cuda)), 128)
    q = rf.pack_queries(q_s, q_x, 12.0, 40.0, "fast")[rh._hybrid_order(q_x, 700)].contiguous()
    stats = rh._hier_scan_stats_plain(q, hb_rr.g_sem_cat, hb_rr.g_geo_cat, gpt_s=128, gpt_g=8)
    idx, _ = rh.select_tiles(*stats, t_real=hb_rr.t_real, k_tiles=8, bm=128, n_valid=700,
                             mode="range")
    for z, vw, lr, lrr in ((hb_rr.z_sem, hb_rr.g_sem_vw_lr, True, 256),
                           (None, hb_rr.g_sem_vw_lr, True, 256),
                           (None, hb_rr.g_sem_vw, False, 1024)):
        args = (q, hb_rr.k_cat, hb_rr.mask_neg, idx, hb_rr.g_sem_cat, vw, z)
        kw = dict(sem_d=256, bm=128, bn=512, gpt=128, geo=False, lrr=lrr, lr=lr,
                  values=hb_rr.values, scale=None)
        got = rh._hier_parts_family_call(*args, **kw)
        ref = rh._hier_parts_family_plain(*args, **kw)
        mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
        _within_terms(got, ref, mag, rows_off_max=7)


# ---- kernels 3 and 5 on the Hopper body (csrc/fused_retrieval_sm90.cu)

# Tolerances as kernel 2's (test_fused_kernel_matches_plain) and kernel 5's
# (test_fused_parts_kernel_matches_plain): the segments re-associate the f32
# sums; a weight bf16(p s) that the logits' summation order moves across a
# rounding boundary rounds the other way, one ulp of that term, in at most
# max(2, B / 100) rows.


def _forms_operands(cuda, B, tier="fast", n=30_001):
    """A masked bank of 30,001 rows (several segments, the last ragged)
    with bf16 values and their int8 codes, and B packed queries."""
    from range_tpu_torch.bank import quantize_values

    bank = GeoBank.synthetic(5, n, key_dim=256, value_dim=1024, pad_to=7, device=cuda)
    bank8 = quantize_values(bank)
    g = torch.Generator(device=cuda).manual_seed(B)
    q = torch.nn.functional.normalize(torch.randn(B, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(max(B, 2), seed=B, device=cuda)[:B])
    q_cat = rf.pack_queries(q, x, 12.0, 40.0, tier)
    k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, tier)
    mask = (rf.NEG * (1 - bank.row_mask()))[None]
    return (bank.values.to(torch.bfloat16), None), (bank8.values, bank8.value_scale), q_cat, \
        k_cat, mask, rf.packed_dims(256, tier)[0]


def _hold_parts(got, q_cat, k_cat, v, mask, s, sem_d):
    B, Dv = q_cat.shape[0], v.shape[1]
    ref = rf._retrieve_fused_parts_plain(q_cat, k_cat, v, mask, s, sem_d=sem_d)
    mag = rf._retrieve_fused_parts_plain(q_cat, k_cat, v.abs(), mask, s, sem_d=sem_d)
    assert got.shape == (B, 2 * Dv + 128)
    for cols in (slice(0, Dv), slice(Dv, 2 * Dv)):
        _within_terms(got[:, cols], ref[:, cols], mag[:, cols], rows_off_max=max(2, B // 100))
    d = slice(2 * Dv, 2 * Dv + 2)
    torch.testing.assert_close(got[:, d], ref[:, d], rtol=1e-5, atol=0)
    assert (got[:, 2 * Dv + 2:] == 0).all()


@pytest.mark.parametrize("form", ["i8", "parts", "parts_i8"])
@pytest.mark.parametrize("B", [1, 37, 1000])
def test_fused_sm90_int8_and_parts_match_plain(cuda, form, B):
    """Kernel 3 (int8 codes, the blend) and kernel 5 (the partials, bf16
    values and int8 codes) on the Hopper body, through their wrappers (the
    plan's segments: several, the last ragged) and over one segment, at B
    = 1, 37 and 1,000, against their plain versions; each launch counted
    in its own counter."""
    bf16, int8, q_cat, k_cat, mask, sem_d = _forms_operands(cuda, B)
    v, s = int8 if form != "parts" else bf16
    N = k_cat.shape[0]
    plan = rf._segment_plan(B, N, 1024, sem_d, i8=s is not None)
    one = plan._replace(n_seg=1, seg_rows=-(-N // plan.bn) * plan.bn)
    assert plan.n_seg > 1 and N % plan.seg_rows
    fp, i8 = rf.retrieve_fused_parts, rf.retrieve_fused_i8
    n0 = (i8.launches, fp.launches, fp.i8_launches)
    if form == "i8":
        got = rf.retrieve_fused_i8(q_cat, k_cat, v, s, mask, 0.5, sem_d=sem_d)
    else:
        got = rf.retrieve_fused_parts(q_cat, k_cat, v, mask, s, sem_d=sem_d)
    torch.cuda.synchronize()
    assert (i8.launches, fp.launches, fp.i8_launches) == (
        n0[0] + (form == "i8"), n0[1] + (form == "parts"), n0[2] + (form == "parts_i8"))
    single = rf._launch_sm90(q_cat, k_cat, v, mask, 0.5, sem_d, one, scale=s,
                             parts=form != "i8")
    for out in (got, single):
        if form == "i8":
            ref = rf._retrieve_fused_plain(q_cat, k_cat, v, mask, 0.5, s, sem_d=sem_d)
            err = (out - ref).abs()
            vmax = (v.float() * s.T).abs().max()
            assert err.max() <= vmax / 128
            assert (err > 1e-4).any(dim=1).sum() <= max(2, B // 100)
        else:
            _hold_parts(out, q_cat, k_cat, v, mask, s, sem_d)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_fused_sm90_high_tier_parts_and_int8(cuda, quant):
    """The 'high' tier (the cluster form, 128-column slices in clusters of
    4) with int8 codes (kernel 3) and the partials (kernel 5), against
    their plain versions."""
    bf16, int8, q_cat, k_cat, mask, sem_d = _forms_operands(cuda, 77, tier="high", n=3001)
    v, s = int8 if quant else bf16
    plan = rf._segment_plan(77, k_cat.shape[0], 1024, sem_d, i8=quant)
    assert plan.cs == 4 and plan.dvs == 128
    _hold_parts(rf.retrieve_fused_parts(q_cat, k_cat, v, mask, s, sem_d=sem_d), q_cat, k_cat,
                v, mask, s, sem_d)
    if quant:
        got = rf.retrieve_fused_i8(q_cat, k_cat, v, s, mask, 0.5, sem_d=sem_d)
        ref = rf._retrieve_fused_plain(q_cat, k_cat, v, mask, 0.5, s, sem_d=sem_d)
        err = (got - ref).abs()
        assert err.max() <= (v.float() * s.T).abs().max() / 128
        assert (err > 1e-4).any(dim=1).sum() <= 2


def test_fused_wrappers_never_launch_the_mma_sync_body(cuda, monkeypatch):
    """On bf16 operands kernel 3 and kernel 5 (bf16 and int8 values) load
    the Hopper body's library alone: `fused_retrieval_i8_launch` and
    `fused_parts_launch` of `csrc/fused_retrieval.cu` stay for f32
    operands and as chip_smoke.py's same-run yardstick."""
    from range_tpu_torch.kernels import _build

    loaded = []
    real = _build.load_kernel_library

    def spy(name):
        loaded.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load_kernel_library", spy)
    bf16, int8, q_cat, k_cat, mask, sem_d = _forms_operands(cuda, 37, n=3001)
    rf.retrieve_fused_i8(q_cat, k_cat, *int8, mask, 0.5, sem_d=sem_d)
    for v, s in (bf16, int8):
        rf.retrieve_fused_parts(q_cat, k_cat, v, mask, s, sem_d=sem_d)
    torch.cuda.synchronize()
    assert set(loaded) == {"fused_retrieval_sm90"}


@pytest.mark.parametrize("name,quant", [("RANGE+", None), ("RANGE+", "int8"), ("RANGE", None)])
def test_mesh_matches_one_card(cuda, tmp_path, name, quant):
    """A (1, 1) mesh (kernel 5 and one all_reduce, the division and blend
    in torch) answers what one card does (kernels 2 and 3): the same plan
    cuts the bank alike, so the partials are the same sums, and only the
    last division and blend may round apart: within 1e-5 x row max, at a
    batch of several segments (B = 1,000)."""
    import torch.distributed as dist

    from range_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        kw = dict(db_path="synthetic:30000", chunk=1024, value_quant=quant)
        enc = load_model(name, mesh=make_mesh((1, 1)), **kw)
        one = load_model(name, **kw)
        coords = _coords(1000, seed=21, device=cuda)
        got, ref = enc(coords), one(coords)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        assert (err <= 1e-5 * ref.abs().amax(dim=1, keepdim=True)).all(), err.max()
    finally:
        dist.destroy_process_group()


# ---- kernel 14's rr shapes on tiles of no whole 64-row step and on
# groupings whose common layout fits no block


@pytest.mark.parametrize("lr", [True, False], ids=["rrlr", "rr"])
@pytest.mark.parametrize("bn,gpt", [(96, 8), (160, 8), (192, 64), (384, 128), (192, 192),
                                    (512, 512), (832, 416), (1792, 448), (24, 8), (48, 16),
                                    (96, 32), (96, 16), (32, 32)])
def test_parts_sm90_step_shapes(cuda, bn, gpt, lr):
    """96- and 160-row tiles (8 groups of 12 and 20 rows: a masked last
    step), groups of 3 rows at 64 and 128 a tile (the DIRECT walk), of 1
    row at 192 and 512 a tile (DIRECT; at 512 with the D block in device
    memory), of 2 at 416 and of 4 at 448 (the D block in device memory),
    and tiles of less than one step (24, 48, 96 and 32 rows of 3-, 6- and
    1-row groups; the odd ones by the DIRECT walk): each against the plain
    version, a request's bits the same on every call."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, lrr = _rr_operands(cuda, Bp=256, bm=128, bn=bn, gpt=gpt, K=6, T=10,
                             W=384 if lr else 1152, lr=lr, seed=bn + gpt)
    kw = dict(sem_d=256, bm=128, bn=bn, gpt=gpt, geo=False, lrr=lrr, lr=lr, sel=False)
    got = rh._hier_parts_family_call(*args, **kw)
    again = rh._hier_parts_family_call(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _hold_rr(got, args, kw)


@pytest.mark.parametrize("bn,gsz", [(96, 12), (384, 3)])
@pytest.mark.parametrize("name,bar", [("RANGE+", 0.12), ("RANGE", 0.10)])
def test_step_banks_serve(cuda, bn, gsz, name, bar):
    """Banks that the card's rr shapes refused before: 96-row tiles of
    12-row groups (both families), and 3-row sem groups at bn 384, with
    lr / rr / lr_geo (kernel 14's rr + lr shape), through
    load_model(retrieval="hier") within the defaults bank's relerr bar, at
    the defaults' coverage: k_tiles selects as many rows as 16 tiles of
    512 (85 tiles of 96, 21 of 384)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 20_000, pad_to=bn, value_dtype=torch.bfloat16,
                                         device=cuda)
    enc = load_model(name, db_path=bank, retrieval="hier", hier_bn=bn, gsz_sem=gsz,
                     gsz_geo=12 if bn == 96 else 48, lr_rank=256, lr_geo=384, res_rank=128,
                     k_tiles=16 * 512 // bn)
    coords = _coords(2000, seed=43, device=cuda)
    fam = rh._hier_parts_family_call
    n0 = fam.rrlr_launches
    out = enc(coords)
    torch.cuda.synchronize()
    if name == "RANGE+":
        assert fam.rrlr_launches >= n0 + 1
    temp = enc.model.config.resolved_sem_temp()
    ref = (retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), bank, sem_temp=temp,
                              beta=0.5) if name == "RANGE+" else
           retrieval.retrieve(out[:, 1024:], None, bank, sem_temp=temp, mode="range"))
    rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
    assert torch.isfinite(out).all() and rel.mean().item() <= bar


# ---- the odd-group-size banks the rr shapes refused before (a tile's
# last chunk of the groups left over past the 64-group chunks)


@pytest.mark.parametrize("lr", [True, False], ids=["rrlr", "rr"])
@pytest.mark.parametrize("bn,gpt", [(288, 96), (96, 96), (480, 160), (160, 160), (224, 224)])
def test_parts_sm90_short_last_chunk(cuda, bn, gpt, lr):
    """Odd group sizes at an odd multiple of 32 groups a tile (3 rows at 96
    and 160 a tile, 1 row at 96, 160 and 224): 64-group chunks end on a
    step and the last chunk, of 32 groups, ends in the tile's masked last
    step; each against the plain version, a request's bits the same on
    every call."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, lrr = _rr_operands(cuda, Bp=256, bm=128, bn=bn, gpt=gpt, K=6, T=10,
                             W=384 if lr else 1152, lr=lr, seed=bn + gpt)
    kw = dict(sem_d=256, bm=128, bn=bn, gpt=gpt, geo=False, lrr=lrr, lr=lr, sel=False)
    got = rh._hier_parts_family_call(*args, **kw)
    again = rh._hier_parts_family_call(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _hold_rr(got, args, kw)


@pytest.mark.parametrize("bn,gsz_sem,gsz_geo", [(288, 3, 36), (96, 1, 12), (480, 3, 60)])
@pytest.mark.parametrize("name,bar", [("RANGE+", 0.12), ("RANGE", 0.10)])
def test_odd_group_banks_serve(cuda, bn, gsz_sem, gsz_geo, name, bar):
    """Banks of 96 or 160 sem groups a tile of 3 or 1 rows (8 geo groups a
    tile) with lr / rr / lr_geo, through load_model(retrieval="hier")
    within the defaults bank's relerr bar, at the defaults' coverage (k
    tiles of 16 x 512 rows), kernel 14's rr shapes launched."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(3, 20_000, pad_to=bn, value_dtype=torch.bfloat16,
                                         device=cuda)
    enc = load_model(name, db_path=bank, retrieval="hier", hier_bn=bn, gsz_sem=gsz_sem,
                     gsz_geo=gsz_geo, lr_rank=256, lr_geo=384, res_rank=128,
                     k_tiles=16 * 512 // bn)
    coords = _coords(2000, seed=47, device=cuda)
    fam = rh._hier_parts_family_call
    n0 = fam.rrlr_launches
    out = enc(coords)
    torch.cuda.synchronize()
    if name == "RANGE+":
        assert fam.rrlr_launches >= n0 + 1
    temp = enc.model.config.resolved_sem_temp()
    ref = (retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), bank, sem_temp=temp,
                              beta=0.5) if name == "RANGE+" else
           retrieval.retrieve(out[:, 1024:], None, bank, sem_temp=temp, mode="range"))
    rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
    assert torch.isfinite(out).all() and rel.mean().item() <= bar


# ---- the Hopper values kernel (`csrc/hier_parts_sm90.cu`): kernel 15 and
# kernel 14's value shapes.  Tolerances as the kernel checks' terms rule
# (`_within_terms` over each segment of the output, the bf16-flip allowance
# in max(2, B / 100) rows); the segments only re-associate the f32 sums.


def _values_operands(cuda, *, Bp, bm, bn, K, T, gpt_s, gpt_g=8, Dv=1024, W=256, sel=0, seed=0,
                     i8=False, sem=256):
    """Random operands of the values kernel: ``sem`` (256; the `high`
    tier's 768) sem + 128 geo packed columns (9 real geo ones; the sem ones
    scaled so that a logit's spread is the 256 columns'), T tiles of bn
    rows, gpt_s sem and gpt_g geo
    groups a tile, each query block's list K distinct tiles, values [N,
    Dv] (int8 codes and a row scale with ``i8``), the last 7 bank rows
    masked; the sem centroids [Gs, 256] (``sel``: [Gs, sel], the query
    operand carrying sel sketch columns past the keys'), the geo ones [Gg,
    128] with 9 real columns; vw: lr coefficients [Gs, W], and the
    full-width sums of both families [G, Dv + 128] with the group's row
    count in column Dv."""
    rng = np.random.default_rng(seed)

    def bf(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
            cuda).bfloat16()

    N, Gs, Gg = T * bn, T * gpt_s, T * gpt_g
    sc = 0.35 * (256 / sem) ** 0.5
    q = bf((Bp, sem + 128 + sel), sc)
    k = bf((N, sem + 128), sc)
    q[:, sem + 9:sem + 128] = 0
    k[:, sem + 9:sem + 128] = 0
    mask = torch.zeros(1, N, device=cuda)
    mask[0, -7:] = -1e30
    if i8:
        values = torch.from_numpy(rng.integers(-127, 128, (N, Dv)).astype(np.int8)).to(cuda)
        scale = torch.from_numpy(rng.uniform(0.002, 0.01, (1, N)).astype(np.float32)).to(cuda)
    else:
        values, scale = bf((N, Dv), 1.0), None
    idx = torch.from_numpy(np.stack([rng.permutation(T)[:K] for _ in range(Bp // bm)]).astype(
        np.int32)).to(cuda)

    def sums(G, gpt):
        vw = bf((G, Dv + 128), 1.0)
        vw[:, Dv] = float(bn // gpt)
        vw[:, Dv + 1:] = 0
        return vw

    g_sem = bf((Gs, sel or sem), sc)
    g_geo = bf((Gg, 128), 0.35)
    g_geo[:, 9:] = 0
    return dict(q=q, k=k, values=values, scale=scale, mask=mask, idx=idx, g_sem=g_sem,
                g_geo=g_geo, vw_lr=bf((Gs, W), 1.0), vw_sem=sums(Gs, gpt_s),
                vw_geo=sums(Gg, gpt_g), vw_geo_lr=bf((Gg, W), 1.0))


def _merged_call(o, *, bm, bn, gpt_s, gpt_g, lr, geo):
    args = (o["q"], o["k"], o["values"], o["scale"], o["mask"], o["idx"], o["g_sem"],
            o["g_geo"], o["vw_lr"] if lr else o["vw_sem"], o["vw_geo"])
    return args, dict(sem_d=o["k"].shape[1] - 128, bm=bm, bn=bn, gpt_s=gpt_s, gpt_g=gpt_g,
                      lr=lr, geo=geo)


def _family_call(o, *, bm, bn, gpt, lr, geo, sel=False, dedup=False):
    g = o["g_geo"] if geo else o["g_sem"]
    vw = (o["vw_geo_lr"] if geo else o["vw_lr"]) if lr else (o["vw_geo"] if geo else o["vw_sem"])
    args = (o["q"], o["k"], o["mask"], o["idx"], g, vw, None)
    return args, dict(sem_d=o["k"].shape[1] - 128, bm=bm, bn=bn, gpt=gpt, geo=geo, lrr=0, lr=lr,
                      values=o["values"], scale=o["scale"], sel=sel, dedup_pad=dedup)


def _hold_values(got, ref, mag, args, kw):
    """Each segment of a values launch's output against the plain version
    (`_within_terms`, bf16 flips in at most max(2, B / 100) rows): acc (each
    family's), d, the pad columns and alr, each against its own row
    maximum."""
    assert got.shape == ref.shape and torch.isfinite(got).all()
    merged = "gpt_s" in kw
    Dv = (args[2] if merged else kw["values"]).shape[1]
    a = 2 * Dv if merged else Dv  # acc | (acc_g) | d | pad | alr
    segs = [slice(0, Dv), slice(a, a + (2 if merged else 1)), slice(a + (2 if merged else 1),
                                                                    a + 128)]
    segs += [slice(Dv, 2 * Dv)] if merged else []
    segs += [slice(a + 128, None)] if got.shape[1] > a + 128 else []
    for c in segs:
        _within_terms(got[:, c], ref[:, c], mag[:, c], rows_off_max=max(2, got.shape[0] // 100))


VALUE_FORMS = ["merged_lr", "merged_lr_geo", "merged_plain", "merged_plain_geo",
               "family_lr_sem", "family_lr_geo", "family_plain_sem", "family_plain_geo",
               "family_sel_lr", "family_sel_plain", "family_dedup_lr", "family_dedup_plain"]


def _values_form(cuda, form, *, Bp, bm, bn, K, T, gpt, i8, seed, Dv=1024, W=256, sem=256):
    """Operands, keywords, the wrapper and the plain version of one form."""
    from range_tpu_torch.ops import retrieval_hier as rh

    geo = form.endswith("geo")
    gpt_g = gpt if geo and form.startswith("family") else 8
    o = _values_operands(cuda, Bp=Bp, bm=bm, bn=bn, K=K, T=T, gpt_s=gpt, gpt_g=gpt_g, Dv=Dv,
                         W=W, sel=64 if "sel" in form else 0, seed=seed, i8=i8, sem=sem)
    lr = "lr" in form
    if form.startswith("merged"):
        args, kw = _merged_call(o, bm=bm, bn=bn, gpt_s=gpt, gpt_g=8, lr=lr, geo=geo)
        return args, kw, rh._hier_parts_call, rh._hier_parts_plain
    dedup = "dedup" in form
    if dedup:  # repeats of the entry before it in every row
        idx = o["idx"]
        o["idx"] = torch.cat([idx[:, :2], idx[:, 1:2], idx[:, 2:-2], idx[:, -3:-2]],
                             1).contiguous()
    args, kw = _family_call(o, bm=bm, bn=bn, gpt=gpt_g if geo else gpt, lr=lr, geo=geo,
                            sel="sel" in form, dedup=dedup)
    return args, kw, rh._hier_parts_family_call, rh._hier_parts_family_plain


@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("form", VALUE_FORMS)
def test_values_sm90_matches_plain(cuda, form, quant):
    """Every form of kernel 15 (lr / plain sem groups, with and without the
    geo family) and of kernel 14's value shapes (plain / lr, sem / geo, sel
    over 64 sketch columns, dedup_pad with repeats in every row), bf16 and
    int8, at the flagship's widths (Dv 1,024, lr 256 columns) and the
    flagship's 32 groups a tile of 512 rows, against the plain version."""
    args, kw, call, plain = _values_form(cuda, form, Bp=384, bm=128, bn=512, K=12, T=24,
                                         gpt=32, i8=quant == "int8", seed=len(form))
    got = call(*args, **kw)
    again = call(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    _hold_values(got, plain(*args, **kw), plain(*args, **kw, magnitude=True), args, kw)


@pytest.mark.parametrize("sem", DEEP_SEMS)
@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("form", VALUE_FORMS)
def test_values_sm90_deep_matches_plain(cuda, form, quant, sem):
    """Every form of kernel 15 and of kernel 14's value shapes with sem
    logits (row and group) over more than 256 columns on the values
    kernel's Hopper body: each step and each sem chunk in passes of 256
    columns (ring items of their own, the accumulator carried), then its
    payload; against the plain version, deterministic, two counts of
    `.launches` and none on the CUDA-core body.  1,024 queries, as
    chip_smoke's B = 1,000 request: the deeper f32 chain moves a bf16(e)
    over its rounding boundary more often than 256 columns do (one form's
    d column at 768 columns: 5 of 384 rows past the row cap, 4 of 1,024,
    each within 0.7% of its flip bound), against max(2, B / 100) rows."""
    args, kw, call, plain = _values_form(cuda, form, Bp=1024, bm=128, bn=512, K=12, T=24,
                                         gpt=32, i8=quant == "int8", seed=len(form) + sem,
                                         sem=sem)
    n0 = (call.launches, call.f32_launches)
    got = call(*args, **kw)
    again = call(*args, **kw)
    torch.cuda.synchronize()
    assert (call.launches, call.f32_launches) == (n0[0] + 2, n0[1])
    assert torch.equal(got, again)
    _hold_values(got, plain(*args, **kw), plain(*args, **kw, magnitude=True), args, kw)


@pytest.mark.parametrize("form", ["merged_plain_geo", "merged_lr", "family_plain_sem",
                                  "family_sel_lr"])
@pytest.mark.parametrize("bn,gpt", [(512, 8), (512, 16), (512, 64), (512, 128), (96, 8)])
def test_values_sm90_deep_groupings(cuda, bn, gpt, form):
    """The `high` tier's 768 columns at chunks of 8 to 64 groups (centroid
    passes of 64 rows, e over the chunk's), two chunks a tile, and 96-row
    tiles (a masked last step)."""
    args, kw, call, plain = _values_form(cuda, form, Bp=256, bm=128, bn=bn, K=8,
                                         T=12, gpt=gpt, i8=False, seed=gpt + bn, sem=768)
    got = call(*args, **kw)
    torch.cuda.synchronize()
    _hold_values(got, plain(*args, **kw), plain(*args, **kw, magnitude=True), args, kw)


@pytest.mark.parametrize("sem", [1280, 2048])
def test_parts_deep_streams_past_the_resident_boxes(cuda, sem):
    """Past what a block holds beside the ring (1,280 columns, the
    CUDA-core body's widest, and 2,048) both parts kernels keep their first
    boxes resident (a multiple of 4, fewer than the logits') and stream the
    rest, two boxes a pass with their query boxes: kernel 14's rr + lr and
    rr shapes (both plans' layouts) and the values kernel's merged lr with
    the geo family and family plain sem (bf16 and int8), against the plain
    version; each launch counted in `.launches`, none on the CUDA-core
    body.  The values forms over 1,024 queries, as in
    `test_values_sm90_deep_matches_plain`: the d column's bf16(e) flips
    grow with the chain's depth (3 of 256 rows at 2,048 columns against
    an allowance of 2; the rule allows 1%)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    fam = rh._hier_parts_family_call
    for lr in (True, False):
        args, lrr = _rr_operands(cuda, Bp=256, bm=128, bn=512, gpt=32, K=12, T=20,
                                 W=384 if lr else 1152, lr=lr, seed=sem + lr, sem=sem)
        kw = dict(sem_d=sem, bm=128, bn=512, gpt=32, geo=False, lrr=lrr, lr=lr, sel=False)
        sh = rh._parts_shapes(*args, **kw)
        plan = rh._parts_plan(256, 12, 512, 32, sh["kf"], sh["gwe"], sh["share"], 128,
                              sh["acols"], sh["out_w"])
        assert plan.res is not None and plan.res % 4 == 0 and plan.res < sem // 64
        n0 = (fam.launches, fam.f32_launches)
        _hold_rr(fam(*args, **kw), args, kw)
        assert (fam.launches, fam.f32_launches) == (n0[0] + 1, n0[1])
    for form in ("merged_lr_geo", "family_plain_sem"):
        for i8 in (False, True):
            args, kw, call, plain = _values_form(cuda, form, Bp=1024, bm=128, bn=512, K=8,
                                                 T=12, gpt=32, i8=i8, seed=sem + i8, sem=sem)
            n0 = (call.launches, call.f32_launches)
            got = call(*args, **kw)
            torch.cuda.synchronize()
            assert (call.launches, call.f32_launches) == (n0[0] + 1, n0[1])
            _hold_values(got, plain(*args, **kw), plain(*args, **kw, magnitude=True), args,
                         kw)


def test_deep_parts_never_launch_hier_cores(cuda, monkeypatch):
    """`csrc/hier_cores.cu`'s bf16 deep instances of the parts kernels stay
    only as chip_smoke.py's yardstick: kernel 14's four shapes (both
    families) and kernel 15 (lr, plain) over 768 sem columns load the two
    Hopper bodies' libraries alone."""
    from range_tpu_torch.kernels import _build

    loaded = []
    real = _build.load_kernel_library

    def spy(name):
        loaded.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load_kernel_library", spy)
    for form in ("merged_lr_geo", "merged_plain", "family_lr_sem", "family_plain_geo"):
        args, kw, call, _ = _values_form(cuda, form, Bp=128, bm=128, bn=128, K=4, T=6, gpt=8,
                                         i8=False, seed=1, sem=768)
        call(*args, **kw)
    from range_tpu_torch.ops import retrieval_hier as rh

    for lr in (True, False):
        args, lrr = _rr_operands(cuda, Bp=128, bm=128, bn=128, gpt=8, K=4, T=6,
                                 W=384 if lr else 1152, lr=lr, sem=768)
        rh._hier_parts_family_call(*args, sem_d=768, bm=128, bn=128, gpt=8, geo=False,
                                   lrr=lrr, lr=lr)
    torch.cuda.synchronize()
    assert set(loaded) == {"hier_parts_sm90", "hier_parts_family_sm90"}


# (bn, gpt) of the groupings csrc/hier_parts.cu took: 8 to 512 groups a
# tile of 512 rows (64-group chunks past 64, groups of one row at 512),
# 128- and 64-row tiles, 96- and 160-row tiles (a masked last step), and
# odd group sizes at an odd multiple of 32 a tile (a short last chunk)
VALUE_GROUPINGS = [(512, 8), (512, 16), (512, 64), (512, 128), (512, 256), (512, 512),
                   (128, 8), (64, 16), (96, 8), (160, 8), (288, 96), (160, 160), (96, 32)]


@pytest.mark.parametrize("form", ["merged_plain_geo", "merged_lr", "family_plain_sem",
                                  "family_lr_geo"])
@pytest.mark.parametrize("bn,gpt", VALUE_GROUPINGS)
def test_values_sm90_every_grouping(cuda, bn, gpt, form):
    """Each grouping through the merged plain (both families: the sem and
    the geo chunks), merged lr (the alr blocks), family plain and the geo
    family's lr launch, against the plain version."""
    args, kw, call, plain = _values_form(cuda, form, Bp=256, bm=128, bn=bn, K=8, T=12,
                                         gpt=gpt, i8=False, seed=bn + gpt)
    _hold_values(call(*args, **kw), plain(*args, **kw), plain(*args, **kw, magnitude=True),
                 args, kw)


@pytest.mark.parametrize("Dv,W", [(128, 128), (640, 512), (1024, 384)])
@pytest.mark.parametrize("form", ["merged_lr_geo", "family_lr_sem", "family_plain_geo"])
def test_values_sm90_widths(cuda, form, Dv, W):
    """Value widths of one slice and of a ragged last slice (640: two and a
    half), alr widths of one and two blocks: the columns past each slice
    are never written, every column of the output is."""
    args, kw, call, plain = _values_form(cuda, form, Bp=256, bm=128, bn=256, K=6, T=10, gpt=16,
                                         i8=False, seed=Dv + W, Dv=Dv, W=W)
    _hold_values(call(*args, **kw), plain(*args, **kw), plain(*args, **kw, magnitude=True),
                 args, kw)


@pytest.mark.parametrize("bm", [64, 128, 256])
@pytest.mark.parametrize("form", ["merged_lr", "family_plain_sem", "family_dedup_lr"])
def test_values_sm90_plans_agree(cuda, form, bm, monkeypatch):
    """The plan's cut, one segment a list, a segment a tile, and 64 queries
    a block beside 128: each the plain version's answer, a request's bits
    the same on every call of one plan."""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, kw, call, plain = _values_form(cuda, form, Bp=512, bm=bm, bn=512, K=10, T=24, gpt=32,
                                         i8=False, seed=bm)
    ref, mag = plain(*args, **kw), plain(*args, **kw, magnitude=True)
    real = rh._values_sm90
    plans = [None, rh.ValuesPlan(64, 1, 2), rh.ValuesPlan(64, 10, 2)]
    if bm % 128 == 0:
        plans.append(rh.ValuesPlan(128, 3, 2))
    for plan in plans:
        # the wrappers look the launcher up in the module: fix its plan
        monkeypatch.setattr(rh, "_values_sm90", lambda *a, _p=plan, **k: real(*a, **k, plan=_p))
        got = call(*args, **kw)
        again = call(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        _hold_values(got, ref, mag, args, kw)


def test_values_sm90_rejects_what_it_does_not_take(cuda):
    """Key widths past four 64-column boxes, f32 operands, and an lr width
    past 512 raise before any launch of the Hopper values body; nothing
    falls back.  (The wrappers send the first two to the CUDA-core body,
    test_cores_forms_match_plain.)"""
    from range_tpu_torch.ops import retrieval_hier as rh

    args, kw, call, _ = _values_form(cuda, "merged_lr_geo", Bp=128, bm=128, bn=128, K=4, T=6,
                                     gpt=8, i8=False, seed=1)
    q, k, v, sc, mask, idx, gs, gg, vs, vg = args
    sm90 = dict(sem_d=kw["sem_d"], bm=kw["bm"], bn=kw["bn"], merged=True, lr=kw["lr"])
    fams = ((gs, vs, kw["gpt_s"]), (gg, vg, kw["gpt_g"]))
    with pytest.raises(ValueError, match="unsupported shapes"):
        rh._values_sm90("hier_parts", q, k, v, sc, mask, idx, *fams, **{**sm90, "sem_d": 320})
    with pytest.raises(ValueError, match="bfloat16"):
        rh._values_sm90("hier_parts", q.float(), k, v, sc, mask, idx, *fams, **sm90)
    with pytest.raises(ValueError, match="bfloat16"):
        call(args[0].half(), *args[1:], **kw)
    args, kw, call, _ = _values_form(cuda, "family_lr_sem", Bp=128, bm=128, bn=128, K=4, T=6,
                                     gpt=8, i8=False, seed=1, W=640)
    with pytest.raises(ValueError, match="unsupported shapes"):
        call(*args, **kw)


def test_values_wrappers_never_launch_hier_parts_cu(cuda, monkeypatch):
    """`csrc/hier_parts.cu` stays only as chip_smoke.py's yardstick: every
    merged launch and every value shape of the family call, bf16 and int8,
    load the Hopper values kernel's library alone."""
    from range_tpu_torch.kernels import _build

    loaded = []
    real = _build.load_kernel_library

    def spy(name):
        loaded.append(name)
        return real(name)

    monkeypatch.setattr(_build, "load_kernel_library", spy)
    for form in VALUE_FORMS:
        for i8 in (False, True):
            args, kw, call, _ = _values_form(cuda, form, Bp=128, bm=128, bn=128, K=4, T=6,
                                             gpt=8, i8=i8, seed=3)
            call(*args, **kw)
    torch.cuda.synchronize()
    assert set(loaded) == {"hier_parts_sm90"}


# ---- the exact and high tiers: the CUDA-core body (csrc/hier_cores.cu)

# (tier, the bank's value dtype): the exact tier with f32 values (JAX's
# value_dtype override) and with the serving default, and the high tier
TIERS = [("exact", torch.float32), ("exact", torch.bfloat16), ("high", torch.bfloat16)]
TIER_IDS = ["exact-f32", "exact-bf16", "high"]
_TIER_BANKS = {}


def _tier_bank(cuda, tier, value_dtype, pad_to=512, **knobs):
    """The hier_bank fixture's bank and knobs built on the card at ``tier``
    (cached for the module: the builds take seconds)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    key = (tier, value_dtype, pad_to, tuple(sorted(knobs.items())))
    if key not in _TIER_BANKS:
        bank = GeoBank.synthetic_informative(3, 9000, pad_to=pad_to, device=cuda)
        kw = dict(bn=128, gsz_sem=16, gsz_geo=16, lr_rank=256, lr_geo=384, res_rank=128,
                  topk_gsz=8)
        _TIER_BANKS[key] = rh.build_hier_bank(bank, tier=tier, value_dtype=value_dtype,
                                              **{**kw, **knobs})
    return _TIER_BANKS[key]


def _hold_tier(name, got, ref, mag, exact_sum: bool, rows_off_max: int = 7):
    """An f32 product (exact_sum: every rounding point is f32) within 1e-4 of
    the sum of its terms' magnitudes, + 1e-6: f32 logits in another
    summation order move p by ~1e-5 of itself at |l| <= 86.  A product
    after a bf16 rounding point within `_within_terms` (a flip of one term
    in at most rows_off_max rows)."""
    assert got.shape == ref.shape and torch.isfinite(got).all(), name
    if exact_sum:
        err = (got - ref).abs()
        ratio = (err / (1e-4 * mag + 1e-6)).max().item()
        assert ratio <= 1.0, (name, ratio)
    else:
        _within_terms(got, ref, mag, rows_off_max=rows_off_max)


def _tier_queries(hb, cuda, B=700, bm=128, seed=5):
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.nn.functional.normalize(torch.randn(B, 256, generator=g, device=cuda), dim=1)
    x = lonlat_deg_to_xyz(_coords(B, seed=seed, device=cuda))
    q_s, q_x = rh._pad_queries(q, x, bm)
    return rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[rh._hybrid_order(q_x, B)].contiguous()


@pytest.mark.parametrize("tier,value_dtype", TIERS, ids=TIER_IDS)
def test_cores_forms_match_plain(cuda, tier, value_dtype):
    """Every wrapper of kernels 8, 9 and 12-15 on a bank of the exact tier
    (f32 operands) launches the CUDA-core body, once (`.f32_launches`), and
    so do those of 8, 9, 12 and 13 on a bank of the high tier (768 logit
    columns, `.deep_launches`), while kernels 14 and 15 there launch their
    Hopper bodies' deep chains (`.launches`, no f32 launch); each holds
    its plain version: the scan (both families, the sem one alone), the
    stats scan, kernel 14's four shapes on both families, kernel 15 lr and
    plain, the refine (stats, parts) and the correction."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = _tier_bank(cuda, tier, value_dtype)
    form = "f32" if tier == "exact" else "deep"
    f32v = value_dtype == torch.float32
    assert hb.values.dtype == value_dtype and (hb.sem_d == 768) == (tier == "high")
    q_cat = _tier_queries(hb, cuda)
    bm, Dv, sem_d = 128, 1024, hb.sem_d

    def run(fn, *args, **kw):
        hopper = form == "deep" and fn in (rh._hier_parts_family_call, rh._hier_parts_call)
        n0 = (fn.launches, fn.f32_launches if hopper else getattr(fn, f"{form}_launches"))
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        if hopper:  # the Hopper body's count, and none of the CUDA-core body's
            assert (fn.launches, fn.f32_launches) == (n0[0] + 1, n0[1]), fn.__name__
        else:
            assert getattr(fn, f"{form}_launches") == n0[1] + 1, fn.__name__
        return out

    scan_args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw_lr)
    mag_args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(), hb.g_geo_vw_lr.abs())
    exact_vw = tier == "exact"  # f32 group operands
    for has_geo in (True, False):
        got = run(rh._hier_scan_call, *scan_args, gpt_s=8, gpt_g=8, has_geo=has_geo)
        ref = rh._hier_scan_plain(*scan_args, gpt_s=8, gpt_g=8, has_geo=has_geo)
        mag = rh._hier_scan_plain(*mag_args, gpt_s=8, gpt_g=8, has_geo=has_geo)[4]
        for i in (0, 2) if has_geo else (0,):
            torch.testing.assert_close(got[i], ref[i], rtol=0, atol=1e-4)
            torch.testing.assert_close(got[i + 1], ref[i + 1], rtol=1e-4, atol=0)
        _hold_tier("scan", got[4], ref[4], mag, exact_vw)
    stats = run(rh._hier_scan_stats_call, q_cat, hb.g_topk_cat, hb.g_geo_cat, gpt_s=16,
                gpt_g=8)
    ref = rh._hier_scan_stats_plain(q_cat, hb.g_topk_cat, hb.g_geo_cat, gpt_s=16, gpt_g=8)
    for i in range(4):
        torch.testing.assert_close(stats[i], ref[i], rtol=1e-4, atol=1e-4)

    m_s, s_s, m_g, s_g = rh._hier_scan_stats_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat,
                                                   gpt_s=8, gpt_g=8)
    idx_s, _ = rh.select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real, k_tiles=24, bm=bm,
                               n_valid=700, mode="range")
    idx_g, _ = rh.select_tiles(m_g, s_g, m_s, s_s, t_real=hb.t_real, k_tiles=12, bm=bm,
                               n_valid=700, mode="range")
    fam = rh._hier_parts_family_call
    for shape in SHAPES:
        for geo in (False, True):
            g, vw, z, lr, lrr = _family_operands(hb, shape, geo, False)
            args = (q_cat, hb.k_cat, hb.mask_neg, idx_g if geo else idx_s, g, vw, z)
            kw = dict(sem_d=sem_d, bm=bm, bn=128, gpt=8, geo=geo, lrr=lrr, lr=lr,
                      values=hb.values, scale=None)
            got = run(fam, *args, **kw, geo_cols=rf.geo_real_cols(tier))
            ref = rh._hier_parts_family_plain(*args, **kw)
            mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
            # the value shapes' acc follows the values' rounding point
            exact_sum = exact_vw and (z is not None or f32v)
            _hold_tier(f"family {shape} geo={geo}", got, ref, mag, exact_sum)
    for lr, vw_s in ((True, hb.g_sem_vw_lr), (False, hb.g_sem_vw)):
        args = (q_cat, hb.k_cat, hb.values, None, hb.mask_neg, idx_s, hb.g_sem_cat,
                hb.g_geo_cat, vw_s, hb.g_geo_vw)
        kw = dict(sem_d=sem_d, bm=bm, bn=128, gpt_s=8, gpt_g=8, lr=lr)
        got = run(rh._hier_parts_call, *args, **kw)
        ref = rh._hier_parts_plain(*args, **kw)
        mag = rh._hier_parts_plain(*args, **kw, magnitude=True)
        _hold_tier(f"merged lr={lr}", got, ref, mag, exact_vw and f32v)
    # the refine over the sem groups as both levels (a supergroup operand of
    # the same shape, its value sums halved) and the correction
    for stats_only in (True, False):
        rargs = (q_cat, idx_s, hb.g_sem_cat, hb.g_sem_cat, hb.g_sem_vw, 0.5 * hb.g_sem_vw)
        got = run(rh._hier_refine_call, *rargs, bm=bm, gpt_f=8, gpt_sup=8,
                  stats_only=stats_only)
        kw = dict(bm=bm, gpt_f=8) if stats_only else dict(
            bm=bm, gpt_f=8, g_sup_cat=hb.g_sem_cat, g_sem_vw=hb.g_sem_vw,
            g_sup_vw=0.5 * hb.g_sem_vw, gpt_sup=8)
        ref = rh._hier_refine_plain(q_cat, idx_s, hb.g_sem_cat, **kw)
        torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
        torch.testing.assert_close(got[1], ref[1], rtol=1e-4, atol=0)
        if not stats_only:
            mag = rh._hier_refine_plain(q_cat, idx_s, hb.g_sem_cat, **kw, magnitude=True)[2]
            _hold_tier("refine parts", got[2], ref[2], mag, exact_vw)
    cargs = (q_cat, idx_s, hb.g_sem_cat, hb.g_sem_vw_lr)
    got = run(rh._hier_corr_call, *cargs, bm=bm, gpt=8)
    ref = rh._hier_corr_plain(*cargs, bm=bm, gpt=8)
    mag = rh._hier_corr_plain(*cargs, bm=bm, gpt=8, magnitude=True)
    _hold_tier("corr", got, ref, mag, exact_vw)


@pytest.mark.parametrize("tier", ["exact", "high"])
def test_tiers_serve_through_load_model(cuda, tier):
    """`load_model(retrieval="hier", tier=...)` on the card: the flagship
    RANGE+ (one scan, two parts and one combine launch, the first three on
    the CUDA-core body at exact; at high the parts launches on their Hopper
    bodies), RANGE (the stats scan of its home-tile sort, the scan and the
    merged parts kernel) and hier_topk (the stats scan on the CUDA-core
    body, the argmax on its Hopper body), each within the small bank's
    order of the exact f32 answer."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = _tier_bank(cuda, tier, None)
    form = "f32" if tier == "exact" else "deep"
    coords = _coords(3000, seed=6, device=cuda)
    wrappers = (rh._hier_scan_call, rh._hier_parts_family_call, rh._hier_parts_call,
                rh._hier_scan_stats_call)
    # the parts kernels at high: their Hopper bodies' deep chains
    hopper = (rh._hier_parts_family_call, rh._hier_parts_call) if form == "deep" else ()
    counts = lambda: [w.launches if w in hopper else getattr(w, f"{form}_launches")  # noqa: E731
                      for w in wrappers]
    for name, want in (("RANGE+", [1, 2, 0, 0]), ("RANGE", [1, 0, 1, 1])):
        enc = load_model(name, db_path=hb, profile="flagship", hier_bn=128, gsz_geo=16,
                         tier=tier)
        n0 = counts()
        c0 = (rh._combine_cat_call.launches, rh._combine_cat_call.exact_launches)
        out = enc(coords)
        torch.cuda.synchronize()
        assert [a - b for a, b in zip(counts(), n0)] == want, name
        # the combine: the f32 body at exact, the Hopper body at high
        assert (rh._combine_cat_call.launches - c0[0],
                rh._combine_cat_call.exact_launches - c0[1]) == (
            int(name == "RANGE+"), int(name == "RANGE+" and tier == "exact"))
        assert out.shape == (3000, 1280) and torch.isfinite(out).all()
        ref = (retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), hb.bank)
               if name == "RANGE+" else
               retrieval.retrieve(out[:, 1024:], None, hb.bank, sem_temp=15.0, mode="range"))
        rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
        assert rel.mean() < 0.1, (name, rel.mean().item())
    q = out[:, 1024:].float()
    n0, a0 = counts(), rh._hier_argmax_call.launches
    rows = rh.hier_topk(q, lonlat_deg_to_xyz(coords), hb, k_tiles=16)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), n0)] == [0, 0, 0, 1]
    assert rh._hier_argmax_call.launches == a0 + 1
    true = retrieval.exact_nn(q, hb.bank)
    full = dataclasses.replace(hb, topk_lr=0, g_topk_lr=None, p_topk=None)
    rec_full = (rh.hier_topk(q, lonlat_deg_to_xyz(coords), full, k_tiles=16) == true)
    assert (rows == true).float().mean() >= rec_full.float().mean() - 0.02


def test_exact_tier_all_tiles_is_the_exact_answer(cuda):
    """JAX's exactness check (`tests/test_hier.py:73-80`) on the card, at its
    bank's shape (6,000 rows padded to 512, bn 128, gsz_sem 8, gsz_geo 16,
    tier exact, f32 values): with every tile selected the hierarchical
    answer is the exact dense one, max relerr (floor 0.1) under 1e-4."""
    from range_tpu_torch.ops import retrieval_hier as rh

    bank = GeoBank.synthetic_informative(0, 6000, pad_to=512, device=cuda)
    hb = rh.build_hier_bank(bank, bn=128, gsz_sem=8, gsz_geo=16, tier="exact",
                            value_dtype=torch.float32)
    rng = np.random.default_rng(3)
    rows = np.repeat(rng.integers(0, 6000, 8), 64)
    keys = bank.keys_sem[torch.from_numpy(rows).to(cuda)].float()
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.nn.functional.normalize(keys + 0.3 * torch.randn(keys.shape, generator=g,
                                                               device=cuda), dim=1)
    ll = bank.locs_lonlat[torch.from_numpy(rows).to(cuda)].float()
    ll = ll + torch.randn(ll.shape, generator=g, device=cuda) * 3.0
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = ll[:, 1].clamp(-89.9, 89.9)
    x = lonlat_deg_to_xyz(ll)
    ref = retrieval.retrieve(q, x, bank, chunk=512)
    n0 = rh._hier_parts_call.f32_launches
    out = rh.retrieve_hier(q, x, hb, k_tiles=hb.t_real, bm=128)
    torch.cuda.synchronize()
    assert rh._hier_parts_call.f32_launches == n0 + 1
    rel = (out - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.max().item() < 1e-4, rel.max().item()


@pytest.mark.parametrize("tier", ["exact", "high"])
def test_tier_knobs_serve(cuda, tier):
    """The knobs the fast tier serves, at each tier on the card: sel_lr 64
    (kernel 14's sel form, from the sketch's columns), sel_lr with dedup=2
    (B = 8,192: two blocks' lists merged, the dedup_pad form) and with the
    rescue, each request's parts kernels on the CUDA-core body (exact) or
    their Hopper bodies (high) within the small bank's order of the exact
    f32 answer; hier_topk over topk_lr 64
    (the stats scan over the sketch: a 64-column bf16 or f32 operand) on
    a regional batch (8 places, 3 degree jitter: the coherent batches the
    endpoint serves), its recall@1 within 0.02 of the full topk_gsz
    operand's (`tests/test_hier.py:1050`'s bar)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = _tier_bank(cuda, tier, None, topk_lr=64, sel_lr=64)
    form = "f32" if tier == "exact" else "deep"
    coords = _coords(8192, seed=9, device=cuda)
    fam = rh._hier_parts_family_call
    for kw in (dict(), dict(dedup=2), dict(adaptive_frac=0.05, adaptive_mult=3)):
        enc = load_model("RANGE+", db_path=hb, profile="flagship", hier_bn=128, gsz_geo=16,
                         tier=tier, topk_lr=64, sel_lr=64, **kw)
        counter = "f32_launches" if form == "f32" else "launches"
        n0 = getattr(fam, counter)
        out = enc(coords)
        torch.cuda.synchronize()
        assert getattr(fam, counter) - n0 == (4 if kw.get("adaptive_frac") else 2)
        ref = retrieval.retrieve(out[:, 1024:], lonlat_deg_to_xyz(coords), hb.bank)
        rel = (out[:, :1024] - ref).abs() / ref.abs().clamp_min(0.1)
        assert torch.isfinite(out).all() and rel.mean() < 0.1, (kw, rel.mean().item())
    g = torch.Generator(device=cuda).manual_seed(9)
    centers = hb.bank.locs_lonlat[torch.randint(0, 9000, (8,), generator=g, device=cuda)]
    ll = centers.float().repeat_interleave(1024, 0) + 3.0 * torch.randn(
        8192, 2, generator=g, device=cuda)
    coords = torch.stack([(ll[:, 0] + 180) % 360 - 180, ll[:, 1].clamp(-89.9, 89.9)], 1)
    q = enc.model.query_embedding(coords).float()
    st = rh._hier_scan_stats_call
    n0 = (st.launches, st.f32_launches, st.deep_launches)
    rows = rh.hier_topk(q, lonlat_deg_to_xyz(coords), hb, k_tiles=16)
    torch.cuda.synchronize()
    # the sketch's 64 bf16 columns at high are a shape of the stats kernel's own
    assert (st.launches, st.f32_launches, st.deep_launches) == (
        n0[0] + 1, n0[1] + int(tier == "exact"), n0[2])
    true = retrieval.exact_nn(q, hb.bank)
    full = dataclasses.replace(hb, topk_lr=0, g_topk_lr=None, p_topk=None)
    rec_full = (rh.hier_topk(q, lonlat_deg_to_xyz(coords), full, k_tiles=16) == true)
    assert (rows == true).float().mean() >= rec_full.float().mean() - 0.02


@pytest.mark.parametrize("bn,gsz_sem,gsz_geo", [(96, 12, 12), (120, 8, 15)])
def test_cores_walks_every_grouping(cuda, bn, gsz_sem, gsz_geo):
    """Groupings whose groups or entries are no whole unit of 8 columns take
    the CUDA-core body's walk of one thread a query: 12-row groups (kernel
    14's segment sums) and 15 groups a tile (the stats, the weights); the
    scan, kernel 14's rr + lr shape on both families and kernel 15 lr at
    the exact tier (f32 values) hold their plain versions as in
    test_cores_forms_match_plain."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    hb = _tier_bank(cuda, "exact", torch.float32, pad_to=bn, bn=bn, gsz_sem=gsz_sem,
                    gsz_geo=gsz_geo, topk_gsz=0)
    q_cat = _tier_queries(hb, cuda)
    gpt_s, gpt_g = bn // gsz_sem, bn // gsz_geo
    sa = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw_lr)
    n0 = rh._hier_scan_call.f32_launches
    got = rh._hier_scan_call(*sa, gpt_s=gpt_s, gpt_g=gpt_g)
    ref = rh._hier_scan_plain(*sa, gpt_s=gpt_s, gpt_g=gpt_g)
    mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(),
                              hb.g_geo_vw_lr.abs(), gpt_s=gpt_s, gpt_g=gpt_g)[4]
    torch.cuda.synchronize()
    assert rh._hier_scan_call.f32_launches == n0 + 1
    for i in range(4):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-4, atol=1e-4)
    _hold_tier("scan", got[4], ref[4], mag, True)
    m_s, s_s, m_g, s_g = ref[:4]
    sel = dict(t_real=hb.t_real, bm=128, n_valid=700, mode="range")
    idx_s, _ = rh.select_tiles(m_s, s_s, m_g, s_g, k_tiles=24, **sel)
    idx_g, _ = rh.select_tiles(m_g, s_g, m_s, s_s, k_tiles=12, **sel)
    for geo, idx in ((False, idx_s), (True, idx_g)):
        g, vw, z, lr, lrr = _family_operands(hb, "rrlr", geo, False)
        args = (q_cat, hb.k_cat, hb.mask_neg, idx, g, vw, z)
        kw = dict(sem_d=hb.sem_d, bm=128, bn=bn, gpt=gpt_g if geo else gpt_s, geo=geo,
                  lrr=lrr, lr=lr)
        got = rh._hier_parts_family_call(*args, **kw, geo_cols=rf.geo_real_cols("exact"))
        _hold_tier(f"family rrlr geo={geo}", got, rh._hier_parts_family_plain(*args, **kw),
                   rh._hier_parts_family_plain(*args, **kw, magnitude=True), True)
    args = (q_cat, hb.k_cat, hb.values, None, hb.mask_neg, idx_s, hb.g_sem_cat, hb.g_geo_cat,
            hb.g_sem_vw_lr, hb.g_geo_vw)
    kw = dict(sem_d=hb.sem_d, bm=128, bn=bn, gpt_s=gpt_s, gpt_g=gpt_g)
    _hold_tier("merged", rh._hier_parts_call(*args, **kw), rh._hier_parts_plain(*args, **kw),
               rh._hier_parts_plain(*args, **kw, magnitude=True), True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cores_group_pass_segments(cuda, dtype):
    """The CUDA-core group pass split into segments (the scans' walk over
    every tile, a block each, their partial products folded in order) gives
    the one-segment pass's stats exactly and its product within f32 sums
    in another order, for = and for += with a sign (the fold's), at a depth
    of one ragged piece and of several."""
    from range_tpu_torch.ops import retrieval_hier as rh

    g = torch.Generator(device=cuda).manual_seed(11)
    T, gpt, W = 37, 16, 700  # 37 tiles; two column slices, the last ragged
    for depth in (40, 200):
        q = torch.randn(256, depth, generator=g, device=cuda).to(dtype)
        c = torch.randn(T * gpt, depth, generator=g, device=cuda).to(dtype)
        vw = torch.randn(T * gpt, W, generator=g, device=cuda).to(dtype)
        outs = []
        for n_seg in (1, 3, 9):
            st = [torch.empty((256, T), device=cuda) for _ in range(2)]
            out = torch.ones((256, W + 8), device=cuda)
            rh._cores_groups(q, c, wk=depth, gpt=gpt, n_tiles=T, stats=st, vw=vw, nvc=W,
                             out=out, oc0=8, n_seg=n_seg, sign=-1.0, accumulate=True)
            torch.cuda.synchronize()
            outs.append((st, out))
        st1, out1 = outs[0]
        mag = (out1[:, 8:] - 1.0).abs().amax().item()
        for st, got in outs[1:]:
            assert torch.equal(st[0], st1[0]) and torch.equal(st[1], st1[1])
            assert torch.equal(got[:, :8], torch.ones_like(got[:, :8]))
            torch.testing.assert_close(got, out1, rtol=1e-5, atol=1e-5 * mag)


def test_cores_refuse_what_does_not_fit(cuda):
    """A pass whose resident query block and ring do not fit a block's shared
    memory raises before any launch (`_cores_fits`, the launch's own
    check): f32 logits 768 columns deep; bf16 ones 768 deep fit."""
    from range_tpu_torch.ops import retrieval_hier as rh

    for dtype, depth, fits in ((torch.float32, 768, False), (torch.bfloat16, 768, True)):
        q = torch.zeros(64, depth, dtype=dtype, device=cuda)
        st = [torch.empty((64, 4), device=cuda) for _ in range(2)]
        call = lambda: rh._cores_groups(q, q, wk=depth, gpt=16, n_tiles=4, stats=st)
        if fits:
            call()
            torch.cuda.synchronize()
        else:
            with pytest.raises(ValueError, match="shared memory"):
                call()
