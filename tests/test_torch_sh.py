"""range_tpu_torch's SH plans, basis and SatCLIP tower against range_tpu.

Inputs are made with numpy from a seed and fed to both sides; the JAX tower
kernel runs in Pallas interpret mode on the CPU, as range_tpu's own tests
run it.  JAX inputs are built as float32 on purpose: conftest enables x64,
and f64 coordinates would send the JAX encoder down its non-kernel path.
Tower widths are multiples of 128, or the JAX kernel falls back to its plain
compose (`range_tpu/ops/sh.py:679-681`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.ops import sh as jsh
from range_tpu.ops.nets import SirenNet as JaxSirenNet
from range_tpu.ops.posenc import SphericalHarmonics as JaxSH
from range_tpu_torch.convert.from_jax import siren_params_from_jax
from range_tpu_torch.ops import sh as tsh
from range_tpu_torch.ops.nets import SirenNet
from range_tpu_torch.ops.posenc import SphericalHarmonics


def _coords(n, seed=0):
    rng = np.random.default_rng(seed)
    ll = np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)], 1)
    ll[:4, 1] = [90.0, -90.0, 89.999, -89.999]  # poles and near-poles
    return ll


def _torch_params(tree):
    return {"layers": [{k: torch.from_numpy(np.array(v)) for k, v in l.items()}
                       for l in tree["layers"]],
            "last": {k: torch.from_numpy(np.array(v))
                     for k, v in tree["last"].items()}}


@pytest.mark.parametrize("L", [8, 40])
@pytest.mark.parametrize("convention", ["analytic", "closed-form"])
def test_plans_bit_equal(L, convention):
    for a, b in zip(jsh._sh_plan(L, convention), tsh._sh_plan(L, convention)):
        assert np.array_equal(a, b)
    for ja, ta in zip(jsh._sh_times_plan(L, convention),
                      tsh._sh_times_plan(L, convention)):
        for a, b in zip(ja, ta):
            assert np.array_equal(a, b)
    assert np.array_equal(jsh._sh_fourier_plan(L), tsh._sh_fourier_plan(L))


# f64: both sides run the same recurrence in double (measured 1.6e-15).
# f32: CPU sin/cos differ in the last ulp between XLA and torch, and the
# recurrence carries that into basis values up to ~4.9 (measured 3.9e-5).
@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.float32, 1e-4)])
@pytest.mark.parametrize("convention", ["analytic", "closed-form"])
def test_basis_matches_jax(dtype, atol, convention):
    ll = _coords(300).astype(dtype)
    j = np.asarray(jsh.spherical_harmonics_basis(jnp.asarray(ll), 16, convention))
    t = tsh.spherical_harmonics_basis(torch.from_numpy(ll), 16, convention).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=atol)
    posenc = SphericalHarmonics(legendre_polys=16, convention=convention)
    assert posenc.embedding_dim == JaxSH(legendre_polys=16).embedding_dim == 256
    np.testing.assert_array_equal(posenc(torch.from_numpy(ll)).numpy(), t)


# Both round each folded product to f32 (preferred_element_type=f32); the
# remaining difference is summation order: f64 measured exact, f32 2.4e-7
# on outputs ~1.7, f32 with bf16 operands 1.1e-5 (an f32 value near a bf16
# tie rounds the other way).
@pytest.mark.parametrize("dtype,bf16,atol", [(np.float64, False, 1e-9),
                                             (np.float32, False, 1e-5),
                                             (np.float32, True, 1e-4)])
def test_times_matches_jax(dtype, bf16, atol):
    ll = _coords(300, seed=1).astype(dtype)
    w = (np.random.default_rng(2).standard_normal((256, 64)) * 0.05).astype(dtype)
    j = np.asarray(jsh.spherical_harmonics_times(
        jnp.asarray(ll), 16, jnp.asarray(w),
        matmul_dtype=jnp.bfloat16 if bf16 else None))
    t = tsh.spherical_harmonics_times(
        torch.from_numpy(ll), 16, torch.from_numpy(w),
        matmul_dtype=torch.bfloat16 if bf16 else None).numpy()
    assert t.dtype == j.dtype
    np.testing.assert_allclose(t, j, rtol=0, atol=atol)


# The plain tower against the JAX tower kernel (interpret mode).  f32: the
# same f32 math in another summation order, on outputs ~2.4; the JAX kernel
# itself sits ~1e-5 from an f64 compose, and sin(30 h) amplifies h's
# rounding x30 (measured 1.2e-6 here).  bf16: both round the same matmul
# operands to bf16, but an f32 sum that lands near a bf16 tie rounds the
# other way (2^-8 relative) and sin(30 h) amplifies it (measured 1.7e-3).
@pytest.mark.parametrize("L,H", [(8, 128), (40, 256)])
@pytest.mark.parametrize("bf16,atol", [(False, 1e-4), (True, 5e-3)])
def test_tower_plain_matches_jax_kernel(L, H, bf16, atol):
    net = JaxSirenNet(dim_in=L * L, dim_hidden=H, dim_out=H, num_layers=2)
    p = net.init(jax.random.PRNGKey(L), dtype=jnp.float32)
    ll = _coords(256, seed=L).astype(np.float32)
    j = np.asarray(jsh.siren_tower_pallas(
        jnp.asarray(ll), L, p, matmul_dtype=jnp.bfloat16 if bf16 else None,
        interpret=True))
    t = tsh.siren_tower(torch.from_numpy(ll), L, _torch_params(p),
                        matmul_dtype=torch.bfloat16 if bf16 else None)
    assert t.dtype == torch.float32 and t.shape == (256, H)
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=atol)


def test_siren_net_carries_jax_params():
    """SirenNet with JAX weights carried across: its unfused forward on the
    f64 basis matches JAX `SirenNet.apply` (same f64 math, measured ~1e-15)."""
    L, H = 8, 128
    jnet = JaxSirenNet(dim_in=L * L, dim_hidden=H, dim_out=64, num_layers=3)
    p = jnet.init(jax.random.PRNGKey(3), dtype=jnp.float64)
    net = SirenNet(L * L, H, 64, 3, device="cpu", dtype=torch.float64)
    net.load_state_dict(siren_params_from_jax(p))
    ll = _coords(100, seed=4)
    j = np.asarray(jnet.apply(p, JaxSH(legendre_polys=L)(jnp.asarray(ll))))
    with torch.no_grad():  # the weights are trainable parameters
        t = net(SphericalHarmonics(legendre_polys=L)(torch.from_numpy(ll))).numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-10)


def test_siren_net_init_bounds_and_seed():
    """The JAX init's uniform bounds (`range_tpu/ops/nets.py:76-95`), drawn
    from a torch.Generator: reproducible from the seed, trainable."""
    def make(seed):
        return SirenNet(100, 64, 32, 2, device="cpu",
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = make(0), make(0), make(1)
    bounds = [1 / 100, np.sqrt(6 / 64) / 1.0, np.sqrt(6 / 64) / 1.0]
    for lin, bound in zip(list(a.layers) + [a.last], bounds):
        for t in (lin.weight, lin.bias):
            assert t.abs().max() <= bound and t.abs().max() > 0.9 * bound
            assert t.requires_grad
    for x, y, z in zip(a.state_dict().values(), b.state_dict().values(),
                       c.state_dict().values()):
        assert torch.equal(x, y) and not torch.equal(x, z)


def test_tower_wrapper_rejects_bad_input():
    p = {"layers": [{"w": torch.zeros(64, 128)}], "last": {"w": torch.zeros(128, 128)}}
    with pytest.raises(ValueError, match="matmul_dtype"):
        tsh.siren_tower(torch.zeros(4, 2), 8, p, matmul_dtype=torch.float16)
    with pytest.raises(ValueError, match="convention"):
        tsh.siren_tower(torch.zeros(4, 2), 8, p, convention="spherical")
