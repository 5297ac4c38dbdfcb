"""range_tpu_torch's standard ResNet (the moco vision tower) against range_tpu.

Inputs and JAX-initialised parameters are carried across as numpy
(`convert.from_jax.std_resnet_params_from_jax`); both sides run float32 on
the CPU.  Tolerances: |port - JAX| <= 1e-5 x max |JAX| elementwise, per
tensor, for outputs and gradients (the same f32 convolutions summed in
another order: measured <= 1.5e-6 relative here).

The JAX max pool (`range_tpu/models/resnet_std.py:48`) hands
`lax.reduce_window` its -inf as an array; under `jit` or `scan` that is a
traced value, JAX no longer sees the max monoid, and reverse-mode autodiff
fails.  `jax_max_pool` (a fixture) swaps in, for one test, the same pool
with -inf as a Python float, which JAX differentiates; the JAX package's
file is not touched, and `test_helpers_match_jax` holds the swapped pool
equal to the package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.models import resnet as jres
from range_tpu.models import resnet_std as jstd
from range_tpu_torch.convert.from_jax import std_resnet_params_from_jax
from range_tpu_torch.models import resnet as tres
from range_tpu_torch.models import resnet_std as tstd

SMALL = dict(layers=(1, 1, 1, 1), width=8, in_channels=4, output_dim=16)
RTOL = 1e-5


def _max_pool_differentiable(x):
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 2, 2),
                                 [(0, 0), (0, 0), (1, 1), (1, 1)])


@pytest.fixture
def jax_max_pool(monkeypatch):
    monkeypatch.setattr(jstd, "_max_pool_3x3s2", _max_pool_differentiable)


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * np.abs(ref).max())


def _jax_model(block, seed=0):
    cfg = jstd.StdResNetConfig(block=block, **SMALL)
    params = jax.jit(jstd.init_std_resnet, static_argnums=(1, 2))(
        jax.random.PRNGKey(seed), cfg, jnp.float32)
    # non-trivial batch-norm statistics, so that their gradients are held too
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: (jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
                         if path[-1].key in ("var", "g") and x.ndim == 1 else
                         jnp.asarray(rng.normal(0, 0.1, x.shape), jnp.float32)
                         if path[-1].key in ("mean", "b") and x.ndim == 1 else x),
        params)
    return cfg, params


def _port_model(block, params):
    model = tstd.StdResNet(tstd.StdResNetConfig(block=block, **SMALL), device="cpu")
    model.load_state_dict(std_resnet_params_from_jax(params))
    return model


def _images(n=4, seed=1):
    return np.random.default_rng(seed).standard_normal((n, 4, 32, 32)).astype(np.float32)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_std_resnet_forward_matches_jax(block):
    cfg, params = _jax_model(block)
    x = _images()
    ref = np.asarray(jax.jit(jstd.apply_std_resnet, static_argnums=2)(
        params, jnp.asarray(x), cfg))
    with torch.no_grad():
        got = _port_model(block, params)(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 16) and got.dtype == np.float32
    _close(got, ref)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_std_resnet_grads_match_jax(block, jax_max_pool):
    """Every parameter's gradient, batch-norm mean and var included: they
    are ordinary parameters on both sides (the JAX step differentiates its
    whole param tree)."""
    cfg, params = _jax_model(block, seed=2)
    x = _images(seed=3)
    g = np.random.default_rng(4).standard_normal((4, 16)).astype(np.float32)
    jgrads = jax.jit(jax.grad(lambda p: jnp.sum(
        jstd.apply_std_resnet(p, jnp.asarray(x), cfg) * g)))(params)
    model = _port_model(block, params)
    (model(torch.from_numpy(x)) * torch.from_numpy(g)).sum().backward()
    ref = std_resnet_params_from_jax(jgrads)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(ref)
    for name in ref:
        _close(got[name].numpy(), ref[name].numpy())
    assert np.abs(ref["bn1.mean"].numpy()).max() > 0  # the statistics do move


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_init_std_resnet_layout_and_seed(block):
    """The JAX tree's names and shapes; kaiming-normal (fan_out) conv
    weights, identity batch norm, a uniform head; reproducible from the
    generator's seed."""
    cfg = jstd.StdResNetConfig(block=block, **SMALL)
    jparams = jax.eval_shape(lambda: jstd.init_std_resnet(
        jax.random.PRNGKey(0), cfg, dtype=jnp.float32))
    ref = {k: v.shape for k, v in std_resnet_params_from_jax(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jparams)).items()}

    def make(seed):
        return tstd.init_std_resnet(tstd.StdResNetConfig(block=block, **SMALL),
                                    generator=torch.Generator().manual_seed(seed),
                                    device="cpu")

    a, b, c = make(0), make(0), make(1)
    sd = a.state_dict()
    assert {k: v.shape for k, v in sd.items()} == ref
    for k, v in sd.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, b.state_dict()[k])
        if k.endswith(".g") or k.endswith(".var"):
            assert torch.equal(v, torch.ones_like(v))
        elif k.endswith(".b") or k.endswith(".mean"):
            assert torch.equal(v, torch.zeros_like(v))
        else:
            assert not torch.equal(v, c.state_dict()[k])
    w = sd["stages.1.0.conv2.w"]  # 3x3, fan_out 9 * 16
    assert abs(w.std().item() / np.sqrt(2 / (9 * 16)) - 1) < 0.1
    bound = 1 / np.sqrt(sd["fc.weight"].shape[1])
    assert 0.9 * bound < sd["fc.weight"].abs().max() <= bound
    assert all(p.requires_grad for p in a.parameters())


def test_trainable_mask_is_the_head():
    model = tstd.init_std_resnet(tstd.StdResNetConfig(**SMALL), device="cpu")
    mask = tstd.trainable_mask(model)
    assert set(mask) == {n for n, _ in model.named_parameters()}
    assert {n for n, m in mask.items() if m} == {"fc.weight", "fc.bias"}


def test_helpers_match_jax():
    """`_conv` (NCHW / OIHW, stride and padding), `_bn` from (g, b, mean,
    var) with eps 1e-5, and the 3x3/2 max pool padded with -inf: an
    all-negative input, where zero padding would show."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 9, 9)).astype(np.float32)
    w = rng.standard_normal((5, 3, 3, 3)).astype(np.float32)
    p = {"g": rng.uniform(0.5, 2, 3), "b": rng.normal(size=3),
         "mean": rng.normal(size=3), "var": rng.uniform(0.1, 2, 3)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    tx = torch.from_numpy(x)
    _close(tres._conv(tx, torch.from_numpy(w), stride=2, padding=1).numpy(),
           jres._conv(jnp.asarray(x), jnp.asarray(w), stride=2, padding=1))
    _close(tres._bn(tx, {k: torch.from_numpy(v) for k, v in p.items()}).numpy(),
           jres._bn(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}))
    neg = -np.abs(x) - 1.0
    got = tstd._max_pool_3x3s2(torch.from_numpy(neg)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jstd._max_pool_3x3s2(jnp.asarray(neg))))
    np.testing.assert_array_equal(got, np.asarray(_max_pool_differentiable(jnp.asarray(neg))))
    assert got.shape == (2, 3, 5, 5) and (got < 0).all()
