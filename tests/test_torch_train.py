"""range_tpu_torch's SatCLIP training path against range_tpu, on the CPU.

Covers the SH-times kernel's wrapper (#4, its plain version here) and its
gradients, the tower's gradients, the dual-tower model and its loss, the
decay mask, the train step (accumulation, clipping, AdamW), `fit` and the
lr schedule.  Inputs come from numpy seeds; JAX parameters are carried
across with `convert.from_jax`; the JAX Pallas kernels run in interpret
mode.  JAX inputs are float32 on purpose (conftest enables x64).

Tolerances, elementwise per tensor against JAX:
  * #4's outputs and gradients, the tower's gradients: 1e-5 x max |JAX|
    (the same f32 sums in another order; measured <= 1.2e-7 relative; in
    bf16 both round the same operands, measured equal);
  * logits, losses, gradients and Adam moments of the model: 1e-4 x
    max |JAX| (measured <= 2e-6 relative);
  * parameters after a step: 1e-6 absolute, except where the reference
    gradient is at float noise (|g| <= 1e-4 x max |g| of its tensor):
    Adam's first update is ~lr * sign(g) there, so a sign that differs
    moves the element by up to 2 lr.

Dropout masks are threefry draws in JAX and cannot be reproduced in torch:
the parity tests switch dropout off on both sides (`dataclasses.replace`
on the JAX `SirenNet`, the attribute on the port's); dropout is held on the
port alone.

The JAX max pool (`range_tpu/models/resnet_std.py:48`) is not
differentiable under `jit` or `scan` (its -inf is an array there); the
`jax_max_pool` fixture swaps in the same pool with a Python-float -inf for
the JAX train steps (tests/test_torch_resnet.py holds the two equal).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.models import resnet_std as jstd
from range_tpu.models.satclip import SatClipLocationConfig as JaxLocationConfig
from range_tpu.ops import sh as jsh
from range_tpu.ops.nets import SirenNet as JaxSirenNet
from range_tpu.train import fit as jfit
from range_tpu.train import satclip as jtr
from range_tpu_torch.convert.from_jax import satclip_params_from_jax
from range_tpu_torch.models.resnet_std import StdResNetConfig
from range_tpu_torch.models.satclip import SatClipLocationConfig
from range_tpu_torch.ops import sh as tsh
from range_tpu_torch.ops.nets import SirenNet
from range_tpu_torch.train import fit as tfit
from range_tpu_torch.train import satclip as ttr
from range_tpu_torch.utils import checkpoint
from range_tpu_torch.utils.metrics import read_metrics

L, D = 6, 32
VISION = dict(layers=(1, 1, 1, 1), block="basic", width=8, in_channels=4, output_dim=16)
LOCATION = dict(embed_dim=16, legendre_polys=L, capacity=D, num_hidden_layers=2)
LR = 1e-3


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    ll = np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)], 1)
    ll[:2, 1] = [90.0, -90.0]
    return ll.astype(np.float32)


def _batch(n, seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((n, 4, 32, 32)).astype(np.float32),
            "point": _coords(n, seed + 100)}


def _close(got, ref, rel):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_max_pool():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstd, "_max_pool_3x3s2", lambda x: jax.lax.reduce_window(
            x, -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 2, 2),
            [(0, 0), (0, 0), (1, 1), (1, 1)]))
        yield


@pytest.fixture(scope="module")
def jax_model():
    """The JAX dual tower with dropout off, and its float32 params."""
    model = jtr.SatClipModel(jtr.SatClipConfig(
        vision=jstd.StdResNetConfig(**VISION), location=JaxLocationConfig(**LOCATION)))
    model.location.nnet = dataclasses.replace(model.location.nnet, dropout=False)
    params = jax.jit(model.init, static_argnums=1)(jax.random.PRNGKey(0), jnp.float32)
    return model, params


def _port_model(params, dropout=False):
    model = ttr.SatClipModel(ttr.SatClipConfig(
        vision=StdResNetConfig(**VISION), location=SatClipLocationConfig(**LOCATION)),
        device="cpu")
    model.load_state_dict(satclip_params_from_jax(params))
    model.location.nnet.dropout = dropout
    return model


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------- kernel #4

@pytest.mark.parametrize("bf16", [False, True])
def test_sh_times_fused_matches_jax(bf16):
    """Forward and both gradients against `spherical_harmonics_times_pallas`
    (interpret mode) with the same upstream gradient; the CPU runs the
    plain version and launches nothing."""
    ll = _coords(200, seed=0)
    rng = np.random.default_rng(1)
    w = (rng.standard_normal((L * L, D)) * 0.2).astype(np.float32)
    g = rng.standard_normal((200, D)).astype(np.float32)
    fn = lambda a, b: jsh.spherical_harmonics_times_pallas(  # noqa: E731
        a, L, b, matmul_dtype=jnp.bfloat16 if bf16 else None, interpret=True)
    ref, (ref_gll, ref_gw) = jax.jit(lambda a, b, c: (
        fn(a, b), jax.vjp(fn, a, b)[1](c)))(jnp.asarray(ll), jnp.asarray(w), jnp.asarray(g))
    tll = torch.from_numpy(ll).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    before = tsh.spherical_harmonics_times_fused.launches
    out = tsh.spherical_harmonics_times_fused(
        tll, L, tw, matmul_dtype=torch.bfloat16 if bf16 else None)
    out.backward(torch.from_numpy(g))
    assert out.dtype == torch.float32 and out.shape == (200, D)
    assert tsh.spherical_harmonics_times_fused.launches == before
    _close(out.detach().numpy(), ref, 1e-5)
    _close(tll.grad.numpy(), ref_gll, 1e-5)
    _close(tw.grad.numpy(), ref_gw, 1e-5)


def test_sh_times_plain_rounds_the_synthesis():
    """In bf16 the kernel rounds ftab and fth too (`range_tpu/ops/sh.py:537,
    547`), so its plain version is not `spherical_harmonics_times`; in f32
    the two agree.  Outside 2 <= L <= 64 the wrapper takes the compose, as
    the JAX envelope does."""
    ll = torch.from_numpy(_coords(100, seed=2))
    w = torch.from_numpy(np.random.default_rng(3).standard_normal((L * L, D))
                         .astype(np.float32))
    bf = torch.bfloat16
    plain = tsh._sh_times_plain(ll, L, w, matmul_dtype=bf)
    compose = tsh.spherical_harmonics_times(ll, L, w, matmul_dtype=bf)
    assert (plain - compose).abs().max() > 1e-4 * compose.abs().max()
    torch.testing.assert_close(tsh._sh_times_plain(ll, L, w),
                               tsh.spherical_harmonics_times(ll, L, w),
                               rtol=0, atol=1e-5 * compose.abs().max().item())
    w65 = torch.from_numpy(np.random.default_rng(4).standard_normal((65 * 65, D))
                           .astype(np.float32))
    torch.testing.assert_close(tsh.spherical_harmonics_times_fused(ll, 65, w65),
                               tsh.spherical_harmonics_times(ll, 65, w65), rtol=0, atol=0)
    with pytest.raises(ValueError, match="matmul_dtype"):
        tsh.spherical_harmonics_times_fused(ll, L, w, matmul_dtype=torch.float16)


def test_siren_tower_grads_match_jax():
    """`siren_tower`'s gradients for the coordinates and every layer's w and
    b against `jax.grad` of `siren_tower_pallas` (interpret mode), whose
    backward is the XLA compose."""
    H = 128  # the JAX kernel's width (multiples of 128)
    net = JaxSirenNet(dim_in=L * L, dim_hidden=H, dim_out=H, num_layers=2)
    p = net.init(jax.random.PRNGKey(4), dtype=jnp.float32)
    ll = _coords(64, seed=5)
    g = np.random.default_rng(6).standard_normal((64, H)).astype(np.float32)
    ref_gll, ref_gp = jax.jit(jax.grad(lambda a, q: jnp.sum(
        jsh.siren_tower_pallas(a, L, q, interpret=True) * g), argnums=(0, 1)))(
        jnp.asarray(ll), p)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), p)
    tll = torch.from_numpy(ll).requires_grad_(True)
    (tsh.siren_tower(tll, L, tp) * torch.from_numpy(g)).sum().backward()
    _close(tll.grad.numpy(), ref_gll, 1e-5)
    for layer, ref in zip(tp["layers"] + [tp["last"]], ref_gp["layers"] + [ref_gp["last"]]):
        for k in ("w", "b"):
            _close(layer[k].grad.numpy(), ref[k], 1e-5)


# ---------------------------------------------------------------- the model

def test_satclip_forward_and_loss_match_jax(jax_model):
    """Eval (the tower) and training with dropout off (#4 + the SIREN
    layers): logits and clip loss."""
    jm, params = jax_model
    model = _port_model(params)
    batch = _batch(8, seed=7)
    forward = jax.jit(jm.forward, static_argnames="training")
    for training in (False, True):
        ref = forward(params, jnp.asarray(batch["image"]), jnp.asarray(batch["point"]),
                      training=training, rng=jax.random.PRNGKey(0))
        with torch.no_grad():
            got = model(*_tensors(batch).values(), training=training,
                        generator=torch.Generator())
        _close(got[0].numpy(), ref[0], 1e-4)
        _close(got[1].numpy(), ref[1], 1e-4)
        np.testing.assert_allclose(float(ttr.clip_loss(*got)), float(jtr.clip_loss(*ref)),
                                   rtol=1e-5)


def test_decay_mask_leaf_for_leaf(jax_model):
    jm, params = jax_model
    ref = {k: bool(v) for k, v in satclip_params_from_jax(jtr._decay_mask(params)).items()}
    got = ttr._decay_mask(_port_model(params))
    assert got == ref
    assert got["logit_scale"] is False and got["visual.bn1.mean"] is False
    assert got["visual.conv1.w"] and got["location.nnet.layers.0.weight"]
    assert not got["location.nnet.layers.0.bias"]


def test_model_rejects_unported_parts(jax_model):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.SatClipModel(ttr.SatClipConfig(vision=object()), device="cpu")
    enc = _port_model(jax_model[1]).location
    enc.nnet = torch.nn.Identity()  # a head other than SirenNet (the MLP)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        enc(torch.zeros(2, 2), training=True, generator=torch.Generator())


# ---------------------------------------------------------------- the step

def _adam_moments(state):
    adam = [s for s in jax.tree_util.tree_leaves(
        state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(adam) == 1
    return satclip_params_from_jax(adam[0].mu), satclip_params_from_jax(adam[0].nu)


@pytest.fixture(scope="module")
def jax_steps(jax_model, jax_max_pool):
    """JAX's jitted train steps: accum 1 without the clip (its first Adam
    moment is then 0.1 x the raw gradients), accum 2 with the default
    global-norm clip of 1."""
    jm, _ = jax_model
    opts = {1: (LR, None), 2: (LR, 1.0)}
    return {a: (opts[a], jax.jit(jtr.make_train_step(
        jm, jtr.make_optimizer(opts[a][0], grad_clip=opts[a][1]), accum_steps=a)))
        for a in (1, 2)}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_jax(jax_model, jax_steps, accum):
    """One step over 16 samples in `accum` microbatches: loss, both Adam
    moments (accum 1: 0.1 x and 0.001 x the squares of the raw gradients;
    accum 2: of the accumulated, clipped gradients), and the updated
    parameters."""
    jm, params = jax_model
    (lr, clip), jstep = jax_steps[accum]
    batch = _batch(16, seed=8)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    opt = jtr.make_optimizer(lr, grad_clip=clip)
    p1, s1, loss = jstep(params, opt.init(params), jb, jax.random.PRNGKey(1))
    model = _port_model(params)
    names = {p: n for n, p in model.named_parameters()}
    step = ttr.make_train_step(model, ttr.make_optimizer(lr, grad_clip=clip),
                               accum_steps=accum)
    got_loss = step(_tensors(batch), torch.Generator())
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    mu, nu = _adam_moments(s1)
    for p, name in names.items():
        state = step.optimizer.state[p]
        _close(state["exp_avg"].numpy(), mu[name].numpy(), 1e-4)
        _close(state["exp_avg_sq"].numpy(), nu[name].numpy(), 2e-4)  # g^2: twice g's error
    ref_p = satclip_params_from_jax(p1)
    for p, name in names.items():
        g = mu[name].numpy()
        noise = np.abs(g) <= 1e-4 * np.abs(g).max()
        err = np.abs(p.detach().numpy() - ref_p[name].numpy())
        assert (err <= 1e-6 + 2 * lr * noise).all(), name


def test_accumulation_is_the_mean_of_microbatch_gradients(jax_model):
    """Within the port, as `tests/test_train.py:67`: accum 2 over 2B and
    one step over each half.  Without clipping, accum 2's first moment is
    0.1 x the mean of the two halves' gradients; and both steps lower the
    full batch's loss."""
    params = jax_model[1]
    batch = _tensors(_batch(16, seed=9))

    def full_loss(model):
        with torch.no_grad():
            return float(ttr.clip_loss(*model(batch["image"], batch["point"])))

    halves = []
    for sl in (slice(0, 8), slice(8, 16)):
        model = _port_model(params)
        ttr.clip_loss(*model(batch["image"][sl], batch["point"][sl], training=True)).backward()
        halves.append({n: p.grad for n, p in model.named_parameters()})
    model = _port_model(params)
    start = full_loss(model)
    step = ttr.make_train_step(model, ttr.make_optimizer(LR, grad_clip=None), accum_steps=2)
    step(batch)
    for n, p in model.named_parameters():
        want = 0.1 * (halves[0][n] + halves[1][n]) / 2
        torch.testing.assert_close(step.optimizer.state[p]["exp_avg"], want, rtol=0,
                                   atol=1e-6 * want.abs().max().item())
    assert full_loss(model) < start
    one = _port_model(params)
    ttr.make_train_step(one, ttr.make_optimizer(LR), accum_steps=1)(batch)
    assert full_loss(one) < start


def test_three_steps_match_jax(jax_model, jax_steps):
    """The slice: three accum-2 steps over the same batch; every step's loss
    against JAX's, and the loss falls."""
    jm, params = jax_model
    _, jstep = jax_steps[2]
    batch = _batch(16, seed=10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    state, ref = jtr.make_optimizer(LR).init(params), []
    p = params
    for i in range(3):
        p, state, loss = jstep(p, state, jb, jax.random.PRNGKey(i))
        ref.append(float(loss))
    model = _port_model(params)
    step = ttr.make_train_step(model, ttr.make_optimizer(LR), accum_steps=2)
    got = [float(step(_tensors(batch), torch.Generator())) for _ in range(3)]
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    assert got[2] < got[0]


def test_global_norm_clip_is_optax():
    """`g * max / norm` above the bound, unchanged below, as
    `optax.clip_by_global_norm` computes it."""
    rng = np.random.default_rng(11)
    tree = {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    for bound in (0.5, 100.0):
        ref, _ = optax.clip_by_global_norm(bound).update(
            jax.tree.map(jnp.asarray, tree), optax.EmptyState())
        got = [torch.from_numpy(tree[k].copy()) for k in ("a", "b")]
        ttr.clip_by_global_norm(got, bound)
        for g, k in zip(got, ("a", "b")):
            _close(g.numpy(), ref[k], 1e-6)


# ---------------------------------------------------------------- dropout

def test_dropout_keeps_half_scales_by_two_and_is_seeded():
    """Pre-activation dropout on the port alone: with w0_initial = 1, one
    layer and an identity head, each output is sin(2 h) where kept and 0
    where dropped."""
    n = 64
    net = SirenNet(n, n, n, 1, w0_initial=1.0, device="cpu")
    with torch.no_grad():
        net.last.weight.copy_(torch.eye(n))
        net.last.bias.zero_()
    h = torch.full((256, n), 0.1)

    def run(seed):
        return net(None, training=True, generator=torch.Generator().manual_seed(seed),
                   first_preact=h).detach()

    out = run(0)
    kept = out != 0
    assert 0.48 < kept.float().mean().item() < 0.52
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], np.sin(0.2)))
    assert torch.equal(run(0), out) and not torch.equal(run(1), out)
    with pytest.raises(ValueError, match="generator"):
        net(None, training=True, first_preact=h)
    torch.testing.assert_close(net(None, first_preact=h), torch.sin(h))


# ---------------------------------------------------------------- fit

def test_fit_writes_checkpoints_and_metrics(tmp_path, jax_model):
    """As tests/test_fit.py:15 and :85: two epochs with validation write
    last.pt, best.pt and the metrics file; the checkpoint loads back."""
    _, params = jax_model
    model = _port_model(params, dropout=True)
    step = ttr.make_train_step(model, ttr.make_optimizer(LR))
    rng = np.random.default_rng(12)

    def batches(epoch):
        for _ in range(4):
            yield _batch(8, seed=int(rng.integers(1 << 30)))

    val = [_batch(8, seed=13)]

    def eval_loss(m, batch):
        return ttr.clip_loss(*m(batch["image"], batch["point"]))

    ckpt_dir, mf = str(tmp_path / "ckpt"), str(tmp_path / "metrics.jsonl")
    hist = tfit.fit(step, model, batches, val_batches=lambda: iter(val),
                    eval_loss_fn=eval_loss,
                    config=tfit.FitConfig(epochs=2, log_every=2, ckpt_dir=ckpt_dir,
                                          metrics_file=mf))
    assert len(hist["train_loss"]) == 2 and len(hist["val_loss"]) == 2
    assert np.isfinite(hist["train_loss"]).all()
    assert hist["val_loss"][-1] <= hist["val_loss"][0] + 0.5
    for name in ("last.pt", "best.pt"):
        assert os.path.exists(os.path.join(ckpt_dir, name))
    recs = read_metrics(mf)
    assert sum("train_loss" in r for r in recs) == 4  # steps 2, 4, 6, 8
    assert [r["val_loss"] for r in recs if "val_loss" in r] == pytest.approx(hist["val_loss"])
    assert all("step" in r and "ts" in r for r in recs)
    fresh = checkpoint.load(os.path.join(ckpt_dir, "last.pt"), _port_model(params))
    for (n, a), b in zip(model.state_dict().items(), fresh.state_dict().values()):
        assert torch.equal(a, b), n


def test_epoch_decay_schedule_matches_optax(jax_model):
    """Staircase lr * decay**epoch against the JAX package's optax
    schedule, and the train step reads it before each update, at the
    number of updates made so far (update 5 is epoch 1's first)."""
    ref = jfit.epoch_decay_schedule(0.01, 0.98, steps_per_epoch=5)
    got = tfit.epoch_decay_schedule(0.01, 0.98, steps_per_epoch=5)
    for s in range(23):
        assert got(s) == pytest.approx(float(ref(s)), rel=1e-6)
    step = ttr.make_train_step(_port_model(jax_model[1]), ttr.make_optimizer(got))
    batch = _tensors(_batch(4, seed=14))
    lrs = []
    for _ in range(6):
        step(batch)
        lrs.append(step.optimizer.param_groups[0]["lr"])
    assert lrs == pytest.approx([got(s) for s in range(6)])
    assert lrs[5] == pytest.approx(0.01 * 0.98) and lrs[4] == pytest.approx(0.01)


def test_cast_floating():
    tree = {"w": torch.ones(2, 2), "i": torch.ones(2, dtype=torch.int8),
            "nested": [torch.zeros(3, dtype=torch.float64)]}
    out = ttr.cast_floating(tree)
    assert out["w"].dtype == torch.bfloat16 and out["i"].dtype == torch.int8
    assert out["nested"][0].dtype == torch.bfloat16
