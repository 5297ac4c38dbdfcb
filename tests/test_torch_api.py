"""The dense RANGE / RANGE+ / SatCLIP slice of range_tpu_torch as a whole,
against range_tpu's `load_model` on the CPU.

The SatCLIP tower runs at full width (SH L=40 -> SIREN 1600->256->256->256)
with the JAX weights carried across by `convert.from_jax`; the bank is small
(3,000 rows, 256-d keys, 1024-d values) and B=64.  On the CPU both packages
route retrieval through their exact streaming `retrieve`
(`range_tpu/models/range_encoder.py:224-226`), and the JAX tower runs its
Pallas kernel in interpret mode.  Coordinates are float32 on both sides:
conftest enables x64, and f64 coordinates would take JAX's non-kernel path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

import range_tpu
from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu_torch import GeoBank, list_models, load_model
from range_tpu_torch.convert.from_jax import geobank_from_arrays, siren_params_from_jax
from range_tpu_torch.models import satclip
from range_tpu_torch.ops.sh import siren_tower

# Output agreement: the tower differs from JAX's by f32 summation order
# (~1e-6 on outputs ~2.4, x30 through the first sine, then normalized);
# retrieval is f32 on both sides.
ATOL = 2e-5


@pytest.fixture(scope="module")
def jax_bank():
    return JaxGeoBank.synthetic(0, 3000, key_dim=256, value_dim=1024, pad_to=1024)


def _coords(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-180, 180, n),
                     rng.uniform(-90, 90, n)], 1).astype(np.float32)


def _port_like(jenc, name, **kw):
    enc = load_model(name, device="cpu", **kw)
    tower = enc.model if name == "SatCLIP" else enc.model.query_encoder
    tower.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    return enc


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
def test_load_model_matches_jax(jax_bank, name):
    jenc = range_tpu.load_model(name, db_path=jax_bank, beta=0.4)
    bank = geobank_from_arrays(jax_bank.locs_lonlat, jax_bank.xyz,
                               jax_bank.keys_sem, jax_bank.values, jax_bank.n_valid)
    enc = _port_like(jenc, name, db_path=bank, beta=0.4)
    assert enc.embedding_dim == jenc.embedding_dim == 1280
    coords = _coords(64, seed=1)
    j = np.asarray(jenc(jnp.asarray(coords)))
    t = enc(coords)
    assert t.shape == (64, 1280) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=ATOL)
    torch.testing.assert_close(torch.linalg.norm(t[:, 1024:], dim=1),
                               torch.ones(64))


def test_npz_round_trip_matches_jax(jax_bank, tmp_path):
    """JAX `GeoBank.save_npz` -> both packages' npz loaders -> the same
    answers (the port recomputes xyz with torch's trig: last-ulp only)."""
    path = str(tmp_path / "bank.npz")
    jax_bank.save_npz(path)
    jenc = range_tpu.load_model("RANGE+", db_path=path, chunk=1024)
    enc = _port_like(jenc, "RANGE+", db_path=path, chunk=1024)
    assert isinstance(enc.model.bank, GeoBank) and enc.model.bank.num_rows == 3072
    coords = _coords(64, seed=2)
    np.testing.assert_allclose(enc(coords).numpy(), np.asarray(jenc(jnp.asarray(coords))),
                               rtol=0, atol=ATOL)


def test_satclip_matches_jax():
    jenc = range_tpu.load_model("SatCLIP", seed=3)
    enc = _port_like(jenc, "SatCLIP")
    coords = _coords(64, seed=3)
    np.testing.assert_allclose(enc(coords).numpy(), np.asarray(jenc(jnp.asarray(coords))),
                               rtol=0, atol=ATOL)


def test_fused_path_on_cpu_within_fast_tier_tolerance():
    """use_pallas=True on the CPU takes the fused path's plain version; it
    stays within the fast tier's tolerance of the exact path
    (tests/test_retrieval_pallas.py: bf16 semantic logits)."""
    exact = load_model("RANGE+", db_path="synthetic:2000", device="cpu", chunk=1024)
    fused = load_model("RANGE+", db_path="synthetic:2000", device="cpu", chunk=1024,
                       use_pallas=True)
    coords = _coords(40, seed=4)
    np.testing.assert_allclose(fused(coords).numpy(), exact(coords).numpy(),
                               rtol=1e-1, atol=5e-2)
    assert sorted(list_models()) == ["RANGE", "RANGE+", "SatCLIP"]


@pytest.mark.parametrize("call,error", [
    (lambda: load_model("RANGE+", db_path="synthetic:100", device="cpu", k_tile=3),
     TypeError),
    (lambda: load_model("RANGE+", device="cpu"), AssertionError),
    # hierarchical RANGE serves (the merged parts kernel): None = no error
    (lambda: load_model("RANGE", db_path="synthetic:1024", device="cpu",
                        profile="flagship", hier_bn=128, gsz_geo=16,
                        chunk=512)(_coords(16, seed=7)), None),
    (lambda: load_model("RANGE+", db_path="synthetic:100", device="cpu",
                        profile="nope"), ValueError),
    # hierarchical RANGE at the JAX defaults (no lr_rank: the merged parts
    # kernel's plain variant) serves too
    (lambda: load_model("RANGE", db_path="synthetic:100", device="cpu",
                        retrieval="hier")(_coords(4, seed=9)), None),
    # a knob of the two-level hier path, accepted as the JAX package does
    # (the dense path does not read it)
    (lambda: load_model("RANGE+", db_path="synthetic:100", device="cpu",
                        m_tiles=8)(_coords(4, seed=10)), None),
    # dense serving on a mesh is ported: a mesh that is no DeviceMesh is
    # refused (tests/test_torch_sharded.py serves real ones)
    (lambda: load_model("RANGE+", db_path="synthetic:100", device="cpu",
                        mesh=object()), TypeError),
    (lambda: load_model("RANGE+", db_path="synthetic:100", device="cpu",
                        value_quant="int8")(_coords(4, seed=8)), None),
    (lambda: load_model("RANGE", db_path="synthetic:100", device="cpu",
                        pretrained_path="ckpt.ckpt"), NotImplementedError),
    (lambda: load_model("SatCLIP", device="cpu", chunk=3), TypeError),
    (lambda: load_model("GeoCLIP", device="cpu"), NotImplementedError),
    (lambda: load_model("RANGE+", db_path="synthetic:100", device="cpu")(
        np.zeros((4, 3), np.float32)), ValueError),
], ids=["unknown_kwarg", "no_db_path", "flagship", "unknown_profile", "hier",
        "hier_knob", "mesh", "int8", "pretrained", "satclip_kwarg",
        "unknown_model", "coords_b3"])
def test_error_contract(call, error):
    if error is None:  # a path that serves: finite [B, 1280] answers
        out = call()
        assert out.shape[1] == 1280 and torch.isfinite(out).all()
        return
    with pytest.raises(error):
        call()


def test_float64_coords_take_the_tower_kernel_path(monkeypatch):
    """numpy's float64 coordinates are cast to the f32 weights' dtype and
    reach the tower kernel's wrapper, as the JAX package's serving default
    (x64 off) makes them f32."""
    enc = load_model("RANGE+", db_path="synthetic:500", device="cpu", chunk=256)
    calls = []

    def counting(*a, **k):
        calls.append(a[0].dtype)
        return siren_tower(*a, **k)

    monkeypatch.setattr(satclip, "siren_tower", counting)
    c64 = _coords(8, seed=6).astype(np.float64)
    out = enc(c64)
    assert calls == [torch.float32] and out.dtype == torch.float32
    assert torch.equal(out, enc(c64.astype(np.float32)))


def test_exact_profile_and_default_device():
    enc = load_model("RANGE", db_path="synthetic:500", device="cpu", profile="exact",
                     chunk=256)
    assert enc(_coords(3, seed=5)).shape == (3, 1280)
    if not torch.cuda.is_available():
        # the default device is CUDA, and nothing falls back to the CPU
        with pytest.raises((RuntimeError, AssertionError)):
            load_model("RANGE+", db_path="synthetic:100")
