"""int8 bank values in range_tpu_torch, against range_tpu on the CPU:
`quantize_values`, the dense fused path over int8 codes (the plain version
of the int8 kernel, held against the JAX int8 kernel in interpret mode and
against the exact retrieve over the dequantized bank) and
`load_model(value_quant="int8")`.

Sizes are small (a 900-row bank with 64-d keys and 128-d values for the
fused path, `tests/test_retrieval_pallas.py:111`; 600 rows with 256-d keys
for the entry point, `tests/test_api.py:134`).  Inputs are float32
(conftest enables x64).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

import range_tpu
from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.bank.bank import quantize_values as jax_quantize
from range_tpu.ops import retrieval_pallas as jrp
from range_tpu_torch import GeoBank, load_model
from range_tpu_torch.bank import dequantize_values, quantize_values
from range_tpu_torch.convert.from_jax import geobank_from_arrays
from range_tpu_torch.ops import retrieval as tr
from range_tpu_torch.ops import retrieval_fused as trf


@pytest.fixture(scope="module")
def banks():
    """The JAX bank quantized by JAX, and the same codes carried across."""
    jb = jax_quantize(JaxGeoBank.synthetic(0, 900, key_dim=64, value_dim=128,
                                           pad_to=256))
    tb = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values,
                             jb.n_valid, value_scale=jb.value_scale)
    return jb, tb


def _queries(b, key_dim, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, key_dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = rng.standard_normal((b, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return q, x


@pytest.mark.parametrize("dtype", [np.float32, "bf16"])
def test_quantize_values_bit_equal_to_jax(dtype):
    """torch.round and jnp.round both round half to even, and the scale is
    the same f32 max / 127, so the codes and scales are JAX's bit for bit:
    gaussian rows, a zero row (scale 1e-12 / 127), rows of exact halves and
    bf16 values (the flagship's dtype).  Idempotent; the reconstruction is
    within 0.51 scale of each value (`tests/test_retrieval_pallas.py:
    111-124`)."""
    rng = np.random.default_rng(0)
    v = rng.standard_normal((300, 96)).astype(np.float32)
    v[3] = 0.0
    v[4] = np.arange(96, dtype=np.float32) - 47.5  # halves after / scale
    v[5, :] = 0.5
    v[5, 0] = 127.0
    jv = jnp.asarray(v)
    if dtype == "bf16":
        jv = jv.astype(jnp.bfloat16)
    jb = JaxGeoBank(locs_lonlat=jnp.zeros((300, 2)), xyz=jnp.zeros((300, 3)),
                    keys_sem=jnp.zeros((300, 8)), values=jv, n_valid=300)
    tb = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values, 300)
    jq, tq = jax_quantize(jb), quantize_values(tb)
    assert tq.values.dtype == torch.int8 and tq.value_scale.shape == (1, 300)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    np.testing.assert_array_equal(tq.value_scale.numpy(),
                                  np.asarray(jq.value_scale))
    assert quantize_values(tq) is tq
    deq = dequantize_values(tq)
    err = (deq - tb.values.float()).abs()
    assert (err <= 0.51 * tq.value_scale.T).all()
    assert torch.equal(dequantize_values(tb), tb.values.float())


# The plain int8 fused retrieval against the JAX int8 kernel in interpret
# mode on the same codes: the same packed operands, the scale folded into
# p before its bf16 cast on both sides, f32 sums in another order (~1e-6
# relative on p).  A weight that this moves across a bf16 boundary rounds
# the other way: one bf16 ulp (2^-8 relative) of one weight times one
# |v8 * s| <= max|v| in a row of outputs ~0.05-0.5, so 2e-5 holds the rows.
@pytest.mark.parametrize("tier", ["exact", "fast"])
@pytest.mark.parametrize("mode", ["range+", "range"])
def test_int8_fused_plain_matches_jax(banks, tier, mode):
    jb, tb = banks
    q, x = _queries(24, 64, seed=1)
    kw = dict(sem_temp=12.0 if mode == "range+" else 15.0, geo_temp=40.0,
              beta=0.5, mode=mode, tier=tier)
    j = np.asarray(jrp.retrieve_pallas(jnp.asarray(q), jnp.asarray(x), jb, bm=16,
                                       bn=256, interpret=True, **kw))
    before = trf.retrieve_fused_i8.launches
    t = trf.retrieve_pallas(torch.from_numpy(q), torch.from_numpy(x), tb, **kw)
    assert trf.retrieve_fused_i8.launches == before  # the plain version on the CPU
    assert t.shape == (24, 128) and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=2e-5)


def test_int8_fused_vs_exact_dequantized(banks):
    """The int8 path against the exact f32 retrieve over the dequantized
    bank (which `retrieve` takes for an int8 bank): the JAX test's bar,
    relerr (denominator max(|ref|, 0.1)) max < 0.05, mean < 0.01 at the
    exact tier, whose logits are f32 (`tests/test_retrieval_pallas.py:
    125-135`)."""
    _, tb = banks
    q, x = _queries(32, 64, seed=2)
    qt, xt = torch.from_numpy(q), torch.from_numpy(x)
    got = trf.retrieve_pallas(qt, xt, tb, tier="exact")
    ref = tr.retrieve(qt, xt, tb)
    deq = GeoBank(locs_lonlat=tb.locs_lonlat, xyz=tb.xyz, keys_sem=tb.keys_sem,
                  values=dequantize_values(tb), n_valid=tb.n_valid)
    assert torch.equal(ref, tr.retrieve(qt, xt, deq))
    rel = (got - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.max() < 0.05 and rel.mean() < 0.01


def test_load_model_value_quant_matches_bf16_and_jax():
    """`load_model(value_quant="int8")` quantizes the bank at load: the
    answers stay within rel 0.05 of the unquantized model's (`tests/
    test_api.py:134-149`), and on the CPU they are JAX's (both take the
    exact retrieve over the dequantized codes; the tower as in
    tests/test_torch_api.py)."""
    from range_tpu_torch.convert.from_jax import siren_params_from_jax

    jbank = JaxGeoBank.synthetic(0, 600, key_dim=256, value_dim=64, pad_to=256)
    bank = geobank_from_arrays(jbank.locs_lonlat, jbank.xyz, jbank.keys_sem,
                               jbank.values, jbank.n_valid)
    coords = np.stack([np.linspace(-170, 170, 8), np.linspace(-80, 80, 8)],
                      1).astype(np.float32)
    jq8 = range_tpu.load_model("RANGE+", db_path=jbank, value_quant="int8",
                               use_pallas=False)
    q8 = load_model("RANGE+", db_path=bank, value_quant="int8", device="cpu")
    f32 = load_model("RANGE+", db_path=bank, device="cpu")
    for enc in (q8, f32):
        enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jq8.params))
    hb = q8.model.bank
    assert hb.values.dtype == torch.int8 and hb.value_scale.shape == (1, 768)
    assert bank.value_scale is None  # the caller's bank is left as it is
    a, b = q8(coords), f32(coords)
    rel = (a - b).abs() / b.abs().clamp_min(0.1)
    assert rel.max() < 0.05
    np.testing.assert_allclose(a.numpy(), np.asarray(jq8(jnp.asarray(coords))),
                               rtol=0, atol=2e-5)
    with pytest.raises(ValueError, match="int4"):
        load_model("RANGE+", db_path=bank, value_quant="int4", device="cpu")


def test_geobank_moves_its_scale():
    tb = quantize_values(GeoBank.synthetic(1, 100, key_dim=8, value_dim=16,
                                           pad_to=64, device="cpu"))
    moved = tb.to("cpu")
    assert moved.value_scale is not None and torch.equal(moved.value_scale,
                                                         tb.value_scale)
