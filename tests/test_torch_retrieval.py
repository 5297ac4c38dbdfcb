"""range_tpu_torch's retrieval against range_tpu's: packing, the plain
fused retrieval (held against the JAX fused kernel in interpret mode) and
the exact streaming retrieve.  The JAX bank's fields cross as numpy
(`convert.from_jax.geobank_from_arrays`), unchanged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.ops import retrieval as jr
from range_tpu.ops import retrieval_pallas as jrp
from range_tpu_torch.bank.bank import GeoBank
from range_tpu_torch.convert.from_jax import geobank_from_arrays
from range_tpu_torch.ops import retrieval as tr
from range_tpu_torch.ops import retrieval_fused as trf

TIERS = ["exact", "high", "fast"]


def _bank(n=700, pad_to=256, key_dim=64, value_dim=96, seed=0):
    jb = JaxGeoBank.synthetic(seed, n, key_dim=key_dim, value_dim=value_dim,
                              pad_to=pad_to)
    return jb, geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem,
                                   jb.values, jb.n_valid)


def _queries(b, key_dim=64, seed=1):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, key_dim)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = rng.standard_normal((b, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return q, x


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("tier", TIERS)
def test_packing_bit_equal(tier):
    """Same columns, same bits: torch's bf16 cast rounds to nearest even as
    `lax.reduce_precision` does (`retrieval_pallas.py:51-61`)."""
    jb, tb = _bank()
    q, x = _queries(19)
    a = jrp.pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier)
    b = trf.pack_queries(torch.from_numpy(q), torch.from_numpy(x), 12.0, 40.0, tier)
    c = jrp.pack_bank(jb.keys_sem, jb.xyz, tier)
    d = trf.pack_bank(tb.keys_sem, tb.xyz, tier)
    assert str(b.dtype).endswith(str(a.dtype)) and str(d.dtype).endswith(str(c.dtype))
    np.testing.assert_array_equal(_np(b), np.asarray(a.astype(jnp.float32)))
    np.testing.assert_array_equal(_np(d), np.asarray(c.astype(jnp.float32)))
    assert trf.packed_dims(64, tier) == jrp.packed_dims(64, tier)
    q0 = trf.pack_queries(torch.from_numpy(q), None, 12.0, 40.0, tier)
    assert not _np(q0)[:, trf.packed_dims(64, tier)[0]:].any()


# The plain fused retrieval against the JAX fused kernel in interpret mode:
# the same packed operands and unnormalized exp2 sums, summed in another
# order; measured <= 6e-7 on outputs ~0.5.
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("mode", ["range+", "range"])
def test_fused_plain_matches_jax(tier, mode):
    jb, tb = _bank()
    q, x = _queries(24)
    kw = dict(sem_temp=12.0 if mode == "range+" else 15.0, geo_temp=40.0,
              beta=0.5, mode=mode, tier=tier)
    j = jrp.retrieve_pallas(jnp.asarray(q), jnp.asarray(x), jb, bm=16, bn=256,
                            interpret=True, **kw)
    t = trf.retrieve_pallas(torch.from_numpy(q), torch.from_numpy(x), tb, **kw)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=5e-6)


@pytest.mark.parametrize("case", ["padded_rows", "ragged_batch", "bf16_values"])
def test_fused_plain_edge_cases(case):
    """A masked bank (700 real rows of 1024), a batch that is no multiple of
    any block (19), and bf16 values (p rounds to bf16 before the value
    product on both sides): tolerance as above."""
    n, pad_to, b = (700, 512, 24) if case == "padded_rows" else (1024, 256, 19)
    jb, tb = _bank(n=n, pad_to=pad_to, seed=2)
    if case == "bf16_values":
        jb = JaxGeoBank(locs_lonlat=jb.locs_lonlat, xyz=jb.xyz, keys_sem=jb.keys_sem,
                        values=jb.values.astype(jnp.bfloat16), n_valid=jb.n_valid)
        tb = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values,
                                 jb.n_valid)
        assert tb.values.dtype == torch.bfloat16
    q, x = _queries(b, seed=3)
    j = jrp.retrieve_pallas(jnp.asarray(q), jnp.asarray(x), jb, beta=0.3, bm=16,
                            bn=256, interpret=True)
    t = trf.retrieve_pallas(torch.from_numpy(q), torch.from_numpy(x), tb, beta=0.3)
    assert t.shape == (b, 96) and torch.isfinite(t).all()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=5e-6)


# The exact streaming retrieve: f32 online softmax on both sides, chunked
# alike; measured 6e-8.
@pytest.mark.parametrize("mode", ["range+", "range"])
def test_retrieve_matches_jax(mode):
    jb, tb = _bank(n=900, pad_to=512, seed=4)
    q, x = _queries(33, seed=5)
    temp = 12.0 if mode == "range+" else 15.0
    j = jr.retrieve(jnp.asarray(q), jnp.asarray(x), jb, sem_temp=temp, beta=0.4,
                    mode=mode, chunk=256)
    t = tr.retrieve(torch.from_numpy(q), torch.from_numpy(x), tb, sem_temp=temp,
                    beta=0.4, mode=mode, chunk=256)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=1e-6)


def test_retrieve_requires_xyz_for_range_plus():
    _, tb = _bank()
    q, _ = _queries(3)
    with pytest.raises(ValueError, match="q_xyz"):
        tr.retrieve(torch.from_numpy(q), None, tb, mode="range+")


def test_geobank_matches_jax():
    """`GeoBank.synthetic` draws what the JAX package draws from the same
    seed; xyz comes from torch's trig (last-ulp differences only)."""
    jb = JaxGeoBank.synthetic(7, 300, key_dim=16, value_dim=32, pad_to=128)
    tb = GeoBank.synthetic(7, 300, key_dim=16, value_dim=32, pad_to=128,
                           device="cpu")
    assert (tb.num_rows, tb.key_dim, tb.value_dim, tb.n_valid) == (384, 16, 32, 300)
    for name in ("locs_lonlat", "keys_sem", "values"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)))
    np.testing.assert_allclose(tb.xyz.numpy(), np.asarray(jb.xyz), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tb.row_mask().numpy(), np.asarray(jb.row_mask()))


def test_synthetic_device_recipe():
    """Seeded, unit-norm keys on the real rows, zero padding rows."""
    a = GeoBank.synthetic_device(3, 1000, key_dim=16, value_dim=8, pad_to=256,
                                 value_dtype=torch.bfloat16, device="cpu")
    b = GeoBank.synthetic_device(3, 1000, key_dim=16, value_dim=8, pad_to=256,
                                 value_dtype=torch.bfloat16, device="cpu")
    assert a.num_rows == 1024 and a.values.dtype == torch.bfloat16
    assert torch.equal(a.keys_sem, b.keys_sem) and torch.equal(a.values, b.values)
    norms = torch.linalg.norm(a.keys_sem, dim=1)
    torch.testing.assert_close(norms[:1000], torch.ones(1000))
    assert not a.keys_sem[1000:].any() and not a.xyz[1000:].any()
    assert a.row_mask().sum() == 1000
    torch.testing.assert_close(torch.linalg.norm(a.xyz[:1000], dim=1), torch.ones(1000))
