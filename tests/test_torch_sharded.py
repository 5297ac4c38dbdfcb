"""range_tpu_torch's bank-sharded dense retrieval against range_tpu's, on the
CPU: the parts kernel's plain version (kernel 5) against the JAX kernel in
interpret mode, and the sharded functions and `load_model(mesh=...)` run in
real gloo process groups (`test_torch_sharded_ranks.py`: a (1, 2) bank
group and a (2, 2) data x bank group) against JAX's on the conftest's
8-device virtual mesh and against the port's single-device `retrieve`.

Tolerances are `tests/test_sharded.py`'s: the streaming path combines
exactly (rtol 1e-5, atol 1e-6 against one device), the fused path rounds
p to bf16 before the value products and runs the 'high' tier's logits
(rtol 2e-3, atol 2e-4, `:101`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

import range_tpu
from range_tpu.bank.bank import GeoBank as JaxGeoBank, quantize_values as jquant
from range_tpu.bank.clustered import cluster_bank as jcluster
from range_tpu.geometry import lonlat_deg_to_xyz as jxyz
from range_tpu.ops import retrieval_pallas as jrp
from range_tpu.parallel.mesh import make_mesh as jmesh
from range_tpu.parallel.sharded import (shard_bank as jshard,
                                        sharded_retrieve as jretrieve,
                                        sharded_retrieve_pallas as jpallas)
from range_tpu_torch.bank.bank import quantize_values
from range_tpu_torch.convert.from_jax import siren_params_from_jax
from range_tpu_torch.ops import retrieval as tr
from range_tpu_torch.ops import retrieval_fused as trf
from test_torch_sharded_ranks import BETA, bank_from, join_group, run_group

EXACT = dict(rtol=1e-5, atol=1e-6)   # the streaming combine: one device's math
FUSED = dict(rtol=2e-3, atol=2e-4)   # bf16 weights, 'high' tier logits
# int8 values through the parts kernel against the f32 reconstruction: each
# weight p * scale rounds to bf16 (2^-9 relative), ~2^-9 x max |v| (~4 here)
# on a weighted average
INT8 = dict(rtol=1e-2, atol=2e-3)
# the full-width tower against JAX's: f32 summation order, as
# tests/test_torch_api.py
MODEL = dict(rtol=0, atol=2e-5)


def _bank(n=1500, b=16, dk=32, dv=64, seed=5, pad_to=1024):
    """`tests/test_sharded.py:16-26`'s bank and queries (2,048 rows)."""
    rng = np.random.default_rng(seed)
    locs = np.stack([rng.uniform(-180, 180, n), rng.uniform(-90, 90, n)],
                    1).astype(np.float32)
    keys = rng.standard_normal((n, dk)).astype(np.float32)
    values = rng.standard_normal((n, dv)).astype(np.float32)
    bank = JaxGeoBank.from_arrays(locs, keys, values, pad_to=pad_to)
    q = rng.standard_normal((b, dk)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qlocs = np.stack([rng.uniform(-180, 180, b), rng.uniform(-90, 90, b)],
                     1).astype(np.float32)
    return bank, q, np.asarray(jxyz(jnp.asarray(qlocs)), np.float32)


def _fields(prefix, b):
    out = {f"{prefix}_{k}": np.asarray(getattr(b, f)) for k, f in (
        ("locs", "locs_lonlat"), ("xyz", "xyz"), ("keys", "keys_sem"),
        ("values", "values"))}
    out[f"{prefix}_n_valid"] = np.int64(b.n_valid)
    if b.valid_mask is not None:
        out[f"{prefix}_valid_mask"] = np.asarray(b.valid_mask)
    return out


def _padded(cb, rows):
    """A clustered bank padded with invalid rows to ``rows``
    (`tests/test_sharded.py:127-145`)."""
    def pad(x):
        return jnp.pad(x, ((0, rows - x.shape[0]), *[(0, 0)] * (x.ndim - 1)))

    return JaxGeoBank(locs_lonlat=pad(cb.locs_lonlat), xyz=pad(cb.xyz),
                      keys_sem=pad(cb.keys_sem), values=pad(cb.values),
                      n_valid=cb.n_valid, valid_mask=pad(cb.valid_mask))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The JAX banks, queries and model, and their npz for the ranks."""
    bank, q, x = _bank()
    cb, _ = jcluster(_bank(n=900, seed=7, pad_to=128)[0], bn=128)
    cb = _padded(cb, -(-cb.num_rows // 1024) * 1024)
    mbank = JaxGeoBank.synthetic(0, 3000, key_dim=256, value_dim=64, pad_to=1024)
    jenc = range_tpu.load_model("RANGE+", db_path=mbank, beta=BETA,
                                mesh=jmesh((1, 8)), shard_bn=128)
    rng = np.random.default_rng(11)
    coords = np.stack([rng.uniform(-180, 180, 16), rng.uniform(-90, 90, 16)],
                      1).astype(np.float32)
    d = {"q": q, "x": x, "coords": coords, **_fields("bank", bank),
         **_fields("cbank", cb), **_fields("mbank", mbank)}
    d.update({f"w_{k}": v.numpy() for k, v in
              siren_params_from_jax(jenc.params).items()})
    path = str(tmp_path_factory.mktemp("sharded") / "inputs.npz")
    np.savez(path, **d)
    return dict(path=path, d=d, bank=bank, cbank=cb, q=q, x=x, jenc=jenc,
                coords=coords)


@pytest.fixture(scope="module")
def jax_refs(case):
    """JAX's sharded results on the (1, 8) virtual mesh (each JAX call
    compiles anew, ~4 s: RANGE and the clustered bank are held to the
    port's single-device retrieve only)."""
    mesh = jmesh((1, 8))
    q, x = jnp.asarray(case["q"]), jnp.asarray(case["x"])
    kw = dict(sem_temp=12.0, geo_temp=40.0, beta=BETA)
    fused = dict(tier="high", bm=8, bn=128, interpret=True)
    sb = jshard(case["bank"], mesh)
    refs = {
        "f32_retrieve": jretrieve(q, x, sb, mesh, chunk=128, **kw),
        "f32_pallas": jpallas(q, x, sb, mesh, **kw, **fused),
        "int8_pallas": jpallas(q, x, jshard(jquant(case["bank"]), mesh), mesh,
                               **kw, **fused),
        "model": case["jenc"](jnp.asarray(case["coords"])),
    }
    return {k: np.asarray(v) for k, v in refs.items()}


def _single(case, name: str) -> np.ndarray:
    """The port's single-device exact `retrieve` for result ``name``."""
    d = case["d"]
    q, x = torch.tensor(d["q"]), torch.tensor(d["x"])
    bank = bank_from(d, "cbank" if name.startswith("clustered") else "bank")
    if name.startswith("int8"):
        bank = quantize_values(bank)
    if name.startswith("range"):
        return tr.retrieve(q, None, bank, sem_temp=15.0, mode="range").numpy()
    return tr.retrieve(q, x, bank, sem_temp=12.0, geo_temp=40.0,
                       beta=BETA).numpy()


def _check(case, refs, outs, names):
    """Every rank holds the same whole batch; each result matches JAX's
    where JAX computed it, and the port's single-device retrieve."""
    for r, out in enumerate(outs[1:], 1):
        for k in outs[0]:
            np.testing.assert_array_equal(out[k], outs[0][k], err_msg=f"rank {r} {k}")
    for name in names:
        got = outs[0][name]
        tol = EXACT if name.endswith("retrieve") else FUSED
        assert got.shape == (16, 64) and np.isfinite(got).all(), name
        if name in refs:
            np.testing.assert_allclose(got, refs[name], err_msg=f"{name} vs JAX",
                                       **tol)
        np.testing.assert_allclose(got, _single(case, name),
                                   err_msg=f"{name} vs one device",
                                   **(INT8 if name == "int8_pallas" else tol))


def test_two_rank_bank_group(case, request, tmp_path):
    """A (1, 2) gloo mesh: sharded_retrieve and sharded_retrieve_pallas for
    RANGE+, RANGE, int8 values and a clustered bank with a scattered
    valid_mask; load_model(mesh=...) at the JAX tower's weights against
    JAX's load_model on its (1, 8) mesh; the shard divisibility ValueError."""
    procs = run_group((1, 2), "bank", case["path"], str(tmp_path))
    refs = request.getfixturevalue("jax_refs")  # JAX runs while the ranks do
    outs = join_group(procs, "bank", str(tmp_path))
    names = [f"{b}_{p}" for b in ("f32", "range", "int8", "clustered")
             for p in ("retrieve", "pallas")]
    _check(case, refs, outs, names)
    model = outs[0]["model"]
    assert model.shape == (16, 64 + 256)
    np.testing.assert_allclose(model, refs["model"], **MODEL)
    assert int(outs[0]["divisibility_error"]) == 1


def test_four_rank_data_and_bank_group(case, jax_refs, tmp_path):
    """A (2, 2) data x bank gloo mesh: each data rank computes 8 of the 16
    queries over its bank shard, an all_gather returns all 16 to every
    rank; B=15 raises ValueError on every rank."""
    outs = join_group(run_group((2, 2), "data", case["path"], str(tmp_path)),
                      "data", str(tmp_path))
    _check(case, jax_refs, outs, ["f32_retrieve", "f32_pallas", "range_retrieve",
                                  "range_pallas"])
    assert int(outs[0]["odd_batch_error"]) == 1


# Kernel 5's plain version against the JAX kernel in interpret mode, column
# by column, pad included.  bf16 values: p rounds to bf16 on both sides and
# the logits differ by summation order, so a p within an ulp of a bf16 tie
# may round the other way (one ulp, 2^-8, of one weight); the sums d and
# the int8 scales' products take the f32 p.
@pytest.mark.parametrize("quant", ["bf16", "int8"])
@pytest.mark.parametrize("tier", ["high", "exact"])
def test_fused_parts_plain_matches_jax(quant, tier):
    bank, q, x = _bank()
    if quant == "int8":
        bank = jquant(bank)
        values, scale = bank.values, bank.value_scale
    else:
        values, scale = bank.values.astype(jnp.bfloat16), None
    jq = jrp.pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier)
    jk = jrp.pack_bank(bank.keys_sem, bank.xyz, tier)
    sem_d, _ = jrp.packed_dims(bank.key_dim, tier)
    mask = (jrp.NEG * (1.0 - bank.row_mask()))[None, :].astype(jnp.float32)
    j = np.asarray(jrp.retrieve_fused_parts(jq, jk, values, mask, scale,
                                            sem_d=sem_d, bm=8, bn=256,
                                            interpret=True))

    def tt(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
        return torch.from_numpy(a.copy())

    t = trf.retrieve_fused_parts(tt(jq), tt(jk), tt(values), tt(mask),
                                 None if scale is None else tt(scale),
                                 sem_d=sem_d).numpy()
    Dv = bank.value_dim
    assert t.shape == j.shape == (16, 2 * Dv + 128)
    np.testing.assert_array_equal(t[:, 2 * Dv + 2:], 0.0)
    np.testing.assert_array_equal(j[:, 2 * Dv + 2:], 0.0)
    # the sums: f32 sums of the same f32 weights in another order
    np.testing.assert_allclose(t[:, 2 * Dv:2 * Dv + 2], j[:, 2 * Dv:2 * Dv + 2],
                               rtol=2e-6, atol=0)
    # the accumulators: a flip moves one weight by one bf16 ulp (2^-8 of
    # it), so an element by at most 2^-8 of its row's d x max |v|
    vmax = float(np.abs(np.asarray(values, np.float32)).max())
    if scale is not None:
        vmax *= float(np.asarray(scale).max())
    for f, cols in enumerate((slice(0, Dv), slice(Dv, 2 * Dv))):
        err = np.abs(t[:, cols] - j[:, cols]) / (j[:, 2 * Dv + f, None] * vmax)
        assert err.max() < 2 ** -8, (f, err.max())
