"""Rank programs of range_tpu_torch's bank-sharded retrieval, and the mesh
tests that need no JAX.

`run_group` starts a real process group on the CPU: one spawned process a
rank, gloo, a `FileStore` in a test's temporary directory (no network), a
`make_mesh(..., device_type="cpu")` mesh, then one of the `PROGRAMS`
below over inputs from an npz.  Each rank writes its results to an npz of
its own; `tests/test_torch_sharded.py` holds them against the JAX package.
This module imports no JAX, so the spawned ranks start quickly.  Every
group has a deadline: a rank that fails or hangs fails the test (the
others are terminated), and every rank destroys its process group.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
import torch.distributed as dist
import torch.multiprocessing as mp

from range_tpu_torch import load_model
from range_tpu_torch.bank.bank import quantize_values
from range_tpu_torch.convert.from_jax import geobank_from_arrays
from range_tpu_torch.parallel.mesh import make_mesh
from range_tpu_torch.parallel.sharded import (shard_bank, sharded_retrieve,
                                              sharded_retrieve_pallas)

TIMEOUT_S = 120.0
BETA = 0.4


def bank_from(d, prefix: str):
    """A port GeoBank from the npz fields ``<prefix>_<field>``."""
    def get(name):
        key = f"{prefix}_{name}"
        return d[key] if key in d else None

    return geobank_from_arrays(get("locs"), get("xyz"), get("keys"), get("values"),
                               int(get("n_valid")), get("valid_mask"), get("scale"))


def _serve(q, x, bank, mesh, **kw):
    """(sharded_retrieve, sharded_retrieve_pallas) at the test's settings."""
    sb = shard_bank(bank, mesh)
    mode = "range" if x is None else "range+"
    temp = 15.0 if x is None else 12.0
    a = sharded_retrieve(q, x, sb, mesh, sem_temp=temp, geo_temp=40.0, beta=BETA,
                         mode=mode, chunk=128, **kw)
    b = sharded_retrieve_pallas(q, x, sb, mesh, sem_temp=temp, geo_temp=40.0,
                                beta=BETA, mode=mode, tier="high", **kw)
    return a.numpy(), b.numpy()


def _raises(exc, fn) -> int:
    try:
        fn()
    except exc:
        return 1
    return 0


def program_bank(mesh, d) -> dict:
    """(1, 2): RANGE+ and RANGE over an f32 bank, RANGE+ over its int8
    codes and over a clustered bank with a scattered valid_mask, then
    `load_model(mesh=...)` with the JAX tower's weights, and the shard
    divisibility rule."""
    q, x = torch.from_numpy(d["q"]), torch.from_numpy(d["x"])
    bank = bank_from(d, "bank")
    out = {}
    out["f32_retrieve"], out["f32_pallas"] = _serve(q, x, bank, mesh)
    out["range_retrieve"], out["range_pallas"] = _serve(q, None, bank, mesh)
    out["int8_retrieve"], out["int8_pallas"] = _serve(q, x, quantize_values(bank), mesh)
    out["clustered_retrieve"], out["clustered_pallas"] = _serve(
        q, x, bank_from(d, "cbank"), mesh)
    model_bank = bank_from(d, "mbank")
    enc = load_model("RANGE+", db_path=model_bank, device="cpu", beta=BETA, mesh=mesh,
                     shard_bn=128)
    enc.model.query_encoder.nnet.load_state_dict(
        {k[len("w_"):]: torch.from_numpy(d[k]) for k in d if k.startswith("w_")})
    out["model"] = enc(d["coords"]).numpy()
    # 3,072 rows do not split into 2 shards of whole 2,048-row tiles
    out["divisibility_error"] = np.int64(_raises(ValueError, lambda: load_model(
        "RANGE+", db_path=model_bank, device="cpu", mesh=mesh, shard_bn=2048)))
    return out


def program_data(mesh, d) -> dict:
    """(2, 2): the batch split over the data axis (each data rank computes
    half of it, an all_gather returns the whole); a batch that does not
    split evenly raises on every rank."""
    q, x = torch.from_numpy(d["q"]), torch.from_numpy(d["x"])
    bank = bank_from(d, "bank")
    out = {}
    out["f32_retrieve"], out["f32_pallas"] = _serve(q, x, bank, mesh, data_axis="data")
    out["range_retrieve"], out["range_pallas"] = _serve(q, None, bank, mesh,
                                                        data_axis="data")
    out["odd_batch_error"] = np.int64(_raises(ValueError, lambda: _serve(
        q[:15], x[:15], bank, mesh, data_axis="data")))
    return out


PROGRAMS = {"bank": program_bank, "data": program_data}


def _rank_main(rank, world, store, shape, program, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = make_mesh(shape, device_type="cpu")
        with np.load(inputs) as f:
            d = {k: f[k] for k in f.files}
        res = PROGRAMS[program](mesh, d)
        np.savez(os.path.join(out_dir, f"{program}_rank{rank}.npz"), **res)
    finally:
        dist.destroy_process_group()


def run_group(shape, program: str, inputs: str, tmp_dir: str):
    """Start ``program`` on a (data, bank) = ``shape`` gloo mesh, one
    spawned process a rank.  Returns the processes, running; `join_group`
    waits for them."""
    world = int(np.prod(shape))
    store = os.path.join(tmp_dir, f"store_{program}")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, tuple(shape), program, inputs, tmp_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def join_group(procs, program: str, tmp_dir: str):
    """Wait for every rank (TIMEOUT_S in all), terminate those left, and
    return each rank's results; a rank that failed or hung fails."""
    deadline = time.monotonic() + TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
        if p.is_alive():
            p.kill()
            p.join(10)
    assert not hung, f"{program}: {len(hung)} of {len(procs)} ranks hung"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * len(procs), f"{program}: rank exit codes {codes}"
    out = []
    for r in range(len(procs)):
        with np.load(os.path.join(tmp_dir, f"{program}_rank{r}.npz")) as f:
            out.append({k: f[k] for k in f.files})
    return out


@pytest.fixture
def one_rank(tmp_path):
    """A world-size-1 gloo group in this process, destroyed afterwards."""
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_make_mesh_needs_a_process_group():
    """No process group: make_mesh raises, it never serves on one device."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh((1, 1), device_type="cpu")


def test_mesh_errors(one_rank):
    """The mesh shape must match the world size (`parallel/mesh.py:37-38`);
    a mesh with retrieval='hier' is not ported and raises, before any
    build."""
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh((1, 2), device_type="cpu")
    mesh = make_mesh((1, 1), device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "bank")
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        load_model("RANGE+", db_path="synthetic:100", device="cpu", mesh=mesh,
                   retrieval="hier")
    with pytest.raises(NotImplementedError, match="Multi-GPU"):
        load_model("RANGE+", db_path="synthetic:100", device="cpu", mesh=mesh,
                   profile="flagship")


@pytest.mark.parametrize("name", ["RANGE+", "RANGE"])
def test_one_rank_mesh_equals_single_device(one_rank, name):
    """A (1, 1) mesh serves what the single-device model serves: one shard,
    so the logsumexp merge scales by e^0 = 1 (the same f32 operations)."""
    mesh = make_mesh((1, 1), device_type="cpu")
    enc = load_model(name, db_path="synthetic:300", device="cpu", chunk=256,
                     mesh=mesh)
    ref = load_model(name, db_path="synthetic:300", device="cpu", chunk=256)
    rng = np.random.default_rng(3)
    coords = np.stack([rng.uniform(-180, 180, 6), rng.uniform(-90, 90, 6)],
                      1).astype(np.float32)
    torch.testing.assert_close(enc(coords), ref(coords), rtol=0, atol=1e-6)
