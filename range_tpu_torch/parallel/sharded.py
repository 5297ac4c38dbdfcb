"""Bank-sharded dense retrieval over a device mesh.

Counterpart of `range_tpu/parallel/sharded.py:29-228`.  Each rank holds a
slab of the bank's rows (`shard_bank`) and computes its partial softmax
states over that slab; the partials then combine across the mesh's bank
axis, exactly:

  * `sharded_retrieve`: the streaming online softmax of
    `ops/retrieval.partial_states`, merged with the logsumexp algebra
    (`all_reduce(MAX)` of the running max m, then `all_reduce(SUM)` of
    d e^{m - m_all} and acc e^{m - m_all}), as JAX's `pmax` / `psum`;
  * `sharded_retrieve_pallas`: the fused parts kernel (kernel 5,
    `ops/retrieval_fused.retrieve_fused_parts`) over the slab, whose
    unnormalized partials [acc_s | acc_g | d_s | d_g | 0 ...] add up with
    ONE `all_reduce(SUM)` (the logits are bounded by the temperatures, so
    no running max is needed), then the normalize and blend.

With a ``data_axis`` every rank takes the whole batch, computes its
``B / n_data`` rows, and an `all_gather` over the data axis returns the
whole [B, Dv] on every rank (JAX's global-array result).  There is no
single-device fallback: the collectives need the mesh's process groups.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from ..bank.bank import GeoBank, dequantize_values
from ..ops import retrieval
from ..ops.retrieval_fused import (_packed, _serving_values,
                                   retrieve_fused_parts)
from .mesh import axis_size


def shard_bank(bank: GeoBank, mesh, axis: str = "bank") -> GeoBank:
    """This rank's slab of the bank's rows along mesh axis ``axis``
    (`sharded.py:29-52`): its rows of every row field and of ``valid_mask``,
    its columns of ``value_scale`` [1, Np], and the GLOBAL ``n_valid`` (the
    sharded functions clip it to the slab).  The slab is a copy, so the
    full bank can be dropped.  Raises ValueError unless the rows divide
    evenly into the axis's shards."""
    n = axis_size(mesh, axis)
    if bank.num_rows % n:
        raise ValueError(f"bank rows {bank.num_rows} must divide evenly into "
                         f"{n} shards along {axis!r}")
    rps = bank.num_rows // n
    rows = slice(mesh.get_local_rank(axis) * rps,
                 (mesh.get_local_rank(axis) + 1) * rps)

    def take(x):
        return None if x is None else x[rows].clone()

    return GeoBank(
        locs_lonlat=take(bank.locs_lonlat), xyz=take(bank.xyz),
        keys_sem=take(bank.keys_sem), values=take(bank.values),
        n_valid=bank.n_valid, valid_mask=take(bank.valid_mask),
        value_scale=(None if bank.value_scale is None
                     else bank.value_scale[:, rows].clone()))


def _local_dequant(bank_l: GeoBank) -> GeoBank:
    """An int8 slab with f32 values reconstructed (`sharded.py:52-59`)."""
    if bank_l.value_scale is None:
        return bank_l
    return dataclasses.replace(bank_l, values=dequantize_values(bank_l),
                               value_scale=None)


def _local_bank(bank_l: GeoBank, mesh, axis: str) -> GeoBank:
    """The slab with its own validity: a scattered ``valid_mask`` slab as it
    is, else the global prefix [0, n_valid) clipped to the slab's rows
    (`sharded.py:106-118`)."""
    if bank_l.valid_mask is not None:
        return bank_l
    row0 = mesh.get_local_rank(axis) * bank_l.num_rows
    return dataclasses.replace(
        bank_l, n_valid=min(max(bank_l.n_valid - row0, 0), bank_l.num_rows))


def _my_rows(B: int, mesh, data_axis: Optional[str]) -> slice:
    """This rank's rows of the batch along ``data_axis`` (all of them
    without one)."""
    if data_axis is None:
        return slice(0, B)
    n = axis_size(mesh, data_axis)
    if B % n:
        raise ValueError(f"batch {B} must divide evenly over the {n} ranks of "
                         f"data axis {data_axis!r}")
    i = mesh.get_local_rank(data_axis)
    return slice(i * B // n, (i + 1) * B // n)


def _gather_rows(x: torch.Tensor, mesh, data_axis: Optional[str]):
    """The whole batch from every data rank's rows, on every rank."""
    if data_axis is None:
        return x
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, data_axis))]
    dist.all_gather(parts, x.contiguous(), group=mesh.get_group(data_axis))
    return torch.cat(parts)


def sharded_retrieve(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor],
                     bank: GeoBank, mesh, *, sem_temp: float = 12.0,
                     geo_temp: float = 40.0, beta: float = 0.5,
                     mode: str = "range+", chunk: int = 4096,
                     bank_axis: str = "bank", data_axis: Optional[str] = None,
                     compute_dtype=torch.float32) -> torch.Tensor:
    """Exact retrieval over a bank sharded along ``bank_axis`` (``bank`` is
    this rank's `shard_bank` slab): the streaming online softmax per slab,
    merged with the logsumexp algebra (`sharded.py:62-148`).  int8 slabs
    serve their f32 reconstruction.  Returns [B, Dv] f32 on every rank."""
    rows = _my_rows(q_sem.shape[0], mesh, data_axis)
    q_sem = q_sem[rows]
    q_xyz = None if q_xyz is None or mode != "range+" else q_xyz[rows]
    bank_l = _local_bank(_local_dequant(bank), mesh, bank_axis)
    states = retrieval.partial_states(
        q_sem, q_xyz, bank_l, sem_temp=sem_temp, geo_temp=geo_temp, mode=mode,
        chunk=chunk, compute_dtype=compute_dtype)
    group = mesh.get_group(bank_axis)

    def combine(state: retrieval.SoftmaxState) -> torch.Tensor:
        m_all = state.m.clone()
        dist.all_reduce(m_all, op=dist.ReduceOp.MAX, group=group)
        scale = torch.exp(state.m - m_all)
        d = state.d * scale
        acc = state.acc * scale[:, None]
        dist.all_reduce(d, group=group)
        dist.all_reduce(acc, group=group)
        return acc / d[:, None]

    out = combine(states[0])
    if mode == "range+":
        out = beta * out + (1.0 - beta) * combine(states[1])
    return _gather_rows(out, mesh, data_axis)


def sharded_retrieve_pallas(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor],
                            bank: GeoBank, mesh, *, sem_temp: float = 12.0,
                            geo_temp: float = 40.0, beta: float = 0.5,
                            mode: str = "range+", tier: str = "fast",
                            bank_axis: str = "bank",
                            data_axis: Optional[str] = None) -> torch.Tensor:
    """Multi-device dense retrieval with the fused parts kernel per slab
    (`sharded.py:151-228`, under the JAX package's name): kernel 5 over this
    rank's rows, one `all_reduce(SUM)` of the [B, 2 Dv + 128] partials
    over ``bank_axis``, then each family over its sum, blended.  int8 slabs
    stream their codes with the scales.  The TPU tiling arguments (bm, bn,
    interpret) have no counterpart.  Returns [B, Dv] f32 on every rank."""
    if mode == "range":
        beta = 1.0
        q_xyz = None
    rows = _my_rows(q_sem.shape[0], mesh, data_axis)
    bank_l = _local_bank(bank, mesh, bank_axis)
    q_cat, k_cat, sem_d, mask_neg = _packed(
        q_sem[rows], None if q_xyz is None else q_xyz[rows], bank_l,
        sem_temp, geo_temp, tier)
    if bank_l.value_scale is not None:
        values, scale = bank_l.values, bank_l.value_scale
    else:
        values, scale = _serving_values(bank_l.values), None
    parts = retrieve_fused_parts(q_cat, k_cat, values, mask_neg, scale,
                                 sem_d=sem_d)
    dist.all_reduce(parts, group=mesh.get_group(bank_axis))
    Dv = bank.value_dim
    out = parts[:, :Dv] / torch.clamp_min(parts[:, 2 * Dv:2 * Dv + 1], 1e-30)
    if mode != "range":
        geo = parts[:, Dv:2 * Dv] / torch.clamp_min(
            parts[:, 2 * Dv + 1:2 * Dv + 2], 1e-30)
        out = beta * out + (1.0 - beta) * geo
    return _gather_rows(out, mesh, data_axis)
