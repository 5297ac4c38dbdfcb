"""Exact streaming dual-softmax retrieval (the ground truth).

Counterpart of `range_tpu/ops/retrieval.py:34-209` (reference
`range/range.py:209-240`):

  sem  = softmax(sem_temp * q_sem @ K_semT) @ V
  geo  = softmax(geo_temp * q_xyz @ K_xyzT) @ V          (RANGE+)
  out  = beta * sem + (1 - beta) * geo

Both softmax-weighted sums stream over bank row chunks with an online
(max-tracking) softmax, so the [B, N] similarity matrix never exists.  This
is the path `RangeEncoder` takes with ``use_pallas=False``, and the
reference the fused kernel is held to.  The matmuls run in float32; on a
CUDA device that is true f32 only while
``torch.backends.cuda.matmul.allow_tf32`` is False (PyTorch's default).
`exact_nn`, the recall ground truth, forces true f32 whatever that flag.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..bank.bank import GeoBank, dequantize_values

_NEG = -1e30


@contextlib.contextmanager
def true_f32_matmul():
    """Full-f32 products inside, whatever the caller's TF32 setting, which
    is restored on exit.  The switch is set through the API the caller
    uses: PyTorch refuses to read its older switches (`allow_tf32`, the
    matmul precision) once the newer `fp32_precision` has been set, and
    mixing the two makes later reads raise."""
    matmul = torch.backends.cuda.matmul
    try:
        prev = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set `fp32_precision`
        prev = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
        try:
            yield
        finally:
            matmul.fp32_precision = prev
        return
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def first_argmax(x: torch.Tensor) -> torch.Tensor:
    """[B] int64: the lowest index of each row's maximum (`jnp.argmax`'s tie
    rule, written out rather than left to a backend's reduction)."""
    m = torch.amax(x, dim=1, keepdim=True)
    cols = torch.arange(x.shape[1], device=x.device)
    return torch.where(x >= m, cols, x.shape[1]).amin(dim=1)


class SoftmaxState(NamedTuple):
    """Online-softmax accumulator for one attention path."""

    m: torch.Tensor    # [B]     running max of logits
    d: torch.Tensor    # [B]     running sum of exp(logit - m)
    acc: torch.Tensor  # [B, Dv] running sum of exp(logit - m) * V


def init_state(batch: int, value_dim: int, device) -> SoftmaxState:
    f32 = torch.float32
    return SoftmaxState(
        m=torch.full((batch,), _NEG, dtype=f32, device=device),
        d=torch.zeros((batch,), dtype=f32, device=device),
        acc=torch.zeros((batch, value_dim), dtype=f32, device=device))


def update_state(state: SoftmaxState, logits: torch.Tensor,
                 values: torch.Tensor) -> SoftmaxState:
    """Fold one [B, C] logit block with its [C, Dv] values into the state.
    ``p`` is cast to the values' dtype before the product, which then
    accumulates in f32 (both operands upcast: a bf16 `torch.matmul` would
    return bf16)."""
    m_new = torch.maximum(state.m, logits.max(dim=-1).values)
    scale = torch.exp(state.m - m_new)
    p = torch.exp(logits - m_new[:, None])
    d_new = state.d * scale + p.sum(dim=-1)
    acc_new = state.acc * scale[:, None] + (
        p.to(values.dtype).to(torch.float32) @ values.to(torch.float32))
    return SoftmaxState(m_new, d_new, acc_new)


def finalize(state: SoftmaxState) -> torch.Tensor:
    return state.acc / state.d[:, None]


def _pick_chunk(n_rows: int, chunk: int) -> int:
    """Largest divisor of n_rows that is <= chunk."""
    chunk = min(chunk, n_rows)
    for c in range(chunk, 0, -1):
        if n_rows % c == 0:
            return c
    return n_rows


def retrieve(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor],
             bank: GeoBank, *, sem_temp: float = 12.0, geo_temp: float = 40.0,
             beta: float = 0.5, mode: str = "range+", chunk: int = 4096,
             compute_dtype=torch.float32) -> torch.Tensor:
    """Streaming exact dual-softmax retrieval (`ops/retrieval.py:101`).

    Args:
      q_sem: [B, Dk] L2-normalized query embeddings.
      q_xyz: [B, 3] query unit vectors (required for mode='range+').
      bank: GeoBank (row-padded; invalid rows are masked).
      mode: 'range' (semantic only) or 'range+' (blend).
    Returns:
      [B, Dv] float32 retrieved features.

    An int8 bank (`bank.quantize_values`) is served from its f32
    reconstruction (`ops/retrieval.py:130-138`).
    """
    if bank.value_scale is not None:
        bank = dataclasses.replace(bank, values=dequantize_values(bank),
                                   value_scale=None)
    sem_state, geo_state = partial_states(
        q_sem, q_xyz, bank, sem_temp=sem_temp, geo_temp=geo_temp, mode=mode,
        chunk=chunk, compute_dtype=compute_dtype)
    sem = finalize(sem_state)
    if mode != "range+":
        return sem
    return beta * sem + (1.0 - beta) * finalize(geo_state)


def partial_states(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor],
                   bank: GeoBank, *, sem_temp: float, geo_temp: float = 40.0,
                   mode: str = "range+", chunk: int = 4096,
                   compute_dtype=torch.float32
                   ) -> Tuple[SoftmaxState, SoftmaxState]:
    """Streaming pass over the bank returning the un-finalized softmax
    states of the semantic and geo paths (`ops/retrieval.py:151`)."""
    B = q_sem.shape[0]
    n_rows = bank.num_rows
    chunk = _pick_chunk(n_rows, chunk)
    mask_neg = (_NEG * (1.0 - bank.row_mask())).to(compute_dtype)
    q_sem = q_sem.to(compute_dtype)
    want_geo = mode == "range+"
    if want_geo:
        if q_xyz is None:
            raise ValueError("mode='range+' requires q_xyz")
        q_xyz = q_xyz.to(compute_dtype)
    sem_state = init_state(B, bank.value_dim, q_sem.device)
    geo_state = init_state(B, bank.value_dim, q_sem.device)
    for lo in range(0, n_rows, chunk):
        rows = slice(lo, lo + chunk)
        v = bank.values[rows].to(compute_dtype)
        mneg = mask_neg[rows][None, :]
        k_sem = bank.keys_sem[rows].to(compute_dtype)
        sem_state = update_state(sem_state,
                                 sem_temp * (q_sem @ k_sem.T) + mneg, v)
        if want_geo:
            k_xyz = bank.xyz[rows].to(compute_dtype)
            geo_state = update_state(geo_state,
                                     geo_temp * (q_xyz @ k_xyz.T) + mneg, v)
    return sem_state, geo_state


def exact_nn(q_sem: torch.Tensor, bank: GeoBank,
             chunk: int = 8192) -> torch.Tensor:
    """Exact argmax over semantic similarity, the ground truth for recall@k
    (`ops/retrieval.py:212-251`): [B] int32 bank rows, streaming over bank
    chunks.  Within a chunk the lowest index wins; across chunks a later
    chunk wins only when strictly greater.

    The products are true f32 whatever the caller's TF32 setting: TF32
    keeps about the serving tier's precision, and a ground truth at that
    precision makes recall vacuously 1 (the JAX function's HIGHEST)."""
    n_rows = bank.num_rows
    chunk = _pick_chunk(n_rows, chunk)
    mask_neg = _NEG * (1.0 - bank.row_mask().to(torch.float32))
    q = q_sem.to(torch.float32)
    best = torch.full((q.shape[0],), _NEG, dtype=torch.float32,
                      device=q.device)
    best_idx = torch.zeros((q.shape[0],), dtype=torch.int32, device=q.device)
    with true_f32_matmul():
        for lo in range(0, n_rows, chunk):
            k = bank.keys_sem[lo:lo + chunk].to(torch.float32)
            sims = q @ k.T + mask_neg[None, lo:lo + chunk]
            blk_best = sims.amax(dim=1)
            take = blk_best > best
            best = torch.where(take, blk_best, best)
            best_idx = torch.where(take, (first_argmax(sims) + lo).to(
                torch.int32), best_idx)
    return best_idx
