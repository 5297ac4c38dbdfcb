"""Fused dense dual-softmax retrieval: packing, kernel wrapper, plain version.

Counterpart of `range_tpu/ops/retrieval_pallas.py` (the module name differs
because the kernel here is CUDA, not Pallas).  Computes

  out = beta * softmax(ts * q_sem K_semT) V + (1-beta) * softmax(tg * q_xyz K_xyzT) V

in one pass over the bank: per bank tile, both logit families against the
packed keys plus the row mask, ``p = exp2(min(logit, 86))`` (log2(e) and the
temperatures are folded into the packed queries), the unnormalized sums
``d_s``, ``d_g`` and ``acc += p.V`` per family; then each family is divided
by its own sum (clamped at 1e-30) and the two are blended with beta.  The
logits are bounded by the temperatures for unit queries and keys, so no
running max is needed.

Precision tiers of the logit matmuls (`retrieval_pallas.py:19-25`):
  'exact' — f32 operands, true f32 products.
  'high'  — bf16 hi/lo split of queries and keys, 3 cross terms.
  'fast'  — plain bf16 semantic logits, hi/lo geo logits.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG = -1e30
LOG2E = 1.4426950408889634
CLAMP2 = 86.0  # 2^86 ~ 7.7e25, far from f32 overflow even when summed


def _split_hilo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (bf16 hi, bf16 lo) with hi + lo ~= x to ~16 mantissa bits.
    Both casts round to nearest even, as `lax.reduce_precision` does
    (`retrieval_pallas.py:51-61`)."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def packed_dims(key_dim: int, tier: str) -> Tuple[int, int]:
    """(sem_cols, total_cols) for a tier; total is 128-aligned."""
    if tier in ("exact", "fast"):
        sem = key_dim
    elif tier == "high":
        sem = 3 * key_dim
    else:
        raise ValueError(f"unknown precision tier {tier}")
    # geo block: 9 hi/lo cross columns (3 for 'exact'), padded
    return sem, _round_up(sem + 9, 128)


def _pad_cols(x: torch.Tensor, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols - x.shape[1]))


def pack_queries(q_sem: torch.Tensor, q_xyz, sem_temp: float,
                 geo_temp: float, tier: str = "exact") -> torch.Tensor:
    """Packed query matrix [B, cat_d]; column semantics match `pack_bank`."""
    B = q_sem.shape[0]
    f32 = torch.float32
    qs = (sem_temp * LOG2E * q_sem).to(f32)
    g = ((geo_temp * LOG2E * q_xyz).to(f32) if q_xyz is not None
         else torch.zeros((B, 3), dtype=f32, device=q_sem.device))
    _, cat_d = packed_dims(q_sem.shape[1], tier)
    if tier == "exact":
        return _pad_cols(torch.cat([qs, g], dim=1), cat_d)
    gh, gl = _split_hilo(g)
    geo_cols = torch.cat([gh, gh, gl], dim=1)  # pairs with [xh, xl, xh]
    if tier == "high":
        qh, ql = _split_hilo(qs)
        sem_cols = torch.cat([qh, qh, ql], dim=1)
    else:  # fast
        sem_cols = qs.to(torch.bfloat16)
    return _pad_cols(torch.cat([sem_cols, geo_cols], dim=1), cat_d)


def pack_bank(keys_sem: torch.Tensor, xyz: torch.Tensor,
              tier: str = "exact") -> torch.Tensor:
    """Packed key matrix [N, cat_d]."""
    k = keys_sem.to(torch.float32)
    x = xyz.to(torch.float32)
    _, cat_d = packed_dims(keys_sem.shape[1], tier)
    if tier == "exact":
        return _pad_cols(torch.cat([k, x], dim=1), cat_d)
    xh, xl = _split_hilo(x)
    geo_cols = torch.cat([xh, xl, xh], dim=1)
    if tier == "high":
        kh, kl = _split_hilo(k)
        sem_cols = torch.cat([kh, kl, kh], dim=1)
    else:  # fast
        sem_cols = k.to(torch.bfloat16)
    return _pad_cols(torch.cat([sem_cols, geo_cols], dim=1), cat_d)


def _serving_values(values: torch.Tensor) -> torch.Tensor:
    """The kernel always streams bf16 values, as the compiled TPU kernel
    does (`retrieval_pallas.py:629-638`); the weighted average smooths the
    value rounding to < 1%.  On the CPU the plain version keeps the stored
    dtype, as the JAX package's interpret mode does."""
    if values.device.type == "cpu" or values.dtype == torch.bfloat16:
        return values
    return values.to(torch.bfloat16)


def _retrieve_fused_plain(q_cat, k_cat, values, mask_neg, beta: float,
                          scale=None, *, sem_d: int,
                          chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the fused kernels: the same unnormalized
    exp2 sums over bank chunks of ``chunk`` rows.  bf16 operands are upcast
    to f32 before every matmul (the f32 accumulation of the kernel).  With
    ``scale`` [1, N] (int8 values, `_fused_kernel_i8`,
    `retrieval_pallas.py:181-227`) each weight is multiplied by its row's
    scale before the bf16 cast of the value products; the sums d take the
    unscaled weights."""
    f32 = torch.float32
    q = q_cat.to(f32)
    B, N, Dv = q.shape[0], k_cat.shape[0], values.shape[1]
    acc_s = torch.zeros((B, Dv), dtype=f32, device=q.device)
    acc_g = torch.zeros_like(acc_s)
    d_s = torch.zeros((B, 1), dtype=f32, device=q.device)
    d_g = torch.zeros_like(d_s)
    for lo in range(0, N, chunk):
        rows = slice(lo, lo + chunk)
        k = k_cat[rows].to(f32)
        m = mask_neg[:, rows]
        v = values[rows]
        p_s = torch.exp2(torch.clamp_max(q[:, :sem_d] @ k[:, :sem_d].T + m,
                                         CLAMP2))
        p_g = torch.exp2(torch.clamp_max(q[:, sem_d:] @ k[:, sem_d:].T + m,
                                         CLAMP2))
        d_s += p_s.sum(dim=-1, keepdim=True)
        d_g += p_g.sum(dim=-1, keepdim=True)
        if scale is not None:
            s = scale[:, rows].to(f32)
            p_s, p_g = p_s * s, p_g * s
        wdt = torch.bfloat16 if scale is not None else v.dtype
        acc_s += p_s.to(wdt).to(f32) @ v.to(f32)
        acc_g += p_g.to(wdt).to(f32) @ v.to(f32)
    sem = acc_s / torch.clamp_min(d_s, 1e-30)
    geo = acc_g / torch.clamp_min(d_g, 1e-30)
    return beta * sem + (1.0 - beta) * geo


# geo columns the kernel reads: 9 (3 for 'exact') real ones, rounded up to
# one 16-deep MMA step; the rest of the block is zero padding.
_GEO_D = 16


def _check_fused(name: str, q_cat, k_cat, values, mask_neg, sem_d: int):
    """Raise unless the packed operands are what the fused kernels take."""
    B, cat_d = q_cat.shape
    N, Dv = values.shape
    if q_cat.dtype not in (torch.bfloat16, torch.float32) \
            or k_cat.dtype != q_cat.dtype:
        raise ValueError(f"{name}: q_cat and k_cat must both be bf16 "
                         f"or both f32, got {q_cat.dtype}, {k_cat.dtype}")
    if mask_neg.dtype != torch.float32:
        raise ValueError(f"{name} kernel: needs an f32 mask, got "
                         f"{mask_neg.dtype}")
    if k_cat.shape != (N, cat_d) or mask_neg.shape != (1, N):
        raise ValueError(
            f"{name}: shapes q {tuple(q_cat.shape)}, k "
            f"{tuple(k_cat.shape)}, values {tuple(values.shape)}, mask "
            f"{tuple(mask_neg.shape)} do not match")
    dv_step = 16 if values.dtype == torch.int8 else 8  # 16-byte copies
    if sem_d % 16 or cat_d % 8 or Dv % dv_step or sem_d + _GEO_D > cat_d:
        raise ValueError(
            f"{name} kernel: needs sem_d % 16 == 0, cat_d % 8 == 0, "
            f"Dv % {dv_step} == 0, sem_d + 16 <= cat_d; got sem_d={sem_d}, "
            f"cat_d={cat_d}, Dv={Dv}")


def retrieve_fused(q_cat: torch.Tensor, k_cat: torch.Tensor,
                   values: torch.Tensor, mask_neg: torch.Tensor, beta: float,
                   scale: Optional[torch.Tensor] = None, *,
                   sem_d: int) -> torch.Tensor:
    """Fused single-pass retrieval over packed operands.

    Args:
      q_cat: [B, D] packed queries (pack_queries), bf16 or f32.
      k_cat: [N, D] packed keys (pack_bank), same dtype.
      values: [N, Dv] (bf16 on the kernel); int8 codes when ``scale`` is
        given.
      mask_neg: [1, N] f32 additive logit mask (0 valid / -1e30 pad).
      beta: blend weight (1 => semantic path only = RANGE).
      scale: optional [1, N] f32 per-row dequantization scales
        (`bank.quantize_values`): selects the int8-value kernel,
        `retrieve_fused_i8`.
      sem_d: column split between the semantic and geo logit groups.
    Returns: [B, Dv] f32.

    CPU tensors: `_retrieve_fused_plain`.  CUDA tensors: the hand-written
    kernel (`csrc/fused_retrieval.cu`), which replaces `_fused_kernel` of
    `range_tpu/ops/retrieval_pallas.py:123`; a launch failure raises.
    ``retrieve_fused.launches`` counts its launches."""
    if scale is not None:
        return retrieve_fused_i8(q_cat, k_cat, values, scale, mask_neg, beta,
                                 sem_d=sem_d)
    if q_cat.device.type == "cpu":
        return _retrieve_fused_plain(q_cat, k_cat, values, mask_neg, beta,
                                     sem_d=sem_d)
    if q_cat.device.type != "cuda":
        raise ValueError(f"retrieve_fused: unsupported device {q_cat.device}")
    if values.dtype != torch.bfloat16:
        raise ValueError("retrieve_fused kernel: needs bf16 values, got "
                         f"{values.dtype}")
    _check_fused("retrieve_fused", q_cat, k_cat, values, mask_neg, sem_d)
    out = _launch_fused("fused_retrieval_launch", q_cat, k_cat, values, None,
                        mask_neg, beta, sem_d)
    if q_cat.shape[0]:
        retrieve_fused.launches += 1
    return out


retrieve_fused.launches = 0


def retrieve_fused_i8(q_cat: torch.Tensor, k_cat: torch.Tensor,
                      values: torch.Tensor, scale: torch.Tensor,
                      mask_neg: torch.Tensor, beta: float, *,
                      sem_d: int) -> torch.Tensor:
    """`retrieve_fused` over int8 values [N, Dv] with per-row f32 scales
    [1, N]: each weight times its row's scale goes to bf16 for the value
    products, the sums take the unscaled weights.

    CPU tensors: `_retrieve_fused_plain` with the scale.  CUDA tensors:
    `csrc/fused_retrieval.cu` (fused_retrieval_i8_launch), which replaces
    `_fused_kernel_i8` of `range_tpu/ops/retrieval_pallas.py:181`; a
    launch failure raises.  ``retrieve_fused_i8.launches`` counts its
    launches."""
    if q_cat.device.type == "cpu":
        return _retrieve_fused_plain(q_cat, k_cat, values, mask_neg, beta,
                                     scale, sem_d=sem_d)
    if q_cat.device.type != "cuda":
        raise ValueError(f"retrieve_fused_i8: unsupported device {q_cat.device}")
    if values.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (1, values.shape[0]):
        raise ValueError(
            "retrieve_fused_i8 kernel: needs int8 values and [1, N] f32 "
            f"scales, got {values.dtype} {tuple(values.shape)}, {scale.dtype} "
            f"{tuple(scale.shape)}")
    _check_fused("retrieve_fused_i8", q_cat, k_cat, values, mask_neg, sem_d)
    out = _launch_fused("fused_retrieval_i8_launch", q_cat, k_cat, values,
                        scale, mask_neg, beta, sem_d)
    if q_cat.shape[0]:
        retrieve_fused_i8.launches += 1
    return out


retrieve_fused_i8.launches = 0


def _launch_fused(entry: str, q_cat, k_cat, values, scale, mask_neg,
                  beta: float, sem_d: int) -> torch.Tensor:
    """Launch one entry point of `csrc/fused_retrieval.cu`: [B, Dv] f32."""
    B, cat_d = q_cat.shape
    N, Dv = values.shape
    ops = [q_cat, k_cat, values] + ([] if scale is None else [scale]) \
        + [mask_neg]
    ops = [t.contiguous() for t in ops]
    out = torch.empty((B, Dv), dtype=torch.float32, device=q_cat.device)
    if B == 0:
        return out
    from ..kernels._build import load_kernel_library

    lib = load_kernel_library("fused_retrieval")
    rc = getattr(lib, entry)(
        *[t.data_ptr() for t in ops], out.data_ptr(), B, N, cat_d, sem_d,
        _GEO_D, Dv, ctypes.c_float(beta), int(q_cat.dtype == torch.float32),
        torch.cuda.current_stream(q_cat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_retrieval kernel launch failed: CUDA error {rc}")
    return out


def retrieve_pallas(q_sem: torch.Tensor, q_xyz, bank, *,
                    sem_temp: float = 12.0, geo_temp: float = 40.0,
                    beta: float = 0.5, mode: str = "range+",
                    tier: str = "fast") -> torch.Tensor:
    """Drop-in fused equivalent of `ops.retrieval.retrieve`, under the JAX
    package's name (`retrieval_pallas.py:808`) so that callers match.
    Banks with int8 values (`bank.quantize_values`) take the int8-value
    kernel with their scales (`retrieval_pallas.py:828-836`).  The
    TPU tiling arguments (bm, bn, pick_bn, interpret) have no counterpart:
    the CUDA kernel picks its own tiles and masks ragged edges itself."""
    if mode == "range":
        beta = 1.0
        q_xyz = None
    q_cat = pack_queries(q_sem, q_xyz, sem_temp, geo_temp, tier=tier)
    k_cat = pack_bank(bank.keys_sem, bank.xyz, tier=tier)
    sem_d, _ = packed_dims(bank.key_dim, tier)
    mask_neg = (NEG * (1.0 - bank.row_mask()))[None, :].to(torch.float32)
    values = (bank.values if bank.value_scale is not None  # int8 codes as they are
              else _serving_values(bank.values))
    return retrieve_fused(q_cat, k_cat, values, mask_neg, float(beta),
                          bank.value_scale, sem_d=sem_d)
