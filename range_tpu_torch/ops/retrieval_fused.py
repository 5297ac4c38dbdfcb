"""Fused dense dual-softmax retrieval: packing, kernel wrappers, plain
versions, and the pruned and hybrid paths over clustered banks.

Counterpart of `range_tpu/ops/retrieval_pallas.py` (the module name differs
because the kernels here are CUDA, not Pallas).  Computes

  out = beta * softmax(ts * q_sem K_semT) V + (1-beta) * softmax(tg * q_xyz K_xyzT) V

in one pass over the bank: per bank tile, both logit families against the
packed keys plus the row mask, ``p = exp2(min(logit, 86))`` (log2(e) and the
temperatures are folded into the packed queries), the unnormalized sums
``d_s``, ``d_g`` and ``acc += p.V`` per family; then each family is divided
by its own sum (clamped at 1e-30) and the two are blended with beta.  The
logits are bounded by the temperatures for unit queries and keys, so no
running max is needed.

On the card, bf16 operands (the 'fast' and 'high' tiers) go to the Hopper
kernel `csrc/fused_retrieval_sm90.cu` (wgmma, a TMA ring, the bank rows cut
into segments whose partials a second kernel adds in a fixed order:
`_segment_plan`), with bf16 values (`retrieve_fused`), int8 value codes
and their row scales (`retrieve_fused_i8`), and in the form that leaves
one bank shard's unnormalized partials for the caller to sum across
shards (`retrieve_fused_parts`, `parallel/sharded.py`).  f32 operands (the
'exact' tier) with bf16 values go to the Hopper kernel
`csrc/fused_retrieval_tf32_sm90.cu` (the logits three TF32 products a term
on the tensor cores, the keys' split image made once a bank: `_tf32_keys`),
their int8 and partials forms to the mma.sync kernel body
`csrc/fused_retrieval.cu`, which only chip_smoke.py's same-run yardstick
launches for `retrieve_fused`'s.  That body also serves
`_family_pruned_call` (one family's softmax over a tile plan's active bank
tiles: `retrieve_pruned`) and
`retrieve_fused_hybrid` (the geo family only in flagged tiles:
`retrieve_hybrid`); the plans come from `bank/clustered.py`.

Precision tiers of the logit matmuls (`retrieval_pallas.py:19-25`):
  'exact' — f32 operands, true f32 products.
  'high'  — bf16 hi/lo split of queries and keys, 3 cross terms.
  'fast'  — plain bf16 semantic logits, hi/lo geo logits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ._prep import kmajor_tf32, kmajor_tf32_read, prepared, tf32x3_matmul

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


def packed_dims(key_dim: int, tier: str, card: bool = False) -> Tuple[int, int]:
    """(sem_cols, total_cols) for a tier; total is 128-aligned.

    ``card=True``: the card's packing, whose semantic columns are
    zero-padded to what the card's kernels read whole: a multiple of 64 at
    the bf16 tiers (the Hopper kernel's 64-column boxes), of 16 at 'exact'
    (a k16 step).  A zero column adds exactly 0 to every logit, so the
    answers are those of JAX's packing (``card=False``)."""
    if tier in ("exact", "fast"):
        sem = key_dim
    elif tier == "high":
        sem = 3 * key_dim
    else:
        raise ValueError(f"unknown precision tier {tier}")
    if card:
        sem = _round_up(sem, 16 if tier == "exact" else 64)
    # geo block: 9 hi/lo cross columns (3 for 'exact'), padded
    return sem, _round_up(sem + 9, 128)


def geo_real_cols(tier: str) -> int:
    """The geo block's real columns (the rest of its 128 are zeros): the
    9 hi/lo cross terms of `pack_bank`, 3 plain coordinates at 'exact'."""
    return 3 if tier == "exact" else 9


def _pad_cols(x: torch.Tensor, cols: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, cols - x.shape[1]))


def pack_queries(q_sem: torch.Tensor, q_xyz, sem_temp: float,
                 geo_temp: float, tier: str = "exact",
                 card: bool = False) -> torch.Tensor:
    """Packed query matrix [B, cat_d]; column semantics match `pack_bank`
    (``card``: `packed_dims`'s padded semantic columns)."""
    B = q_sem.shape[0]
    f32 = torch.float32
    qs = (sem_temp * LOG2E * q_sem).to(f32)
    g = ((geo_temp * LOG2E * q_xyz).to(f32) if q_xyz is not None
         else torch.zeros((B, 3), dtype=f32, device=q_sem.device))
    sem_d, cat_d = packed_dims(q_sem.shape[1], tier, card)
    if tier == "exact":
        return _pad_cols(torch.cat([_pad_cols(qs, sem_d), g], dim=1), cat_d)
    gh, gl = _split_hilo(g)
    geo_cols = torch.cat([gh, gh, gl], dim=1)  # pairs with [xh, xl, xh]
    if tier == "high":
        qh, ql = _split_hilo(qs)
        sem_cols = torch.cat([qh, qh, ql], dim=1)
    else:  # fast
        sem_cols = qs.to(torch.bfloat16)
    return _pad_cols(torch.cat([_pad_cols(sem_cols, sem_d), geo_cols], dim=1), cat_d)


def pack_bank(keys_sem: torch.Tensor, xyz: torch.Tensor,
              tier: str = "exact", card: bool = False) -> torch.Tensor:
    """Packed key matrix [N, cat_d] (``card``: `packed_dims`'s padded
    semantic columns)."""
    k = keys_sem.to(torch.float32)
    x = xyz.to(torch.float32)
    sem_d, cat_d = packed_dims(keys_sem.shape[1], tier, card)
    if tier == "exact":
        return _pad_cols(torch.cat([_pad_cols(k, sem_d), x], dim=1), cat_d)
    xh, xl = _split_hilo(x)
    geo_cols = torch.cat([xh, xl, xh], dim=1)
    if tier == "high":
        kh, kl = _split_hilo(k)
        sem_cols = torch.cat([kh, kl, kh], dim=1)
    else:  # fast
        sem_cols = k.to(torch.bfloat16)
    return _pad_cols(torch.cat([_pad_cols(sem_cols, sem_d), geo_cols], dim=1), cat_d)


def _serving_values(values: torch.Tensor) -> torch.Tensor:
    """The kernel always streams bf16 values, as the compiled TPU kernel
    does (`retrieval_pallas.py:629-638`); the weighted average smooths the
    value rounding to < 1%.  On the CPU the plain version keeps the stored
    dtype, as the JAX package's interpret mode does."""
    if values.device.type == "cpu" or values.dtype == torch.bfloat16:
        return values
    return values.to(torch.bfloat16)


def _fused_sums(q_cat, k_cat, values, mask_neg, scale=None, *, sem_d: int,
                chunk: int = 8192, geo_gate=None):
    """The fused kernels' unnormalized sums in plain PyTorch: (acc_s [B, Dv],
    acc_g, d_s [B, 1], d_g) over bank chunks of ``chunk`` rows.  bf16
    operands are upcast to f32 before every matmul (the f32 accumulation
    of the kernel).  With ``scale`` [1, N] (int8 values,
    `retrieval_pallas.py:181-227`) each weight is multiplied by its row's
    scale before the bf16 cast of the value products; the sums d take the
    unscaled weights.  ``geo_gate`` = (flags [B, T] f32 {0, 1}, bn) zeroes
    the geo weights of bank tile j for the rows whose flag j is 0 (kernel
    7's skipped tiles)."""
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
        if geo_gate is not None:
            flags, bn = geo_gate
            tiles = torch.arange(lo, lo + k.shape[0], device=q.device) // bn
            p_g = p_g * flags[:, tiles]
        d_s += p_s.sum(dim=-1, keepdim=True)
        d_g += p_g.sum(dim=-1, keepdim=True)
        if scale is not None:
            s = scale[:, rows].to(f32)
            p_s, p_g = p_s * s, p_g * s
        wdt = torch.bfloat16 if scale is not None else v.dtype
        acc_s += p_s.to(wdt).to(f32) @ v.to(f32)
        acc_g += p_g.to(wdt).to(f32) @ v.to(f32)
    return acc_s, acc_g, d_s, d_g


def _normalize_blend(acc_s, acc_g, d_s, d_g, beta: float) -> torch.Tensor:
    sem = acc_s / torch.clamp_min(d_s, 1e-30)
    geo = acc_g / torch.clamp_min(d_g, 1e-30)
    return beta * sem + (1.0 - beta) * geo


def _retrieve_fused_plain(q_cat, k_cat, values, mask_neg, beta: float,
                          scale=None, *, sem_d: int,
                          chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the fused kernels (2, and 3 with
    ``scale``): `_fused_sums`, each family divided by its own sum, blended
    with beta."""
    return _normalize_blend(*_fused_sums(q_cat, k_cat, values, mask_neg,
                                         scale, sem_d=sem_d, chunk=chunk),
                            beta)


# the partials' pad columns: [sem_acc | geo_acc | d_s | d_g | 0 ...], 2 Dv +
# 128 wide, as the TPU kernel's lane-aligned block (`retrieval_pallas.py:420`)
PARTS_PAD = 128


def _parts_cat(acc_s, acc_g, d_s, d_g) -> torch.Tensor:
    """The sums laid out as the parts kernel's output: [acc_s | acc_g | d_s
    | d_g | zeros], [B, 2 Dv + 128] f32."""
    pad = torch.zeros((acc_s.shape[0], PARTS_PAD - 2), dtype=torch.float32,
                      device=acc_s.device)
    return torch.cat([acc_s, acc_g, d_s, d_g, pad], dim=1)


def _fused_segments_plain(q_cat, k_cat, values, mask_neg, beta: float,
                          scale=None, *, sem_d: int, seg_rows: int,
                          parts: bool = False) -> torch.Tensor:
    """Plain version of the Hopper kernel's segmented forms: `_fused_sums`
    (int8 values with ``scale``) over each segment of ``seg_rows`` bank rows
    (the last one ragged), the segments' partials added in segment order as
    `segment_reduce_kernel` / `parts_reduce_kernel` add them, then each
    family divided by its own sum and blended, or (``parts``: kernel 5)
    laid out as `_parts_cat`."""
    total = None
    for lo in range(0, max(k_cat.shape[0], 1), seg_rows):
        rows = slice(lo, lo + seg_rows)
        part = _fused_sums(q_cat, k_cat[rows], values[rows], mask_neg[:, rows],
                           None if scale is None else scale[:, rows],
                           sem_d=sem_d)
        total = part if total is None else tuple(
            a + b for a, b in zip(total, part))
    return _parts_cat(*total) if parts else _normalize_blend(*total, beta)


def _retrieve_fused_parts_plain(q_cat, k_cat, values, mask_neg, scale=None,
                                *, sem_d: int,
                                chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the parts kernel (5): `_fused_sums` laid
    out as [acc_s | acc_g | d_s | d_g | zeros], [B, 2 Dv + 128] f32."""
    return _parts_cat(*_fused_sums(q_cat, k_cat, values, mask_neg, scale,
                                   sem_d=sem_d, chunk=chunk))


def _retrieve_fused_hybrid_plain(q_cat, k_cat, values, mask_neg, beta: float,
                                 geo_flags, *, sem_d: int, bm: int, bn: int,
                                 chunk: int = 8192) -> torch.Tensor:
    """Plain PyTorch version of the hybrid kernel (7): the dense semantic
    family, the geo family only in the (query tile of ``bm`` rows, bank
    tile of ``bn`` rows) pairs that ``geo_flags`` [nB, T] marks; a query
    tile with no flagged tile ends with geo = 0."""
    B = q_cat.shape[0]
    rows = torch.arange(B, device=q_cat.device) // bm
    flags = (geo_flags[rows] > 0).to(torch.float32)  # [B, T]
    return _normalize_blend(*_fused_sums(
        q_cat, k_cat, values, mask_neg, sem_d=sem_d, chunk=chunk,
        geo_gate=(flags, bn)), beta)


def _family_pruned_plain(q_fam, k_fam, values, mask_neg, tile_idx,
                         tile_counts, scale=None, *, bm: int,
                         bn: int) -> torch.Tensor:
    """Plain PyTorch version of the pruned kernel (6): per query tile i of
    ``bm`` rows, the softmax of ``q_fam k_fam^T`` over the rows of bank
    tiles ``tile_idx[i, :tile_counts[i]]`` (``bn`` rows each), weighting
    the values; [B, Dv] f32.  int8 values with ``scale`` as
    `_fused_sums`."""
    f32 = torch.float32
    B, Dv = q_fam.shape[0], values.shape[1]
    q = q_fam.to(f32)
    out = torch.zeros((B, Dv), dtype=f32, device=q.device)
    idx, counts = tile_idx.tolist(), tile_counts.tolist()
    offs = torch.arange(bn, device=q.device)
    for i, (tiles, c) in enumerate(zip(idx, counts)):
        qr = slice(i * bm, min((i + 1) * bm, B))
        rows = (torch.as_tensor(tiles[:c], device=q.device)[:, None] * bn
                + offs).reshape(-1)
        p = torch.exp2(torch.clamp_max(
            q[qr] @ k_fam[rows].to(f32).T + mask_neg[:, rows], CLAMP2))
        d = p.sum(dim=-1, keepdim=True)
        v = values[rows]
        if scale is not None:
            p = p * scale[:, rows].to(f32)
        wdt = torch.bfloat16 if scale is not None else v.dtype
        out[qr] = (p.to(wdt).to(f32) @ v.to(f32)) / torch.clamp_min(d, 1e-30)
    return out


# geo columns the kernel reads: 9 (3 for 'exact') real ones, rounded up to
# one 16-deep MMA step; the rest of the block is zero padding.
_GEO_D = 16

# ---- the plan of the Hopper kernel (csrc/fused_retrieval_sm90.cu)

# the H100's SMs: a request is cut into at least this many blocks
SM90_SMS = 132
# the longest run of bank rows that one block sums through the tensor
# cores' accumulator, which truncates at every k16 step, so its drift grows
# with the run (chip_smoke.py prints the drift of each run length)
SEG_ROWS_MAX = 12_800
_SM90_MAX_SMEM = 232_448
# the flat form's instances (`fused_sm90_launch`): (bank rows a tile, value
# columns a block, key stages, 64-column key boxes, built for int8 codes
# too): 'fast' and 'high'
_SM90_FLAT = ((64, 256, 3, 4, True), (32, 128, 2, 12, False))
# int8 codes: half tiles in the kernel's ring (`S8`)
_CODE_STAGES = 2


class SegmentPlan(NamedTuple):
    """How the Hopper kernel cuts a request: ``bn`` bank rows a tile,
    ``dvs`` value columns a block, clusters of ``cs`` blocks sharing each
    tile's logits (0: the flat form), ``stages`` tiles in the ring, and
    ``n_seg`` segments of ``seg_rows`` bank rows (the last one ragged),
    one block (or cluster) each."""
    bn: int
    dvs: int
    cs: int
    stages: int
    n_seg: int
    seg_rows: int


def _sm90_smem(sem_d: int, bn: int, dvs: int, cs: int = 0, stages: int = 2,
               i8: bool = False) -> int:
    """One block's shared memory (`layout` / `clayout` in the kernel's
    source): the query block, the rings' stages (flat: ``stages`` key
    tiles with their geo keys and mask, two value tiles; cluster:
    ``stages`` of keys, values, geo keys, mask and the bf16 p of both
    families), with int8 codes (``i8``) the row scales beside the mask and
    a ring of half tiles of codes, the barriers."""
    kb, r = sem_d // 64, _round_up
    query = r(kb * 64 * 128 + 64 * 32, 1024)
    s8 = _CODE_STAGES if i8 else 0
    if cs == 0:  # `stages` key tiles, two value tiles
        keys = r(kb * bn * 128 + bn * 32 + bn * 4 * (2 if i8 else 1), 1024)
        return (query + stages * keys + 2 * (dvs // 64) * bn * 128 + s8 * bn // 2 * dvs
                + 8 * (1 + 2 * stages + 4 + 2 * s8) + 1024)
    qr = bn // cs
    stage = ((dvs // 64) * bn * 128 + kb * qr * 128 + 2 * (bn // 16) * 2048
             + qr * 32 + (r(qr * 4, 128) + r(qr * 4, 16) if i8 else r(qr * 4, 16)))
    return (query + stages * r(stage, 1024) + s8 * bn // 2 * dvs
            + 8 * (17 + (4 + 2 * s8 if i8 else 0)) + cs * 2 * 64 * 4 + 1024)


def _segment_plan(B: int, N: int, Dv: int, sem_d: int,
                  seg_rows_max: int = SEG_ROWS_MAX,
                  form: Optional[str] = None, i8: bool = False) -> SegmentPlan:
    """The kernel's form and tiles, then its segments.

    Forms: "flat" (every block computes all of each tile's logits for its
    value slice and keeps p in registers; 64-row tiles, 256-column slices
    and 3 key stages at sem_d 256, 32, 128 and 2 at sem_d 768) and
    "cluster" (the blocks of one query block's slices, 4 where they divide
    by 4, else 2 or 1, share each tile's logits through distributed shared
    memory; 64-row tiles, 256- or 128-column slices, up to 3 ring stages).
    By default the flat form where it has 64 x 256 tiles (the 'fast'
    tier), else the cluster form (the 'high' tier, three times the key
    columns): the faster one of each on the H100 (PERF.md).
    ``form`` forces one, to time the other (chip_smoke.py).  ``i8``: the
    forms built for int8 value codes (no flat 'high' instance), sized with
    their half tiles of codes; at sem_d 256 they are bf16's.

    Segments: at least enough that no block sums more than
    ``seg_rows_max`` rows, and that the request gives the card's SM90_SMS
    SMs a block each where the bank has the tiles; each segment whole
    tiles.  A function of (B, N, Dv, sem_d, i8) alone, so a request always
    gets the same answer, and a bank shard of a (1, 1) mesh is cut as one
    card cuts the bank."""
    if sem_d <= 0 or sem_d % 64:
        raise ValueError(f"fused_sm90 kernel: needs sem_d % 64 == 0, got {sem_d}")
    # the flat form's tiles, built for the key boxes of one tier each
    flat = [(bn, dvs, 0, st) for bn, dvs, st, kb, codes in _SM90_FLAT
            if kb == sem_d // 64 and (codes or not i8)]
    cluster = [(64, dvs, next(c for c in (4, 2, 1) if -(-Dv // dvs) % c == 0), st)
               for dvs in (256, 128) for st in (3, 2)]
    options = {None: [o for o in flat if o[1] == 256] + cluster, "flat": flat,
               "cluster": cluster}[form]
    fits = [o for o in options if _sm90_smem(sem_d, *o, i8=i8) <= _SM90_MAX_SMEM]
    if not fits:
        raise ValueError(f"fused_sm90 kernel: no {form or 'default'} form for "
                         f"sem_d={sem_d} fits in a block's shared memory")
    bn, dvs, cs, stages = fits[0]
    tiles = max(1, -(-N // bn))
    blocks = -(-B // 64) * -(-Dv // dvs)
    n_seg = min(tiles, max(-(-N // seg_rows_max), -(-SM90_SMS // max(blocks, 1)),
                           1))
    seg_rows = tiles // n_seg * bn  # rounding down keeps both needs met
    return SegmentPlan(bn, dvs, cs, stages, max(1, -(-N // seg_rows)), seg_rows)


def _aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` contiguous, its data on 16 bytes (TMA's rule)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_sm90(q_cat, k_cat, values, mask_neg, beta: float, sem_d: int,
                 plan: Optional[SegmentPlan] = None, scale=None,
                 parts: bool = False) -> torch.Tensor:
    """Launch `csrc/fused_retrieval_sm90.cu` (and its segment reduction)
    on bf16 operands: [B, Dv] f32, or with ``parts`` kernel 5's partials
    [B, 2 Dv + 128]; int8 ``values`` with ``scale`` [1, N].  ``plan``
    defaults to `_segment_plan`."""
    B, cat_d = q_cat.shape
    N, Dv = values.shape
    i8 = scale is not None
    if q_cat.dtype != torch.bfloat16 or Dv % (16 if i8 else 8):
        raise ValueError(f"fused_sm90 kernel: needs bf16 operands and Dv % 8 "
                         f"== 0 (int8: % 16), got {q_cat.dtype}, Dv={Dv}")
    plan = plan or _segment_plan(B, N, Dv, sem_d, i8=i8)
    ops = [_aligned16(t) for t in (q_cat, k_cat, values)]
    ops += [None if scale is None else _aligned16(scale), _aligned16(mask_neg)]
    out = torch.empty((B, 2 * Dv + PARTS_PAD if parts else Dv), dtype=torch.float32,
                      device=q_cat.device)
    if B == 0:
        return out
    work = (torch.empty((plan.n_seg, B, 2 * Dv + 2), dtype=torch.float32,
                        device=q_cat.device) if plan.n_seg > 1 else None)
    from ..kernels._build import load_kernel_library

    rc = load_kernel_library("fused_retrieval_sm90").fused_sm90_launch(
        *[None if t is None else t.data_ptr() for t in ops], out.data_ptr(),
        None if work is None else work.data_ptr(), B, N, cat_d, sem_d, Dv,
        ctypes.c_float(beta), plan.bn, plan.dvs, plan.cs, plan.stages,
        plan.seg_rows, plan.n_seg, int(parts), _stream(q_cat))
    _raise_on(rc, "fused_sm90")
    return out


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


def _check_values(name: str, values, scale) -> None:
    """Raise unless the values are what the kernel streams: bf16, or int8
    codes with [1, N] f32 scales."""
    if scale is None:
        if values.dtype != torch.bfloat16:
            raise ValueError(f"{name} kernel: needs bf16 values, got "
                             f"{values.dtype}")
    elif values.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.shape != (1, values.shape[0]):
        raise ValueError(
            f"{name} kernel: needs int8 values and [1, N] f32 scales, got "
            f"{values.dtype} {tuple(values.shape)}, {scale.dtype} "
            f"{tuple(scale.shape)}")


def _check_cuda(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")


def _check_plan(name: str, B: int, N: int, bm: int, bn: int, plan,
                on_card: bool) -> None:
    """Raise unless ``plan`` ([nB, T] int32 per query tile and bank tile)
    matches B queries in tiles of bm and N rows in tiles of bn; the kernels
    also need bm % 16 == 0 (whole m16 row groups) and bn % 32 == 0 (whole
    32-row sub-tiles)."""
    nB = -(-B // bm)
    if N % bn or tuple(plan.shape) != (nB, N // bn):
        raise ValueError(f"{name}: a plan {tuple(plan.shape)} for {B} queries "
                         f"in tiles of {bm} and {N} rows in tiles of {bn} "
                         f"(needs N % bn == 0 and [{nB}, {N // max(bn, 1)}])")
    if on_card and (bm % 16 or bn % 32 or bm <= 0 or bn <= 0):
        raise ValueError(f"{name} kernel: needs bm % 16 == 0 and bn % 32 == "
                         f"0, got bm={bm}, bn={bn}")


def _lib():
    from ..kernels._build import load_kernel_library

    return load_kernel_library("fused_retrieval")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


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
    kernels that replace `_fused_kernel` of
    `range_tpu/ops/retrieval_pallas.py:123`: bf16 operands ('fast',
    'high') the Hopper kernel `csrc/fused_retrieval_sm90.cu` over
    `_segment_plan`'s segments (sem_d % 64 == 0: `_packed` pads the
    semantic columns on the card), f32 operands ('exact') the Hopper
    kernel `csrc/fused_retrieval_tf32_sm90.cu` (`_launch_tf32`: the logits
    three TF32 products a term, over `_tf32_plan`'s segments; sem_d % 16
    == 0).  A shape either kernel does not take or a failed launch raises.
    ``retrieve_fused.launches`` counts the bf16 kernel's launches,
    ``.tf32_launches`` the f32 one's; ``.exact_launches`` the mma.sync
    body's f32 form (`_launch_fused`), which no wrapper launches here."""
    if scale is not None:
        return retrieve_fused_i8(q_cat, k_cat, values, scale, mask_neg, beta,
                                 sem_d=sem_d)
    if q_cat.device.type == "cpu":
        return _retrieve_fused_plain(q_cat, k_cat, values, mask_neg, beta,
                                     sem_d=sem_d)
    _check_cuda("retrieve_fused", q_cat)
    _check_values("retrieve_fused", values, None)
    _check_fused("retrieve_fused", q_cat, k_cat, values, mask_neg, sem_d)
    if q_cat.dtype == torch.float32:
        out = _launch_tf32(q_cat, k_cat, values, mask_neg, beta, sem_d)
        if q_cat.shape[0]:
            retrieve_fused.tf32_launches += 1
        return out
    out = _launch_sm90(q_cat, k_cat, values, mask_neg, beta, sem_d)
    if q_cat.shape[0]:
        retrieve_fused.launches += 1
    return out


retrieve_fused.launches = 0
retrieve_fused.tf32_launches = 0
retrieve_fused.exact_launches = 0


# ---- kernel 2 at f32 operands on the tensor cores
# (csrc/fused_retrieval_tf32_sm90.cu)

_TF32_DVS = 256   # value columns of a block
_TF32_KCMAX = 48  # 32-column chunks of the semantic logits it takes
# the longest run of bank rows one block's value chain sums: with the TF32 x3
# logits' own error, 12,800-row chains (the bf16 kernel's) put RANGE at
# B = 1,000 past the dense bars on the H100 (chip_smoke.py prints the drift
# of each chain length)
TF32_SEG_ROWS_MAX = 3_200


def _tf32_keys(k_cat: torch.Tensor, sem_d: int) -> torch.Tensor:
    """The keys' split image, once per bank (`_prep.prepared`): each
    64-row tile's semantic columns [0, sem_d) in KC = ceil(sem_d / 32)
    chunks of 32, then the geo block's 16 columns from sem_d in one more,
    as `_prep.kmajor_tf32` lays them out: [ceil(N / 64), KC + 1, 2, 64, 32]
    f32, zero past N and past the columns."""
    @torch.no_grad()
    def build():
        N, KC = k_cat.shape[0], -(-sem_d // 32)
        T = max(1, -(-N // 64))
        k = torch.zeros(T * 64, 32 * (KC + 1), dtype=torch.float32, device=k_cat.device)
        k[:N, :sem_d] = k_cat[:, :sem_d]
        k[:N, 32 * KC:32 * KC + _GEO_D] = k_cat[:, sem_d:sem_d + _GEO_D]
        return kmajor_tf32(k.reshape(T, 64, -1))

    return prepared("fused_tf32_keys", [k_cat], build, (sem_d,))


def _tf32_plan(B: int, N: int, Dv: int,
               seg_rows_max: int = TF32_SEG_ROWS_MAX) -> Tuple[int, int]:
    """(n_seg, seg_rows) of a request: 64-row tiles cut into segments of
    whole tiles, at least enough that no block sums more than
    ``seg_rows_max`` rows and that the request gives the card's SM90_SMS SMs
    a block each where the bank has the tiles (`_segment_plan`'s rule at the
    kernel's blocks of 64 queries and 256 value columns)."""
    tiles = max(1, -(-N // 64))
    blocks = -(-B // 64) * -(-Dv // _TF32_DVS)
    n_seg = min(tiles, max(-(-N // seg_rows_max), -(-SM90_SMS // max(blocks, 1)), 1))
    seg_rows = tiles // n_seg * 64
    return max(1, -(-N // seg_rows)), seg_rows


def _launch_tf32(q_cat, k_cat, values, mask_neg, beta: float, sem_d: int,
                 plan: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Launch `csrc/fused_retrieval_tf32_sm90.cu` (and its segment
    reduction) on f32 packed operands and bf16 values: [B, Dv] f32.
    ``plan`` (n_seg, seg_rows) defaults to `_tf32_plan`'s."""
    B, cat_d = q_cat.shape
    N, Dv = values.shape
    KC = -(-sem_d // 32)
    if values.dtype != torch.bfloat16 or KC > _TF32_KCMAX:
        raise ValueError(f"fused_tf32 kernel: needs bf16 values and sem_d <= "
                         f"{32 * _TF32_KCMAX}, got {values.dtype}, sem_d={sem_d}")
    out = torch.empty((B, Dv), dtype=torch.float32, device=q_cat.device)
    if B == 0:
        return out
    n_seg, seg_rows = plan or _tf32_plan(B, N, Dv)
    kimg = _tf32_keys(k_cat, sem_d)
    q, v, m = q_cat.contiguous(), _aligned16(values), _aligned16(mask_neg)
    work = (torch.empty((n_seg, B, 2 * Dv + 2), dtype=torch.float32, device=q_cat.device)
            if n_seg > 1 else None)
    ints = [B, N, cat_d, sem_d, Dv, KC, seg_rows, n_seg]
    from ..kernels._build import load_kernel_library

    rc = load_kernel_library("fused_retrieval_tf32_sm90").fused_tf32_sm90_launch(
        q.data_ptr(), kimg.data_ptr(), v.data_ptr(), m.data_ptr(), out.data_ptr(),
        None if work is None else work.data_ptr(), (ctypes.c_int * len(ints))(*ints),
        ctypes.c_float(beta), _stream(q_cat))
    _raise_on(rc, "fused_tf32")
    return out


def _fused_tf32_plain(q_cat, k_cat, values, mask_neg, beta: float, *, sem_d: int,
                      chain: str = "chunks", rows: int = 4096) -> torch.Tensor:
    """Plain version of `_launch_tf32`'s arithmetic, read from its keys'
    image (`_tf32_keys`, unswizzled and unpermuted here): per segment of
    `_tf32_plan`, the semantic logits `_prep.tf32x3_matmul` chunk by chunk
    over the image's columns (a fresh fragment each, its cross terms first,
    added in f32) and the geo logits over the geo chunk, plus the mask; p = exp2(min(l, 86)) per
    family (0 past the bank); d the sums of p, acc += bf16(p) @ V (exact
    products in f32); the segments' sums added in order, then each family
    divided by its sum and blended.  ``chain`` as `_prep.tf32x3_matmul`'s;
    ``rows`` bank rows at a time."""
    f32 = torch.float32
    B, N, Dv = q_cat.shape[0], values.shape[0], values.shape[1]
    KC = -(-sem_d // 32)
    kh, kl = kmajor_tf32_read(_tf32_keys(k_cat, sem_d))  # [T, 64, 32 (KC + 1)]
    kh, kl = (x.reshape(-1, x.shape[-1]).T for x in (kh, kl))
    qs = torch.zeros((B, 32 * KC), dtype=f32, device=q_cat.device)
    qs[:, :sem_d] = q_cat[:, :sem_d]
    qg = torch.zeros((B, 32), dtype=f32, device=q_cat.device)
    qg[:, :_GEO_D] = q_cat[:, sem_d:sem_d + _GEO_D]
    n_seg, seg_rows = _tf32_plan(B, N, Dv)
    total = None
    for s0 in range(0, max(N, 1), seg_rows):
        acc_s = torch.zeros((B, Dv), dtype=f32, device=q_cat.device)
        acc_g = torch.zeros_like(acc_s)
        d_s = torch.zeros((B, 1), dtype=f32, device=q_cat.device)
        d_g = torch.zeros_like(d_s)
        for lo in range(s0, min(s0 + seg_rows, N), rows):
            hi = min(lo + rows, s0 + seg_rows, N)
            r = slice(lo, hi)
            m = mask_neg[:, r].to(f32)
            ls = tf32x3_matmul(qs, kh[:32 * KC, r], kl[:32 * KC, r], chain, cross_first=True)
            lg = tf32x3_matmul(qg, kh[32 * KC:, r], kl[32 * KC:, r], chain, cross_first=True)
            p_s = torch.exp2(torch.clamp_max(ls + m, CLAMP2))
            p_g = torch.exp2(torch.clamp_max(lg + m, CLAMP2))
            d_s += p_s.sum(1, keepdim=True)
            d_g += p_g.sum(1, keepdim=True)
            v = values[r].double()
            acc_s += (p_s.to(torch.bfloat16).double() @ v).to(f32)
            acc_g += (p_g.to(torch.bfloat16).double() @ v).to(f32)
        part = (acc_s, acc_g, d_s, d_g)
        total = part if total is None else tuple(a + b for a, b in zip(total, part))
    return _normalize_blend(*total, beta)


def retrieve_fused_i8(q_cat: torch.Tensor, k_cat: torch.Tensor,
                      values: torch.Tensor, scale: torch.Tensor,
                      mask_neg: torch.Tensor, beta: float, *,
                      sem_d: int) -> torch.Tensor:
    """`retrieve_fused` over int8 values [N, Dv] with per-row f32 scales
    [1, N]: each weight times its row's scale goes to bf16 for the value
    products, the sums take the unscaled weights.

    CPU tensors: `_retrieve_fused_plain` with the scale.  CUDA tensors:
    the kernels that replace `_fused_kernel_i8` of
    `range_tpu/ops/retrieval_pallas.py:181`: bf16 operands the Hopper
    kernel `csrc/fused_retrieval_sm90.cu` over `_segment_plan`'s segments
    (the codes streamed and converted in shared memory), f32 operands
    ('exact') `csrc/fused_retrieval.cu` (fused_retrieval_i8_launch).  A
    shape either does not take or a failed launch raises.
    ``retrieve_fused_i8.launches`` counts the Hopper kernel's launches,
    ``.exact_launches`` the f32 kernel's."""
    if q_cat.device.type == "cpu":
        return _retrieve_fused_plain(q_cat, k_cat, values, mask_neg, beta,
                                     scale, sem_d=sem_d)
    _check_cuda("retrieve_fused_i8", q_cat)
    _check_values("retrieve_fused_i8", values, scale)
    _check_fused("retrieve_fused_i8", q_cat, k_cat, values, mask_neg, sem_d)
    if q_cat.dtype == torch.float32:
        out = _launch_fused("fused_retrieval_i8_launch", q_cat, k_cat, values,
                            scale, mask_neg, beta, sem_d)
        if q_cat.shape[0]:
            retrieve_fused_i8.exact_launches += 1
        return out
    out = _launch_sm90(q_cat, k_cat, values, mask_neg, beta, sem_d, scale=scale)
    if q_cat.shape[0]:
        retrieve_fused_i8.launches += 1
    return out


retrieve_fused_i8.launches = 0
retrieve_fused_i8.exact_launches = 0


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
    rc = getattr(_lib(), entry)(
        *[t.data_ptr() for t in ops], out.data_ptr(), B, N, cat_d, sem_d,
        _GEO_D, Dv, ctypes.c_float(beta), int(q_cat.dtype == torch.float32),
        _stream(q_cat))
    _raise_on(rc, "fused_retrieval")
    return out


def retrieve_fused_parts(q_cat: torch.Tensor, k_cat: torch.Tensor,
                         values: torch.Tensor, mask_neg: torch.Tensor,
                         scale: Optional[torch.Tensor] = None, *,
                         sem_d: int) -> torch.Tensor:
    """Unnormalized partials of the fused retrieval over one bank shard:
    [B, 2 Dv + 128] f32 laid out [sem_acc | geo_acc | d_s | d_g | 0 ...].
    They add up across bank shards (the logits are bounded by the
    temperatures, so no running max is needed): the multi-device building
    block (`parallel/sharded.sharded_retrieve_pallas`).  Operands as
    `retrieve_fused`; int8 ``values`` with ``scale`` [1, N] stream as they
    are, the scale folded into the weights.

    CPU tensors: `_retrieve_fused_parts_plain`.  CUDA tensors: the kernels
    that replace `_fused_parts_kernel` of
    `range_tpu/ops/retrieval_pallas.py:314`: bf16 operands the Hopper
    kernel `csrc/fused_retrieval_sm90.cu` in its partials form, over
    `_segment_plan`'s segments (the shard's shape alone decides them, so a
    (1, 1) mesh adds what one card adds), f32 operands ('exact')
    `csrc/fused_retrieval.cu` (fused_parts_launch).  A shape either does
    not take or a failed launch raises.  ``retrieve_fused_parts.launches``
    counts the Hopper kernel's bf16-value launches, ``.i8_launches`` its
    int8 ones, ``.exact_launches`` the f32 kernel's (either values)."""
    if q_cat.device.type == "cpu":
        return _retrieve_fused_parts_plain(q_cat, k_cat, values, mask_neg,
                                           scale, sem_d=sem_d)
    _check_cuda("retrieve_fused_parts", q_cat)
    _check_values("retrieve_fused_parts", values, scale)
    _check_fused("retrieve_fused_parts", q_cat, k_cat, values, mask_neg, sem_d)
    B, cat_d = q_cat.shape
    N, Dv = values.shape
    if q_cat.dtype == torch.bfloat16:
        out = _launch_sm90(q_cat, k_cat, values, mask_neg, 0.0, sem_d, scale=scale,
                           parts=True)
        if B:
            if scale is None:
                retrieve_fused_parts.launches += 1
            else:
                retrieve_fused_parts.i8_launches += 1
        return out
    ops = [t.contiguous() for t in (q_cat, k_cat, values, mask_neg)]
    out = torch.empty((B, 2 * Dv + PARTS_PAD), dtype=torch.float32,
                      device=q_cat.device)
    if B == 0:
        return out
    scale = None if scale is None else scale.contiguous()
    rc = _lib().fused_parts_launch(
        ops[0].data_ptr(), ops[1].data_ptr(), ops[2].data_ptr(),
        None if scale is None else scale.data_ptr(), ops[3].data_ptr(),
        out.data_ptr(), B, N, cat_d, sem_d, _GEO_D, Dv, 1, _stream(q_cat))
    _raise_on(rc, "fused_parts")
    retrieve_fused_parts.exact_launches += 1
    return out


retrieve_fused_parts.launches = 0
retrieve_fused_parts.i8_launches = 0
retrieve_fused_parts.exact_launches = 0


def _rows16(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when its rows are unit-stride and 16-byte aligned (a
    column slice of the packed operands), else a contiguous copy."""
    es = x.element_size()
    if x.stride(1) == 1 and (x.stride(0) * es) % 16 == 0 \
            and x.data_ptr() % 16 == 0:
        return x
    return x.contiguous()


def _family_pruned_call(q_fam: torch.Tensor, k_fam: torch.Tensor,
                        values: torch.Tensor, mask_neg: torch.Tensor,
                        tile_idx: torch.Tensor, tile_counts: torch.Tensor,
                        scale: Optional[torch.Tensor] = None, *, bm: int,
                        bn: int) -> torch.Tensor:
    """One logit family's softmax-weighted values [B, Dv] f32, query tile
    i of ``bm`` rows visiting only bank tiles ``tile_idx[i, :tile_counts[i]]``
    of ``bn`` rows (`bank/clustered.compute_tile_plan`).  ``q_fam`` [B, C]
    and ``k_fam`` [N, C] are one family's packed columns (a column slice
    of `pack_queries` / `pack_bank` is taken as it is); int8 ``values``
    with ``scale`` [1, N] stream as they are.

    CPU tensors: `_family_pruned_plain`.  CUDA tensors:
    `csrc/fused_retrieval.cu` (family_pruned_launch), which replaces
    `_family_pruned_kernel` of `range_tpu/ops/retrieval_pallas.py:441`: the
    plan is read from device memory, no host sync.  A launch failure
    raises.  ``_family_pruned_call.launches`` counts its bf16 launches,
    ``.i8_launches`` its int8 ones."""
    B, C = q_fam.shape
    N, Dv = values.shape
    on_card = q_fam.device.type != "cpu"
    _check_plan("_family_pruned_call", B, N, bm, bn, tile_idx, on_card)
    if tuple(tile_counts.shape) != (tile_idx.shape[0],):
        raise ValueError(f"_family_pruned_call: counts {tuple(tile_counts.shape)} "
                         f"for {tile_idx.shape[0]} query tiles")
    if not on_card:
        return _family_pruned_plain(q_fam, k_fam, values, mask_neg, tile_idx,
                                    tile_counts, scale, bm=bm, bn=bn)
    _check_cuda("_family_pruned_call", q_fam)
    _check_values("_family_pruned_call", values, scale)
    if q_fam.dtype not in (torch.bfloat16, torch.float32) \
            or k_fam.dtype != q_fam.dtype or k_fam.shape != (N, C) \
            or mask_neg.dtype != torch.float32 or mask_neg.shape != (1, N) \
            or tile_idx.dtype != torch.int32 \
            or tile_counts.dtype != torch.int32:
        raise ValueError(
            f"_family_pruned_call kernel: q {q_fam.dtype} {tuple(q_fam.shape)}, "
            f"k {k_fam.dtype} {tuple(k_fam.shape)}, mask {mask_neg.dtype} "
            f"{tuple(mask_neg.shape)}, plan {tile_idx.dtype} / "
            f"{tile_counts.dtype}: needs bf16 or f32 q and k alike, [1, N] "
            "f32 mask, int32 plan")
    if C % 16 or C <= 0 or Dv % (16 if scale is not None else 8):
        raise ValueError(f"_family_pruned_call kernel: needs C % 16 == 0 and "
                         f"Dv % 8 (int8: 16) == 0, got C={C}, Dv={Dv}")
    q, k = _rows16(q_fam), _rows16(k_fam)
    values, mask_neg = values.contiguous(), mask_neg.contiguous()
    idx, cnt = tile_idx.contiguous(), tile_counts.contiguous()
    out = torch.empty((B, Dv), dtype=torch.float32, device=q_fam.device)
    if B == 0:
        return out
    scale = None if scale is None else scale.contiguous()
    rc = _lib().family_pruned_launch(
        q.data_ptr(), k.data_ptr(), values.data_ptr(),
        None if scale is None else scale.data_ptr(), mask_neg.data_ptr(),
        idx.data_ptr(), cnt.data_ptr(), out.data_ptr(), B, N, q.stride(0),
        k.stride(0), C, Dv, bm, bn, int(q.dtype == torch.float32),
        _stream(q))
    _raise_on(rc, "family_pruned")
    if scale is None:
        _family_pruned_call.launches += 1
    else:
        _family_pruned_call.i8_launches += 1
    return out


_family_pruned_call.launches = 0
_family_pruned_call.i8_launches = 0


def retrieve_fused_hybrid(q_cat: torch.Tensor, k_cat: torch.Tensor,
                          values: torch.Tensor, mask_neg: torch.Tensor,
                          beta: float, geo_flags: torch.Tensor, *,
                          sem_d: int, bm: int, bn: int) -> torch.Tensor:
    """`retrieve_fused` with the geo family computed only where
    ``geo_flags`` [nB, T] (int32, `bank/clustered.compute_keep_mask`) marks
    the pair (query tile of ``bm`` rows, bank tile of ``bn`` rows); the
    semantic family stays dense.  A query tile with no flagged tile gets
    geo = 0.  [B, Dv] f32.

    CPU tensors: `_retrieve_fused_hybrid_plain`.  CUDA tensors (bf16
    values): `csrc/fused_retrieval.cu` (fused_hybrid_launch), which
    replaces `_hybrid_kernel` of `range_tpu/ops/retrieval_pallas.py:660`;
    a launch failure raises.  ``retrieve_fused_hybrid.launches`` counts
    its launches."""
    B = q_cat.shape[0]
    N = values.shape[0]
    on_card = q_cat.device.type != "cpu"
    _check_plan("retrieve_fused_hybrid", B, N, bm, bn, geo_flags, on_card)
    if not on_card:
        return _retrieve_fused_hybrid_plain(q_cat, k_cat, values, mask_neg,
                                            beta, geo_flags, sem_d=sem_d,
                                            bm=bm, bn=bn)
    _check_cuda("retrieve_fused_hybrid", q_cat)
    _check_values("retrieve_fused_hybrid", values, None)
    _check_fused("retrieve_fused_hybrid", q_cat, k_cat, values, mask_neg, sem_d)
    if geo_flags.dtype != torch.int32:
        raise ValueError(f"retrieve_fused_hybrid kernel: needs int32 geo_flags, "
                         f"got {geo_flags.dtype}")
    ops = [t.contiguous() for t in (q_cat, k_cat, values, mask_neg, geo_flags)]
    out = torch.empty((B, values.shape[1]), dtype=torch.float32,
                      device=q_cat.device)
    if B == 0:
        return out
    rc = _lib().fused_hybrid_launch(
        *[t.data_ptr() for t in ops], out.data_ptr(), B, N, q_cat.shape[1],
        sem_d, _GEO_D, values.shape[1], ctypes.c_float(beta), bm, bn,
        int(q_cat.dtype == torch.float32), _stream(q_cat))
    _raise_on(rc, "fused_hybrid")
    retrieve_fused_hybrid.launches += 1
    return out


retrieve_fused_hybrid.launches = 0


def _bank_serving_values(bank) -> torch.Tensor:
    """`_serving_values` over a GeoBank; int8 codes are dequantized to bf16
    here, for the hybrid kernel, which has no scale input
    (`retrieval_pallas.py:619-626`)."""
    if bank.value_scale is not None:
        return (bank.values.to(torch.float32)
                * bank.value_scale.T).to(torch.bfloat16)
    return _serving_values(bank.values)


def _bank_keys(bank, tier: str, card: bool):
    """(k_cat, mask_neg) of ``bank``: its packed keys (`pack_bank`) and its
    row mask as an additive [1, N] f32 logit mask; on the card (``card``)
    made once per bank (`_prep.prepared`), so that the kernels' images of
    them are too."""
    def keys():
        return pack_bank(bank.keys_sem, bank.xyz, tier=tier, card=card)

    def mask():
        return (NEG * (1.0 - bank.row_mask()))[None, :].to(torch.float32)

    if not card:
        return keys(), mask()
    rows = [bank.valid_mask] if bank.valid_mask is not None else [bank.keys_sem]
    return (prepared("packed_keys", [bank.keys_sem, bank.xyz], keys, (tier,)),
            prepared("packed_mask", rows, mask, (bank.n_valid, bank.num_rows)))


def _packed(q_sem, q_xyz, bank, sem_temp: float, geo_temp: float, tier: str):
    """(q_cat, k_cat, sem_d, mask_neg) of a request over ``bank``: on the
    card the padded packing its kernels read (`packed_dims`), the keys and
    mask made once per bank (`_bank_keys`); on the CPU JAX's."""
    card = bank.keys_sem.device.type != "cpu"
    q_cat = pack_queries(q_sem, q_xyz, sem_temp, geo_temp, tier=tier, card=card)
    sem_d, _ = packed_dims(bank.key_dim, tier, card)
    k_cat, mask_neg = _bank_keys(bank, tier, card)
    return q_cat, k_cat, sem_d, mask_neg


def _geo_sorted(q_sem, q_xyz):
    """(q_sem, q_xyz, inverse permutation) with the batch in geographic
    order: the keep decision is per query tile, so spatially coherent
    tiles are what let the per-query pruning survive the OR."""
    from ..geometry import geo_sort_order

    order = geo_sort_order(q_xyz)
    return q_sem[order], q_xyz[order], torch.argsort(order)


def _check_stats(radius, bank, bn: int) -> None:
    if radius.shape[0] != bank.num_rows // bn or bank.num_rows % bn:
        raise ValueError(
            f"tile stats built for {radius.shape[0]} tiles but bn={bn} gives "
            f"{bank.num_rows / bn:g}; rebuild via cluster_bank with matching bn")


def retrieve_pruned(q_sem: torch.Tensor, q_xyz, bank, stats, *,
                    sem_temp: float = 12.0, geo_temp: float = 40.0,
                    beta: float = 0.5, mode: str = "range+",
                    tier: str = "fast", bm: int = 256, bn: int = 1024,
                    margin: float = 20.0,
                    sort_queries: bool = True) -> torch.Tensor:
    """Pruned retrieval over a clustered bank (`bank.clustered.cluster_bank`
    with ``pack='pad'`` and its `TileStats` at ``bn``;
    `retrieval_pallas.py:548-616`): each logit family runs its own pruned
    pass (kernel 6) over its own tile plan, dropping tiles whose softmax
    mass is provably under N e^-margin of the family's.  ``bm`` and ``bn``
    set the plan's granularity and so change results.  ``sort_queries``
    orders the batch geographically first and restores the order after.
    int8 banks stream their codes with the scales."""
    from ..bank.clustered import compute_tile_plan

    if mode == "range":
        q_xyz = None
        beta = 1.0
    inv = None
    if sort_queries and q_xyz is not None:
        q_sem, q_xyz, inv = _geo_sorted(q_sem, q_xyz)
    q_cat, k_cat, sem_d, mask_neg = _packed(q_sem, q_xyz, bank, sem_temp,
                                            geo_temp, tier)
    _check_stats(stats.sem_radius, bank, bn)
    if bank.value_scale is not None:
        values, scale = bank.values, bank.value_scale
    else:
        values, scale = _serving_values(bank.values), None
    idx_s, cnt_s = compute_tile_plan(q_sem, stats.sem_centroid,
                                     stats.sem_radius, temp=sem_temp, bm=bm,
                                     margin=margin)
    sem = _family_pruned_call(q_cat[:, :sem_d], k_cat[:, :sem_d], values,
                              mask_neg, idx_s, cnt_s, scale, bm=bm, bn=bn)
    if mode == "range":
        return sem
    idx_g, cnt_g = compute_tile_plan(q_xyz, stats.geo_centroid,
                                     stats.geo_radius, temp=geo_temp, bm=bm,
                                     margin=margin)
    # the geo block's real columns (9, 'exact' 3) lie in its first 16; the
    # rest are zeros in both operands and add nothing to the logits
    geo = slice(sem_d, sem_d + _GEO_D)
    geo_out = _family_pruned_call(q_cat[:, geo], k_cat[:, geo], values,
                                  mask_neg, idx_g, cnt_g, scale, bm=bm, bn=bn)
    out = beta * sem + (1.0 - beta) * geo_out
    return out if inv is None else out[inv]


def retrieve_hybrid(q_sem: torch.Tensor, q_xyz: torch.Tensor, bank, stats, *,
                    sem_temp: float = 12.0, geo_temp: float = 40.0,
                    beta: float = 0.5, tier: str = "fast", bm: int = 256,
                    bn: int = 1024, margin: float = 20.0,
                    sort_queries: bool = True) -> torch.Tensor:
    """Dense semantic family plus the geo family pruned per (query tile,
    bank tile) over a clustered bank (`retrieval_pallas.py:765-805`):
    unlike `retrieve_pruned` the key and value stream is shared by both
    families (kernel 7).  RANGE+ only; int8 banks are dequantized to bf16
    values (`_bank_serving_values`)."""
    from ..bank.clustered import compute_keep_mask

    inv = None
    if sort_queries:
        q_sem, q_xyz, inv = _geo_sorted(q_sem, q_xyz)
    q_cat, k_cat, sem_d, mask_neg = _packed(q_sem, q_xyz, bank, sem_temp,
                                            geo_temp, tier)
    _check_stats(stats.geo_radius, bank, bn)
    flags = compute_keep_mask(q_xyz, stats.geo_centroid, stats.geo_radius,
                              temp=geo_temp, bm=bm, margin=margin
                              ).to(torch.int32)
    out = retrieve_fused_hybrid(q_cat, k_cat, _bank_serving_values(bank),
                                mask_neg, float(beta), flags, sem_d=sem_d,
                                bm=bm, bn=bn)
    return out if inv is None else out[inv]


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
    q_cat, k_cat, sem_d, mask_neg = _packed(q_sem, q_xyz, bank, sem_temp,
                                            geo_temp, tier)
    values = (bank.values if bank.value_scale is not None  # int8 codes as they are
              else _serving_values(bank.values))
    return retrieve_fused(q_cat, k_cat, values, mask_neg, float(beta),
                          bank.value_scale, sem_d=sem_d)
