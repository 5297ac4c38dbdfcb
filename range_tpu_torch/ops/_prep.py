"""Operands prepared once from weights, for the kernels that read them.

A kernel wrapper that lays weights out for its kernel (folded, cast,
split, swizzled into the tiles the kernel copies) asks `prepared` for
them: the layout is built on the first call and reused while the source
tensors are the same objects holding the same values.  A source is known
by the tensor that owns its memory (a view's base: `lin.weight.T` is a new
view on every call, its base the same parameter), its data pointer, shape,
strides, dtype and version counter; an in-place update (an optimizer step,
``copy_``, ``mul_``) bumps the version, so the next call rebuilds.  Entries
hold only weak references to their sources and are dropped when one dies;
at most ``_MAX`` are kept, the oldest dropped first.

`swizzle128` lays tiles out as the Hopper kernels' bulk copies land them;
`kmajor_tf32` splits an f32 operand into the TF32 halves of the kernels
that take f32 products as three TF32 products (`csrc/tf32_sm90.cuh`), and
`tf32x3_matmul` is a plain version of those kernels' arithmetic.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict
from typing import Callable, Sequence

import torch

_MAX = 32
_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()


def _owner(t: torch.Tensor) -> torch.Tensor:
    while t._base is not None:
        t = t._base
    return t


def _stamp(t: torch.Tensor) -> tuple:
    # an inference tensor keeps no version counter (nor can it be updated
    # in place outside inference mode)
    version = -1 if t.is_inference() else t._version
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device, version)


def prepared(kind: str, sources: Sequence[torch.Tensor], build: Callable[[], object],
             extra: tuple = ()):
    """``build()``, or the value it returned for the same ``kind``,
    ``extra`` (hashable settings) and sources, unchanged since."""
    owners = [_owner(t) for t in sources]
    key = (kind, extra) + tuple(id(o) for o in owners)
    stamps = tuple(_stamp(t) for t in sources)
    hit = _CACHE.get(key)
    if hit is not None:
        refs, old, value = hit
        if old == stamps and all(r() is o for r, o in zip(refs, owners)):
            _CACHE.move_to_end(key)
            return value
    value = build()
    refs = [weakref.ref(o, lambda _, k=key: _CACHE.pop(k, None)) for o in owners]
    _CACHE[key] = (refs, stamps, value)
    _CACHE.move_to_end(key)
    while len(_CACHE) > _MAX:
        _CACHE.popitem(last=False)
    return value


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """Tiles of 128-byte rows ([..., rows, 64] bf16 or [..., rows, 32] f32)
    in the 128-byte swizzle that TMA writes and wgmma's descriptors read:
    row r's 16-byte chunk c at chunk c ^ (r % 8).  Its own inverse."""
    rows, n = t.shape[-2], t.shape[-1]
    r = torch.arange(rows, device=t.device) % 8
    perm = torch.arange(8, device=t.device)[None, :] ^ r[:, None]
    idx = perm[:, :, None].expand(*t.shape[:-2], rows, 8, n // 8)
    return torch.gather(t.reshape(*t.shape[:-1], 8, n // 8), -2, idx).reshape(t.shape)


# Within each k8 block of K, the physical column each logical column of a
# tf32 image holds: a thread's register A columns t, t + 4 are then the
# physical 2t, 2t + 1 (`csrc/tf32_sm90.cuh`)
TF32_K8 = (0, 2, 4, 6, 1, 3, 5, 7)


def tf32_k8_perm(K: int, device=None) -> torch.Tensor:
    """[K] long: logical column i of a tf32 image holds physical column
    perm[i] (`TF32_K8` within each k8 block); K a multiple of 8."""
    blk = torch.tensor(TF32_K8, device=device)
    return (torch.arange(0, K, 8, device=device)[:, None] + blk).reshape(-1)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32`: the low 13 bits of the sign-
    magnitude pattern, rounded on the magnitude, cleared."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor):
    """(hi, lo), both TF32 values: hi = rna(x), lo = rna(x - hi)."""
    hi = tf32_rna(x)
    return hi, tf32_rna(x.to(torch.float32) - hi)


def kmajor_tf32(m: torch.Tensor) -> torch.Tensor:
    """An f32 operand [..., N, K] (K-major: row n holds its K terms, K a
    multiple of 32) as the tiles a tf32 kernel copies: [..., K / 32, hi |
    lo, N, 32] f32, each k8 block's columns in `TF32_K8` order, each [N][32]
    tile in the 128-byte swizzle."""
    K = m.shape[-1]
    m = m.to(torch.float32)[..., tf32_k8_perm(K, m.device)]
    t = torch.stack(tf32_split(m), -3)  # [..., 2, N, K]
    t = t.reshape(*t.shape[:-1], K // 32, 32).movedim(-2, -4)  # [..., K/32, 2, N, 32]
    return swizzle128(t.contiguous())


def kmajor_tf32_read(t: torch.Tensor):
    """`kmajor_tf32`'s inverse: (hi, lo) [..., N, K] in logical order."""
    t = swizzle128(t).movedim(-4, -2)  # [..., 2, N, K/32, 32]
    t = t.reshape(*t.shape[:-2], -1)
    inv = torch.argsort(tf32_k8_perm(t.shape[-1], t.device))
    t = t[..., inv]
    return t.select(-3, 0), t.select(-3, 1)


def rz_add(acc: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """f32 acc + f64 inc, rounded toward zero."""
    exact = acc.double() + inc
    near = exact.to(torch.float32)
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near)


def tf32x3_matmul(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor,
                  chain: str = "chunks", acc=None, cross_first: bool = False) -> torch.Tensor:
    """a [M, K] f32 @ b [K, N] given in its TF32 halves, as the tf32 kernels
    take it: a split like b, the three products lo hi + hi lo + hi hi a k8
    step (lo lo dropped), summed ``"exact"`` in f64 (the split's error
    alone); ``"chunks"`` as the kernels sum them, each 32-deep chunk's
    twelve products in a fresh f32 fragment truncated toward zero after
    each (a pessimistic model of the tensor cores' accumulator), the
    fragments added one by one into the running sum ``acc`` (zeros by
    default) rounded to nearest; ``"rz"`` all of them in one truncated
    chain (one accumulator).  ``cross_first``: a chunk's products in the
    order of `csrc/fused_retrieval_tf32_sm90.cu`, every step's lo hi and hi
    lo, then every step's hi hi (else step by step).  K a multiple of 8; a
    last chunk may be short.  Leading batch dimensions broadcast as in
    ``@``."""
    ah, al = (x.double() for x in tf32_split(a))
    bh, bl = b_hi.double(), b_lo.double()
    K = a.shape[-1]
    shape = (*torch.broadcast_shapes(a.shape[:-2], b_hi.shape[:-2]), a.shape[-2],
             b_hi.shape[-1])
    acc = torch.zeros(shape, dtype=torch.float32, device=a.device) if acc is None else acc
    if chain == "exact":
        return (acc.double() + ah @ bh + ah @ bl + al @ bh).to(torch.float32)
    frag = torch.zeros_like(acc)
    for c0 in range(0, K, 32):
        if chain == "chunks":
            frag = torch.zeros_like(acc)
        steps = [slice(k0, k0 + 8) for k0 in range(c0, min(c0 + 32, K), 8)]
        terms = ([(x, y, ks) for ks in steps for x, y in ((al, bh), (ah, bl))]
                 + [(ah, bh, ks) for ks in steps] if cross_first else
                 [(x, y, ks) for ks in steps for x, y in ((al, bh), (ah, bl), (ah, bh))])
        for x, y, ks in terms:
            frag = rz_add(frag, x[..., ks] @ y[..., ks, :])
        if chain == "chunks":
            acc = acc + frag
    return acc + frag if chain == "rz" else acc
