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

`swizzle128` lays tiles out as the Hopper kernels' bulk copies land them.
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
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device, t._version)


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
