"""Clustered bank: geographically ordered rows, per-tile bounding balls
and the pruning plans they give.

Counterpart of `range_tpu/bank/clustered.py`.  Bank rows are reordered so
that each bn-row kernel tile is geographically coherent: geographic
k-means over the rows' xyz (seeded with a Fibonacci lattice, so no random
numbers are drawn), clusters relabeled along latitude bands, then whole
clusters packed into bn-row tiles: ``pack='pad'`` pads out a tile rather
than let a cluster straddle it (the pruned and hybrid paths' choice),
``pack='dense'`` packs them back to back (the hierarchical build's).

A tile's contribution to one softmax family is bounded through its
bounding ball (centroid c, radius r):
``max_{row in tile} t (q . k_row) <= t (q . c + r)``.  `compute_keep_mask`
keeps, per query tile, the bank tiles whose upper bound reaches within
``margin`` of some query's best lower bound; `compute_tile_plan` turns
that into the active-first tile lists the pruned kernel walks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.checkerboard import fibonacci_lattice
from ..geometry import geo_sort_order, lonlat_deg_to_xyz
from ..ops.kmeans import kmeans
from ..ops.retrieval import true_f32_matmul
from .bank import GeoBank


@dataclasses.dataclass
class TileStats:
    """Per bank tile (bn contiguous rows): bounding balls for both families."""

    sem_centroid: torch.Tensor  # [T, Dk]
    sem_radius: torch.Tensor  # [T]
    geo_centroid: torch.Tensor  # [T, 3]
    geo_radius: torch.Tensor  # [T]


def geo_pack_order(xyz: torch.Tensor, valid: torch.Tensor, bn: int, *,
                   n_clusters: Optional[int] = None, iters: int = 8,
                   rows_per_cluster: int = 256,
                   pack: str = "dense") -> np.ndarray:
    """The cluster-contiguous row order of `cluster_bank`
    (`clustered.py:48-103`): geographic k-means over ``xyz`` on its device,
    clusters relabeled along latitude bands, whole clusters appended in
    that order.  ``pack='pad'`` first pads out the open tile when the next
    cluster, smaller than a tile, would straddle its end (`:87-94`).
    Returns the row-index array, padded with -1 to a multiple of bn.
    ``pack`` defaults to 'dense', the hierarchical build's packing
    (`cluster_bank` defaults to 'pad', as JAX's)."""
    if pack not in ("pad", "dense"):
        raise ValueError(f"pack must be 'pad' or 'dense', got {pack!r}")
    num_rows = xyz.shape[0]
    if n_clusters is None:
        n_clusters = max(8, min(8192, num_rows // rows_per_cluster))
    # the lattice yields 2*(n//2) points: request one extra for odd C
    lons, lats, _ = fibonacci_lattice(n_clusters + (n_clusters % 2))
    seeds = lonlat_deg_to_xyz(torch.as_tensor(
        np.stack([lons[:n_clusters], lats[:n_clusters]], 1),
        dtype=torch.float32, device=xyz.device))
    centroids, assign = kmeans(xyz.to(torch.float32), n_clusters, iters=iters,
                               valid=valid, init_points=seeds)
    cluster_order = geo_sort_order(centroids).cpu().numpy()
    # valid rows by their cluster's rank, in row order within a cluster
    rows = np.nonzero(valid.cpu().numpy() > 0)[0]
    if not len(rows):
        return np.full(bn, -1, np.int64)
    rank = np.empty(n_clusters, np.int64)
    rank[cluster_order] = np.arange(n_clusters)
    row_rank = rank[assign.cpu().numpy()[rows]]
    rows = rows[np.argsort(row_rank, kind="stable")]
    if pack == "pad":
        chunks, lo, cur = [], 0, 0  # cur: the open tile's fill level
        for size in np.bincount(row_rank, minlength=n_clusters):
            if not size:
                continue
            if cur > 0 and cur + size > bn and size < bn:
                chunks.append(np.full(bn - cur, -1, np.int64))
                cur = 0
            chunks.append(rows[lo:lo + size])
            lo += size
            cur = (cur + size) % bn
        rows = np.concatenate(chunks)
    return np.concatenate([rows, np.full(-len(rows) % bn, -1, np.int64)])


def cluster_bank(bank: GeoBank, bn: int = 1024,
                 n_clusters: Optional[int] = None, iters: int = 8,
                 rows_per_cluster: int = 256,
                 pack: str = "pad") -> Tuple[GeoBank, TileStats]:
    """The bank with its rows in `geo_pack_order`, gathered on its device
    (`clustered.py:106-160`), padding rows zero and an explicit scattered
    validity mask, and its `tile_stats` at ``bn``.  int8 dequantization
    scales follow their rows."""
    if bank.num_rows % bn:
        raise ValueError(f"bank rows {bank.num_rows} are no multiple of bn={bn}")
    order = geo_pack_order(bank.xyz, bank.row_mask(), bn,
                           n_clusters=n_clusters, iters=iters,
                           rows_per_cluster=rows_per_cluster, pack=pack)
    sel = torch.as_tensor(order >= 0, device=bank.device)
    idx = torch.as_tensor(np.where(order >= 0, order, 0), dtype=torch.long,
                          device=bank.device)

    def take(x):
        g = x[idx]
        return torch.where(sel.reshape((-1,) + (1,) * (g.ndim - 1)), g,
                           torch.zeros((), dtype=g.dtype, device=g.device))

    reordered = GeoBank(
        locs_lonlat=take(bank.locs_lonlat), xyz=take(bank.xyz),
        keys_sem=take(bank.keys_sem), values=take(bank.values),
        n_valid=bank.n_valid, valid_mask=sel.to(torch.float32),
        value_scale=(None if bank.value_scale is None
                     else take(bank.value_scale[0])[None, :]))
    return reordered, tile_stats(reordered, bn)


def tile_stats(bank: GeoBank, bn: int) -> TileStats:
    """Per-tile weighted centroid and max row distance of each family
    (`clustered.py:163-183`), with the tile as a batch dimension."""
    T = bank.num_rows // bn
    v = bank.row_mask().reshape(T, bn)
    ks = bank.keys_sem.reshape(T, bn, -1).to(torch.float32)
    xs = bank.xyz.reshape(T, bn, 3).to(torch.float32)
    w = v / torch.clamp_min(v.sum(dim=1, keepdim=True), 1.0)

    def ball(x):
        c = (w[:, None, :] @ x)[:, 0]  # [T, d]
        r = torch.amax(torch.linalg.norm(x - c[:, None, :], dim=2) * v, dim=1)
        return c, r

    c_sem, r_sem = ball(ks)
    c_geo, r_geo = ball(xs)
    return TileStats(c_sem, r_sem, c_geo, r_geo)


def compute_keep_mask(q: torch.Tensor, centroids: torch.Tensor,
                      radii: torch.Tensor, *, temp: float, bm: int = 512,
                      margin: float = 20.0) -> torch.Tensor:
    """[nB, T] bool: per query tile of ``bm`` rows, the bank tiles that can
    matter for one logit family (`clustered.py:186-203`).  ``q @ c`` feeds
    a threshold, so it runs in true f32 whatever the caller's TF32
    setting.  Padded query rows keep nothing (all-zero rows would keep
    every tile)."""
    B = q.shape[0]
    nB = -(-B // bm)
    with true_f32_matmul():
        qc = q.to(torch.float32) @ centroids.to(torch.float32).T  # [B, T]
    r = radii.to(torch.float32)[None, :]
    ub = temp * (qc + r)
    lb = torch.amax(temp * (qc - r), dim=1, keepdim=True)
    keep = ub >= lb - margin  # [B, T]
    keep = torch.nn.functional.pad(keep, (0, 0, 0, nB * bm - B))
    return keep.reshape(nB, bm, -1).any(dim=1)


def compute_tile_plan(q: torch.Tensor, centroids: torch.Tensor,
                      radii: torch.Tensor, *, temp: float, bm: int = 512,
                      margin: float = 20.0):
    """Per query tile, the active bank tiles of one logit family
    (`clustered.py:206-234`): (idx [nB, T] int32, the kept tiles first in
    ascending order, the tail repeating the last kept one; counts [nB]
    int32, at least 1).  A tile is dropped when its upper logit bound lies
    more than ``margin`` below every query's best lower bound: its softmax
    mass is under N e^-margin of the total."""
    keep = compute_keep_mask(q, centroids, radii, temp=temp, bm=bm,
                             margin=margin)
    T = radii.shape[0]
    counts = torch.clamp_min(keep.sum(dim=1).to(torch.int32), 1)
    idx = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    last = torch.gather(idx, 1, (counts - 1).to(torch.long)[:, None])
    g = torch.arange(T, device=keep.device)[None, :]
    idx = torch.where(g < counts[:, None], idx, last)
    return idx.to(torch.int32), counts
