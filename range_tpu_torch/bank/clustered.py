"""Clustered bank: geographically ordered rows and per-tile bounding balls.

Counterpart of `range_tpu/bank/clustered.py:48-183`.  Bank rows are
reordered so that each bn-row kernel tile is geographically coherent:
geographic k-means over the rows' xyz (seeded with a Fibonacci lattice,
so no random numbers are drawn), clusters relabeled along latitude bands,
then whole clusters packed back to back into bn-row tiles (the JAX
package's ``pack='dense'``, the hierarchical build's choice; its 'pad'
packing serves the pruned path, which is not ported).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..data.checkerboard import fibonacci_lattice
from ..geometry import geo_sort_order, lonlat_deg_to_xyz
from ..ops.kmeans import kmeans
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
                   rows_per_cluster: int = 256) -> np.ndarray:
    """The cluster-contiguous row order of `cluster_bank`
    (`clustered.py:48-103`, ``pack='dense'``): geographic k-means over
    ``xyz`` on its device, clusters relabeled along latitude bands, whole
    clusters packed back to back.  Returns the row-index array, padded with
    -1 to a multiple of bn."""
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
    rank = np.empty(n_clusters, np.int64)
    rank[geo_sort_order(centroids).cpu().numpy()] = np.arange(n_clusters)
    # valid rows by their cluster's rank, in row order within a cluster
    rows = np.nonzero(valid.cpu().numpy() > 0)[0]
    rows = rows[np.argsort(rank[assign.cpu().numpy()[rows]], kind="stable")]
    return np.concatenate([rows, np.full(-len(rows) % bn, -1, np.int64)])


def cluster_bank(bank: GeoBank, bn: int = 1024,
                 n_clusters: Optional[int] = None, iters: int = 8,
                 rows_per_cluster: int = 256) -> GeoBank:
    """The bank with its rows in `geo_pack_order`, gathered on its device
    (`clustered.py:106-160`), padding rows zero and an explicit scattered
    validity mask.  int8 dequantization scales follow their rows."""
    if bank.num_rows % bn:
        raise ValueError(f"bank rows {bank.num_rows} are no multiple of bn={bn}")
    order = geo_pack_order(bank.xyz, bank.row_mask(), bn,
                           n_clusters=n_clusters, iters=iters,
                           rows_per_cluster=rows_per_cluster)
    sel = torch.as_tensor(order >= 0, device=bank.device)
    idx = torch.as_tensor(np.where(order >= 0, order, 0), dtype=torch.long,
                          device=bank.device)

    def take(x):
        g = x[idx]
        return torch.where(sel.reshape((-1,) + (1,) * (g.ndim - 1)), g,
                           torch.zeros((), dtype=g.dtype, device=g.device))

    return GeoBank(
        locs_lonlat=take(bank.locs_lonlat), xyz=take(bank.xyz),
        keys_sem=take(bank.keys_sem), values=take(bank.values),
        n_valid=bank.n_valid, valid_mask=sel.to(torch.float32),
        value_scale=(None if bank.value_scale is None
                     else take(bank.value_scale[0])[None, :]))


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
