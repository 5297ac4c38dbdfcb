"""Lloyd k-means from explicit seed centroids, for the bank build.

Counterpart of `range_tpu/ops/kmeans.py:19-114`.  Assignment is a matmul
argmax (min distance == max ``p.c - |c|^2/2``), the update a one-hot
matmul; invalid rows get an assignment but no weight in the updates, and
empty clusters stay where they were.  Both Lloyd branches of the JAX
function are here: one shot for ``N * C <= 2^28``, row-chunked above.  No
build the port accepts reaches the row-chunked branch yet: builds above
262,144 rows raise (ROADMAP.md, Queue 1 'Bank build'), so `geo_pack_order`
stays within 2^18 * 1024 = 2^28, and the per-tile problems are small; a
test takes it by lowering ``ONE_SHOT_MAX``.  A leading batch dimension
runs independent problems at once (the JAX package's ``vmap`` over bank
tiles, written out).

Every caller of the bank build seeds with ``init_points`` (a Fibonacci
lattice, or strided rows), so no random numbers are drawn and the port can
reproduce the JAX clustering up to f32 argmax near-ties.  The k-means++
seeding of the JAX function draws from JAX's PRNG and is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


# largest N * C of the one-shot Lloyd branch (the JAX function's threshold)
ONE_SHOT_MAX = 1 << 28


def _scores(points: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[Bt, N, C] = p.c - |c|^2 / 2, in the JAX function's order."""
    return (points @ centroids.transpose(1, 2)
            - 0.5 * torch.sum(centroids ** 2, dim=2)[:, None, :])


def _update(centroids, sums, counts):
    new = sums / torch.clamp_min(counts, 1.0)[..., None]
    return torch.where((counts > 0)[..., None], new, centroids)


def kmeans(points: torch.Tensor, n_clusters: int, iters: int = 10,
           valid: Optional[torch.Tensor] = None,
           init_points: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Euclidean k-means.

    Args:
      points: [N, D], or [Bt, N, D] for Bt independent problems.
      valid: optional [N] (or [Bt, N]) {0,1} mask of rows that update the
        centroids.
      init_points: [C, D] (or [Bt, C, D]) seed centroids; required.
    Returns (centroids [.., C, D], assign [.., N] int64)."""
    if init_points is None:
        raise NotImplementedError(
            "k-means++ seeding draws from JAX's PRNG and is not ported "
            "(ROADMAP.md, Queue 1 'Bank build'); pass init_points")
    batched = points.ndim == 3
    if not batched:
        points = points[None]
        init_points = init_points[None]
        valid = None if valid is None else valid[None]
    Bt, N, D = points.shape
    if init_points.shape != (Bt, n_clusters, D):
        raise ValueError(f"init_points {tuple(init_points.shape)} != "
                         f"{(Bt, n_clusters, D)}")
    if valid is None:
        valid = torch.ones((Bt, N), dtype=torch.float32, device=points.device)
    valid = valid.to(torch.float32)
    centroids = init_points.to(points.dtype)

    def one_hot(assign, v):
        return F.one_hot(assign, n_clusters).to(torch.float32) * v[..., None]

    if N * n_clusters <= ONE_SHOT_MAX:
        for _ in range(iters):
            oh = one_hot(torch.argmax(_scores(points, centroids), dim=2), valid)
            centroids = _update(centroids, oh.transpose(1, 2) @ points,
                                oh.sum(dim=1))
        assign = torch.argmax(_scores(points, centroids), dim=2)
    else:
        # row-chunked Lloyd (`ops/kmeans.py:81-114`): the one-shot [N, C]
        # score and one-hot matrices are O(N*C); per-chunk sums accumulate
        # in f32 (the assignments are pointwise and unchanged)
        CH = max(128, min(N, (1 << 27) // n_clusters) // 128 * 128)
        chunks = [slice(lo, min(lo + CH, N)) for lo in range(0, N, CH)]
        for _ in range(iters):
            sums = torch.zeros((Bt, n_clusters, D), dtype=torch.float32,
                               device=points.device)
            counts = torch.zeros((Bt, n_clusters), dtype=torch.float32,
                                 device=points.device)
            for rows in chunks:
                p = points[:, rows]
                oh = one_hot(torch.argmax(_scores(p, centroids), dim=2),
                             valid[:, rows])
                sums += oh.transpose(1, 2) @ p
                counts += oh.sum(dim=1)
            centroids = _update(centroids, sums, counts)
        assign = torch.cat([torch.argmax(_scores(points[:, rows], centroids),
                                         dim=2) for rows in chunks], dim=1)
    if not batched:
        return centroids[0], assign[0]
    return centroids, assign
