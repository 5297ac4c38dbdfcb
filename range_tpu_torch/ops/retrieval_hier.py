"""Hierarchical (two-stage) approximate retrieval: bank build and serving.

Counterpart of `range_tpu/ops/retrieval_hier.py` on one device: every
bank `build_hier_bank` makes there (any subset of lr_rank, res_rank,
lr_geo, topk_gsz / topk_lr, gsz_super, tail_super and sel_lr), in RANGE
and RANGE+ mode, with bf16 or int8 values.

Build (`build_hier_bank`, offline, on the bank's device): geographic
k-means reorder with dense packing (`bank/clustered.py`), a key+value
k-means within each bn-row tile so that every gsz-row window is a coherent
group (with ``gsz_super``, a second k-means nests the groups into
gsz_super-row supergroups), then the packed serving operands: keys,
per-group centroids and value sums per family, the low-rank tails
(`lr_rank`, `lr_geo`), the residual-rank row coefficients (`res_rank`),
the supergroup centroids (``gsz_super``) and the supergroup sem tail
operands (``tail_super``), and the rank-k PCA sketches of the fine
stats-only centroids (``topk_lr``) and of the sem centroids (``sel_lr``).

Serving features (`retrieve_hier`, routed as the JAX function routes):
  1. pad and pack the queries, sort them (`_hybrid_order`: geographically,
     or with ``sort="hybrid"`` by coarse cell then home tile from a
     stats-only pre-scan, `_hier_scan_stats_call`);
  2. the SCAN kernel: per (query, tile) max group logit and exp-mass for
     both families, and the all-tiles group tail  e @ [V_g | n_g]
     (`_hier_scan_call`, over `_scan_plan`'s segments; tails wider than
     576 columns, the full-width group sums of banks without lr_rank /
     lr_geo, in column slices);
  3. RANGE+ with k_geo > 0 (the family split; banks with res_rank always):
     `select_tiles` per family (K sem tiles, k_geo geo tiles per block of
     bm queries), the PARTS kernel per family, exact minus group
     approximation over the selected tiles (`_hier_parts_family_call`, in
     its rr + lr, rr, lr and plain shapes), then the COMBINE kernel
     (`_combine_cat_call`: unprojection, normalization, beta blend and the
     query concat, with or without the low-rank geo tail) where the JAX
     package fuses it, else the combine in torch;
  4. RANGE mode (no locations, beta 1: the home-tile sort and the scan
     without its geo family) and RANGE+ with k_geo = 0: one selection,
     the MERGED parts kernel (`_hier_parts_call`: both families' exact
     minus approximation in one pass, lr or plain; the geo family skipped
     where RANGE discards it) and the combine in torch.
The un-sort is a torch gather.  Banks with int8 values
(`quantize_values`) keep their codes and scales; the kernels that stream
values fold the scales in.  On ``tail_super`` banks the scan's sem tail
runs over supergroup means (its segment-sum variant), one selection keeps
K + ``m_corr`` sem tiles, and the CORRECTION kernel (`_hier_corr_call`)
adds the fine-group tail back over all of them before the combine.  On
``sel_lr`` banks the scan's sem group logits and the sem parts kernel's
group approximation both contract the rank-k query sketch (the parts
kernel's sel form).  ``dedup`` merges adjacent blocks' tile lists
(`_dedup_union`) into one parts dispatch (the dedup_pad form skips the
lists' repeat padding); ``adaptive_frac`` re-runs the parts kernels with
wider budgets for the queries whose selected tiles cover the least
exp-mass.  Banks with supergroup operands and no lr_rank take the
TWO-LEVEL feature path (`_hier_partials2`): the scan over supergroups, M
coarse tiles, the REFINE kernel's has_parts form (fine stats and the
fine-minus-supergroup tail over the M), K of the M to the merged parts
kernel.

Serving top-k rows (`hier_topk`, the recall endpoint, k = 1..8): the
STATS-ONLY scan over the fine `g_topk_cat` operand (`_hier_scan_stats_call`),
`select_tiles` with a big K, then the exact hi/lo semantic ARGMAX (k = 1,
`_hier_argmax_call`) or the K-CARRY top-k (`_hier_topk_call`) over each
block's selected tiles (on ``topk_lr`` banks the stats scan reads the
queries' rank-k sketch against `g_topk_lr`).  On ``gsz_super`` banks the
selection is two-level:
the stats scan over the supergroup centroids keeps M tiles, the REFINE
kernel (`_hier_refine_call`) computes their fine stats, and K of the M
go to the argmax.  `hier_nn` is the harness that measures which
argmax the feature path can reach (masked logits, chunked, no kernel of
its own beyond the stats scan).

Each kernel wrapper runs its plain PyTorch version on CPU tensors and the
CUDA kernel (`csrc/`) on CUDA tensors, and counts launches in
``.launches``.  On banks of the `exact` tier (f32 operands) the wrappers
of the scan, the stats scan, the refine, the correction and both parts
kernels launch the CUDA-core body `csrc/hier_cores.cu` (`_cores_form`),
counted also in ``.f32_launches``; at the `high` tier (768 semantic
columns) the scan, the refine and the correction do
(``.deep_launches``; the stats scan's 768 columns run on its own kernel,
whose shared memory holds them), while both parts kernels and the top-k
kernel take logits over more than 256 columns on their Hopper bodies, in
passes of 256 columns with the accumulator carried.  The numbers are f32
sums of bf16 products in both; the rounding points (bf16 p before every
value product) are the JAX package's.  The sharded and host-staged
builds raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import heapq
import itertools
import json
import logging
import math
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..bank.bank import GeoBank, dequantize_values
from ..bank.clustered import cluster_bank, tile_stats
from ._prep import prepared, swizzle128
from .kmeans import kmeans
from .retrieval import first_argmax
from .retrieval_fused import (_SM90_MAX_SMEM, CLAMP2, NEG, SM90_SMS, _round_up,
                              _split_hilo, geo_real_cols, pack_bank, pack_queries,
                              packed_dims)
from .topk import topk_stable

# group operands are padded to a multiple of TC tiles (the JAX scan's tile
# chunk); kept so that t_pad, and with it every operand shape, matches
TC = 32

_ROADMAP_BUILD = "ROADMAP.md, Queue 1 'Bank build: knobs left unported'"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass
class HierBank:
    """Clustered and prepacked serving bank, with the JAX `HierBank`'s
    field names (`retrieval_hier.py:97-237`).  N = padded rows, T = N/bn
    real tiles padded to t_pad (a multiple of 32) in the group operands,
    G* = t_pad * bn/gsz_*.

      bank:        the clustered GeoBank (row-reordered, dense-packed)
      k_cat:       [N, cat_d] packed serving keys (pack_bank, `tier`)
      values:      [N, Dv] serving values: bf16, or int8 codes with
                   value_scale [1, N] f32 (a `quantize_values` bank)
      mask_neg:    [1, N] f32 additive row mask (0 / -1e30)
      sem_/geo_centroid, sem_/geo_radius: per-tile bounding balls
      g_sem_cat:   [G_s, sem_d] packed sem group centroids
      g_geo_cat:   [G_g, cat_d - sem_d] packed geo group centroids
      g_sem_vw / g_geo_vw: [G*, Dvp] group value sums, count in column Dv
      khl_sem:     [N, 2*Dk] bf16 [k_hi | k_lo]
      g_sem_vw_lr: [G_s, rp] rank-lr_rank coefficients, count in column
                   lr_rank; u_sem [lr_rank, Dv] f32 basis (same for geo)
      z_sem/z_geo: [N, rrp] residual-rank coefficients; w_sem/w_geo
                   [rrp, Dv] f32 bases
      g_topk_cat:  [G_t, sem_d] stats-only sem centroids at topk_gsz
      g_sup_cat / g_sup_vw: the sem centroids and value sums at gsz_super
                   (the two-level top-k's coarse selection stats)
      g_sem_ts_vw: [G_s / ratio, W] supergroup means of the sem tail
                   operand, ratio = tail_super / gsz_sem; g_sem_ts_dvw
                   [G_s, W] each group's row minus its supergroup's mean
      g_topk_lr:   [G_t, topk_lr] rank-topk_lr sketch of g_topk_cat, with
                   p_topk [topk_lr, sem_d] f32 its basis
      g_sem_sel:   [G_s, sel_lr] rank-sel_lr sketch of g_sem_cat, with
                   p_sel [sel_lr, sem_d] f32 its basis
    """

    bank: GeoBank
    k_cat: torch.Tensor
    values: torch.Tensor
    value_scale: Optional[torch.Tensor]
    mask_neg: torch.Tensor
    sem_centroid: torch.Tensor
    geo_centroid: torch.Tensor
    sem_radius: torch.Tensor
    geo_radius: torch.Tensor
    g_sem_cat: torch.Tensor
    g_geo_cat: torch.Tensor
    g_sem_vw: torch.Tensor
    g_geo_vw: torch.Tensor
    khl_sem: Optional[torch.Tensor] = None
    g_sup_cat: Optional[torch.Tensor] = None
    g_sup_vw: Optional[torch.Tensor] = None
    g_sem_vw_lr: Optional[torch.Tensor] = None
    u_sem: Optional[torch.Tensor] = None
    g_geo_vw_lr: Optional[torch.Tensor] = None
    u_geo: Optional[torch.Tensor] = None
    z_sem: Optional[torch.Tensor] = None
    w_sem: Optional[torch.Tensor] = None
    z_geo: Optional[torch.Tensor] = None
    w_geo: Optional[torch.Tensor] = None
    g_sem_ts_vw: Optional[torch.Tensor] = None
    g_sem_ts_dvw: Optional[torch.Tensor] = None
    g_topk_cat: Optional[torch.Tensor] = None
    g_topk_lr: Optional[torch.Tensor] = None
    p_topk: Optional[torch.Tensor] = None
    g_sem_sel: Optional[torch.Tensor] = None
    p_sel: Optional[torch.Tensor] = None
    tier: str = "fast"
    bn: int = 512
    gsz_sem: int = 8
    gsz_geo: int = 64
    gsz_super: int = 0
    lr_rank: int = 0
    lr_geo: int = 0
    res_rank: int = 0
    topk_gsz: int = 0
    topk_lr: int = 0
    tail_super: int = 0
    sel_lr: int = 0
    sem_d: int = 256
    cat_d: int = 384
    t_real: int = 0
    t_pad: int = 0

    @property
    def value_dim(self) -> int:
        return self.values.shape[1]

    def to(self, device) -> "HierBank":
        moved = {f: getattr(self, f).to(device) for f in _ARRAY_FIELDS
                 if getattr(self, f) is not None}
        return dataclasses.replace(self, bank=self.bank.to(device), **moved)


_ARRAY_FIELDS = (
    "k_cat", "values", "value_scale", "mask_neg", "sem_centroid",
    "geo_centroid", "sem_radius", "geo_radius", "g_sem_cat", "g_geo_cat",
    "g_sem_vw", "g_geo_vw", "khl_sem", "g_sup_cat", "g_sup_vw", "g_sem_vw_lr",
    "u_sem", "g_geo_vw_lr", "u_geo", "z_sem", "w_sem", "z_geo", "w_geo",
    "g_sem_ts_vw", "g_sem_ts_dvw", "g_topk_cat", "g_topk_lr", "p_topk",
    "g_sem_sel", "p_sel")
_META_FIELDS = ("tier", "bn", "gsz_sem", "gsz_geo", "gsz_super", "lr_rank",
                "lr_geo", "res_rank", "topk_gsz", "topk_lr", "tail_super",
                "sel_lr", "sem_d", "cat_d", "t_real", "t_pad")


# ---------------------------------------------------------------------------
# bank build


def _order_rows_within_tiles(keys: torch.Tensor, valid: torch.Tensor,
                             bn: int, n_groups: int,
                             n_super: int = 0) -> np.ndarray:
    """Permutation [N] reordering rows WITHIN each bn-row tile so rows with
    similar features are consecutive (`retrieval_hier.py:256-322`):
    per-tile k-means (6 Lloyd iterations seeded with strided rows, so no
    random numbers), rows sorted by cluster label, invalid rows last.  Tile
    membership is untouched.  ``n_super > 0`` makes the order hierarchical:
    a second k-means per tile (6 iterations, seeded with every
    n_groups // n_super-th fine centroid) clusters the n_groups fine
    centroids into n_super supergroups, and rows sort by (supergroup, fine
    cluster), so each gsz_super-row window nests whole fine groups."""
    N = keys.shape[0]
    T = N // bn
    vs = valid.reshape(T, bn)
    stride = bn // n_groups
    cents, assign = [], []
    for lo in range(0, T, 256):  # tiles are independent: bound the memory
        feats = keys[lo * bn:(lo + 256) * bn].to(torch.float32).reshape(
            -1, bn, keys.shape[1])
        c, a = kmeans(feats, n_groups, iters=6, valid=vs[lo:lo + 256],
                      init_points=feats[:, ::stride])
        cents.append(c)
        assign.append(a.cpu().numpy())
    label = np.concatenate(assign, axis=0)
    n_labels = n_groups
    if n_super:
        cent = torch.cat(cents)  # [T, n_groups, D]
        _, sup_of_fine = kmeans(cent, n_super, iters=6,
                                init_points=cent[:, ::n_groups // n_super])
        sup = np.take_along_axis(sup_of_fine.cpu().numpy(), label, axis=1)
        label = sup * n_groups + label
        n_labels = n_super * n_groups
    del cents
    vn = vs.cpu().numpy()
    sort_key = label + (1.0 - vn) * (n_labels + 1)  # invalid rows last
    order = np.argsort(sort_key, axis=1, kind="stable")
    return (order + (np.arange(T) * bn)[:, None]).reshape(-1)


def _group_sum(x: torch.Tensor, mg: torch.Tensor) -> torch.Tensor:
    """einsum('gi,gid->gd', mg, x.reshape(G, gsz, -1)) in f32."""
    G, gsz = mg.shape
    return (mg[:, None, :] @ x.to(torch.float32).reshape(G, gsz, -1))[:, 0]


def _eig_top(gram: torch.Tensor, k: int) -> torch.Tensor:
    """[k, D]: the eigenvectors of the k largest eigenvalues, as rows
    (ascending order, as `jnp.linalg.eigh`).  Column signs are arbitrary."""
    _, vecs = torch.linalg.eigh(gram)
    return vecs[:, -k:].T


def _lowrank_centroid_factor(g_cat: torch.Tensor, k: int):
    """Rank-k PCA factorization of a packed centroid operand
    (`retrieval_hier.py:325-335`): (coefficients [G, k] in the operand's
    dtype, basis [k, d] f32) with coefficients @ basis ~= g_cat; zero pad
    rows get zero coefficients.  The topk_lr and sel_lr sketches.  The
    factors are unique only up to column signs (and rotations inside
    degenerate eigenspaces): what serving reads, the sketched logits and
    the reconstruction, is not."""
    C = g_cat.to(torch.float32)
    p = _eig_top(C.T @ C, k)
    return (C @ p.T).to(g_cat.dtype), p.to(torch.float32)


def build_hier_bank(bank: GeoBank, *, bn: int = 512, gsz_sem: int = 8,
                    gsz_geo: int = 64, gsz_super: int = 0,
                    tier: str = "fast", group_by: str = "key_value",
                    group_value_weight: float = 1.0,
                    lr_rank: Optional[int] = None,
                    lr_geo: Optional[int] = None,
                    res_rank: Optional[int] = None,
                    topk_gsz: int = 0, topk_lr: int = 0,
                    tail_super: int = 0, sel_lr: int = 0,
                    n_clusters: Optional[int] = None, iters: int = 8,
                    seed: int = 0, value_dtype: Optional[torch.dtype] = None,
                    shards: int = 1,
                    host_stage: Optional[bool] = None) -> HierBank:
    """Offline serving prep on the bank's device (`retrieval_hier.py:337-804`,
    its device path).  ``seed`` names the build in its cache signature;
    the clustering is seeded with explicit points and draws nothing.  A
    `quantize_values` bank keeps its int8 codes and scales (permuted with
    their rows); every derived operand comes from the dequantized values.
    ``value_dtype`` overrides the serving values' dtype (bf16 by default;
    JAX's override, `retrieval_hier.py:777-779`: f32 values make the
    `exact` tier's value products f32); int8 codes take precedence."""
    if bn % gsz_sem or bn % gsz_geo or bn // gsz_sem < 8 or bn // gsz_geo < 8:
        raise ValueError(f"bn={bn} must hold >= 8 groups of gsz_sem={gsz_sem} "
                         f"and gsz_geo={gsz_geo}")
    if topk_gsz and (bn % topk_gsz or bn // topk_gsz < 8 or gsz_sem % topk_gsz):
        raise ValueError(f"topk_gsz={topk_gsz} must nest inside gsz_sem="
                         f"{gsz_sem} windows of bn={bn}")
    _check_super_knobs(bn, gsz_sem, gsz_super, tail_super, topk_gsz, sel_lr)
    if topk_lr and not topk_gsz:
        raise ValueError("topk_lr factors the topk_gsz stats operand: build "
                         "with topk_gsz set")
    if shards > 1:
        raise _not_ported("build_hier_bank(shards>1)", "ROADMAP.md, Queue 1 "
                          "'Multi-GPU'")
    if host_stage or bank.num_rows > 262_144:
        raise _not_ported("the host-staged and bf16 builds above 262,144 rows",
                          _ROADMAP_BUILD)
    if group_by not in ("key", "key_value"):
        raise ValueError(f"group_by must be 'key' or 'key_value', got {group_by!r}")
    cbank, _ = cluster_bank(bank, bn=bn, n_clusters=n_clusters, iters=iters,
                            pack="dense")
    if group_by == "key_value":
        # groups cluster on [key | lam * v/|v|] so group value sums stay
        # value-pure (`retrieval_hier.py:443-471`)
        vf = dequantize_values(cbank)
        vn = vf / torch.clamp_min(torch.linalg.norm(vf, dim=1, keepdim=True),
                                  1e-9)
        gfeat = torch.cat([cbank.keys_sem.to(torch.float32),
                           group_value_weight * vn], 1)
    else:
        gfeat = cbank.keys_sem
    perm = torch.as_tensor(
        _order_rows_within_tiles(gfeat, cbank.row_mask(), bn, bn // gsz_sem,
                                 n_super=bn // gsz_super if gsz_super else 0),
        dtype=torch.long, device=bank.device)
    del gfeat
    cbank = dataclasses.replace(
        cbank, locs_lonlat=cbank.locs_lonlat[perm], xyz=cbank.xyz[perm],
        keys_sem=cbank.keys_sem[perm], values=cbank.values[perm],
        valid_mask=cbank.valid_mask[perm],
        value_scale=(None if cbank.value_scale is None
                     else cbank.value_scale[:, perm]))
    return pack_hier_bank(cbank, bn=bn, gsz_sem=gsz_sem, gsz_geo=gsz_geo,
                          gsz_super=gsz_super, tier=tier, lr_rank=lr_rank,
                          lr_geo=lr_geo, res_rank=res_rank, topk_gsz=topk_gsz,
                          topk_lr=topk_lr, tail_super=tail_super, sel_lr=sel_lr,
                          value_dtype=value_dtype)


def _check_super_knobs(bn: int, gsz_sem: int, gsz_super: int, tail_super: int,
                       topk_gsz: int, sel_lr: int) -> None:
    """The two-level knobs' nesting rules (`retrieval_hier.py:366-401`)."""
    if gsz_super and (bn % gsz_super or gsz_super % gsz_sem
                      or bn // gsz_super < 8):
        raise ValueError(f"gsz_super={gsz_super} must hold whole gsz_sem="
                         f"{gsz_sem} groups and >= 8 supergroups of bn={bn}")
    if gsz_super and topk_gsz:
        raise ValueError("gsz_super and topk_gsz are mutually exclusive: both "
                         "feed hier_topk's selection and gsz_super would win, "
                         "leaving the topk_gsz operand unused")
    if tail_super and (bn % tail_super or tail_super % gsz_sem
                       or tail_super <= gsz_sem):
        raise ValueError(f"tail_super={tail_super} must hold several whole "
                         f"gsz_sem={gsz_sem} groups and divide bn={bn}")
    if tail_super and sel_lr:
        raise ValueError("sel_lr and tail_super are mutually exclusive: the "
                         "supergroup correction kernel needs full-width group "
                         "logits")


def pack_hier_bank(cbank: GeoBank, *, bn: int, gsz_sem: int, gsz_geo: int,
                   gsz_super: int = 0, tier: str = "fast",
                   lr_rank: Optional[int] = None,
                   lr_geo: Optional[int] = None,
                   res_rank: Optional[int] = None,
                   topk_gsz: int = 0, topk_lr: int = 0, tail_super: int = 0,
                   sel_lr: int = 0,
                   value_dtype: Optional[torch.dtype] = None) -> HierBank:
    """The serving operands of a bank whose rows are already in their
    final order (`retrieval_hier.py:494-804`, the ``prep`` stage):
    `build_hier_bank`'s second half.  Tests feed it the JAX build's row
    order to hold the operands against JAX's without k-means ties.

    ``topk_lr`` adds g_topk_lr / p_topk, the rank-topk_lr sketch of the
    fine stats-only centroids g_topk_cat (hier_topk's low-rank selection
    signal); ``sel_lr`` adds g_sem_sel / p_sel, the rank-sel_lr sketch of
    g_sem_cat (the feature path's sketched selection and tail,
    `retrieval_hier.py:756-775`).  Both are clamped to the key width, and
    sel_lr to sem_d.

    ``gsz_super`` adds the supergroup operands g_sup_cat / g_sup_vw (the
    two-level selection's coarse stats); ``tail_super`` the weighted-
    supergroup sem tail: g_sem_ts_vw, the mean of each tail_super // gsz_sem
    consecutive rows of the sem tail operand (the lr coefficients when
    ``lr_rank`` is set), and g_sem_ts_dvw, each row minus its supergroup's
    mean (`retrieval_hier.py:672-685`).  ``value_dtype``: `build_hier_bank`'s."""
    Dv = cbank.value_dim
    topk_lr = min(topk_lr, cbank.key_dim) if topk_lr else 0
    sel_lr = min(sel_lr, cbank.key_dim) if sel_lr else 0
    lr_rank = min(lr_rank, Dv) if lr_rank else 0
    lr_geo = min(lr_geo, Dv) if lr_geo else 0
    res_rank = min(res_rank, Dv) if res_rank else 0
    f32 = torch.float32
    N = cbank.num_rows
    T = N // bn
    t_pad = _round_up(T, TC)
    stats = tile_stats(cbank, bn)
    sem_d, cat_d = packed_dims(cbank.key_dim, tier)
    Dk = cbank.key_dim
    Dvp = _round_up(Dv + 1, 128)
    vw_dtype = f32 if tier == "exact" else torch.bfloat16
    dev = cbank.device
    mask = cbank.row_mask()
    vals_f32 = dequantize_values(cbank) * mask[:, None]

    def zeros(*shape):
        return torch.zeros(shape, dtype=f32, device=dev)

    def padg(x, G_pad):
        return torch.nn.functional.pad(x, (0, 0, 0, G_pad - x.shape[0]))

    def group_ops(feats, gsz, geo, stats_only=False):
        """Packed slim centroids [G_pad, family cols] and value sums with
        the count in column Dv [G_pad, Dvp] (`retrieval_hier.py:555-593`)."""
        G, G_pad = N // gsz, t_pad * (bn // gsz)
        mg = mask.reshape(G, gsz)
        cnt = mg.sum(dim=1)
        cg = _group_sum(feats, mg / torch.clamp_min(cnt, 1.0)[:, None])
        if geo:
            cat = pack_bank(zeros(G_pad, Dk), padg(cg, G_pad), tier)[:, sem_d:]
        else:
            cat = pack_bank(padg(cg, G_pad), zeros(G_pad, 3), tier)[:, :sem_d]
        if stats_only:
            return cat.contiguous(), None
        vw = torch.cat([_group_sum(vals_f32, mg), cnt[:, None],
                        zeros(G, Dvp - Dv - 1)], 1)
        return cat.contiguous(), padg(vw, G_pad).to(vw_dtype)

    def low_rank(gsz, r):
        """Rank-r Gram eigenbasis of the group value sums: the packed
        [coef | cnt | 0] operand, and (coef, cnt, u) for the residuals
        (`retrieval_hier.py:625-670`)."""
        G, G_pad = N // gsz, t_pad * (bn // gsz)
        mg = mask.reshape(G, gsz)
        cnt = mg.sum(dim=1)
        vsum = _group_sum(vals_f32, mg)
        u = _eig_top(vsum.T @ vsum, r)
        coef = vsum @ u.T
        lrw = torch.cat([coef, cnt[:, None],
                         zeros(G, _round_up(r + 1, 128) - r - 1)], 1)
        return padg(lrw, G_pad).to(vw_dtype), u.to(f32), (coef, cnt, u)

    def fam_res(gsz, mean_lr):
        """Residual-rank row coefficients against the serving group mean
        (`retrieval_hier.py:695-745`; one chunk, as the JAX build takes at
        the sizes this build accepts)."""
        G = N // gsz
        mg = mask.reshape(G, gsz)
        if mean_lr is not None:
            coef, cnt_lr, u = mean_lr
            vbar = (coef / torch.clamp_min(cnt_lr, 1.0)[:, None]) @ u
        else:
            cnt = torch.clamp_min(mg.sum(dim=1), 1.0)
            vbar = _group_sum(vals_f32, mg) / cnt[:, None]
        R = ((vals_f32.reshape(G, gsz, Dv) - vbar[:, None, :])
             * mg[..., None]).reshape(N, Dv)
        w = _eig_top(R.T @ R, res_rank)
        rrp = _round_up(res_rank, 128)
        z = torch.nn.functional.pad(R @ w.T, (0, rrp - res_rank))
        w = torch.nn.functional.pad(w, (0, 0, 0, rrp - res_rank))
        return z.to(vw_dtype), w.to(f32)

    g_sem_cat, g_sem_vw = group_ops(cbank.keys_sem, gsz_sem, geo=False)
    g_geo_cat, g_geo_vw = group_ops(cbank.xyz, gsz_geo, geo=True)
    g_sem_vw_lr = u_sem = g_geo_vw_lr = u_geo = None
    lr_s = lr_g = None
    if lr_rank:
        g_sem_vw_lr, u_sem, lr_s = low_rank(gsz_sem, lr_rank)
    if lr_geo:
        g_geo_vw_lr, u_geo, lr_g = low_rank(gsz_geo, lr_geo)
    z_sem = w_sem = z_geo = w_geo = None
    if res_rank:
        z_sem, w_sem = fam_res(gsz_sem, lr_s)
        z_geo, w_geo = fam_res(gsz_geo, lr_g)
    g_topk_cat = (group_ops(cbank.keys_sem, topk_gsz, geo=False,
                            stats_only=True)[0] if topk_gsz else None)
    g_topk_lr = p_topk = g_sem_sel = p_sel = None
    if topk_lr and g_topk_cat is not None:
        g_topk_lr, p_topk = _lowrank_centroid_factor(g_topk_cat, topk_lr)
    if sel_lr:
        sel_lr = min(sel_lr, sem_d)
        g_sem_sel, p_sel = _lowrank_centroid_factor(g_sem_cat, sel_lr)
    g_sup_cat, g_sup_vw = (group_ops(cbank.keys_sem, gsz_super, geo=False)
                           if gsz_super else (None, None))
    g_sem_ts_vw = g_sem_ts_dvw = None
    if tail_super:
        src = (g_sem_vw_lr if lr_rank else g_sem_vw).to(f32)
        ratio = tail_super // gsz_sem
        ts_vw = src.reshape(-1, ratio, src.shape[1]).mean(dim=1)
        g_sem_ts_dvw = (src - ts_vw.repeat_interleave(ratio, dim=0)).to(vw_dtype)
        g_sem_ts_vw = ts_vw.to(vw_dtype)
    kh, kl = _split_hilo(cbank.keys_sem.to(f32))
    if cbank.value_scale is not None:  # int8 codes, served with their scales
        values, scale = cbank.values, cbank.value_scale.to(f32)
    else:  # the serving default: bf16
        values, scale = cbank.values.to(value_dtype or torch.bfloat16), None
    return HierBank(
        bank=cbank, k_cat=pack_bank(cbank.keys_sem, cbank.xyz, tier),
        values=values, value_scale=scale,
        mask_neg=(NEG * (1.0 - mask))[None, :].to(f32),
        sem_centroid=stats.sem_centroid, geo_centroid=stats.geo_centroid,
        sem_radius=stats.sem_radius, geo_radius=stats.geo_radius,
        g_sem_cat=g_sem_cat, g_geo_cat=g_geo_cat, g_sem_vw=g_sem_vw,
        g_geo_vw=g_geo_vw, khl_sem=torch.cat([kh, kl], 1),
        g_sem_vw_lr=g_sem_vw_lr, u_sem=u_sem, g_geo_vw_lr=g_geo_vw_lr,
        u_geo=u_geo, z_sem=z_sem, w_sem=w_sem, z_geo=z_geo, w_geo=w_geo,
        g_topk_cat=g_topk_cat, g_sup_cat=g_sup_cat, g_sup_vw=g_sup_vw,
        g_sem_ts_vw=g_sem_ts_vw, g_sem_ts_dvw=g_sem_ts_dvw,
        g_topk_lr=g_topk_lr, p_topk=p_topk, g_sem_sel=g_sem_sel, p_sel=p_sel,
        tier=tier, bn=bn, gsz_sem=gsz_sem, gsz_geo=gsz_geo,
        gsz_super=gsz_super, lr_rank=lr_rank, lr_geo=lr_geo,
        res_rank=res_rank, topk_gsz=topk_gsz, topk_lr=topk_lr,
        tail_super=tail_super, sel_lr=sel_lr, sem_d=sem_d, cat_d=cat_d,
        t_real=T, t_pad=t_pad)


# ---------------------------------------------------------------------------
# the HierBank archive (the JAX package's npz format) and its cache


def bank_fingerprint(bank: GeoBank) -> str:
    """Content fingerprint of a source bank (`retrieval_hier.py:3402-3414`):
    the first two key and location rows as f32 bytes, plus the shapes."""
    h = hashlib.sha1()
    h.update(bank.keys_sem[:2].to(torch.float32).cpu().numpy().tobytes())
    h.update(bank.locs_lonlat[:2].to(torch.float32).cpu().numpy().tobytes())
    for n in (bank.num_rows, int(bank.n_valid), bank.value_dim, bank.key_dim):
        h.update(str(n).encode())
    return h.hexdigest()[:16]


def hier_build_signature(bank: GeoBank, *, bn: int, gsz_sem: int,
                         gsz_geo: int, tier: str, seed: int, shards: int,
                         gsz_super: int = 0, group_by: str = "key_value",
                         group_value_weight: float = 1.0, lr_rank: int = 0,
                         lr_geo: int = 0, res_rank: int = 0,
                         topk_gsz: int = 0, topk_lr: int = 0,
                         tail_super: int = 0, sel_lr: int = 0) -> dict:
    """The identity of a build, stored in the archive and checked on load
    (`retrieval_hier.py:3417-3457`); equal to the JAX package's for the
    same bank and knobs, so either package's cache serves the other."""
    Dv = bank.value_dim
    lr_rank = min(lr_rank, Dv) if lr_rank else lr_rank
    lr_geo = min(lr_geo, Dv) if lr_geo else lr_geo
    res_rank = min(res_rank, Dv) if res_rank else res_rank
    sel_lr = min(sel_lr, bank.key_dim) if sel_lr else sel_lr
    sig = {"fp": bank_fingerprint(bank), "bn": bn, "gsz_sem": gsz_sem,
           "gsz_geo": gsz_geo, "gsz_super": gsz_super, "tier": tier,
           "seed": seed, "shards": shards, "group_by": group_by,
           "gvw": group_value_weight, "lr_rank": lr_rank,
           "res_rank": res_rank, "topk_gsz": topk_gsz, "fmt": 2}
    # keyed only when active, as the JAX package does
    for key, val in (("topk_lr", topk_lr), ("lr_geo", lr_geo),
                     ("tail_super", tail_super), ("sel_lr", sel_lr)):
        if val:
            sig[key] = val
    return sig


def peek_hier_build(path: str) -> Optional[dict]:
    """The build signature of an archive (None for archives without one)."""
    with np.load(path) as z:
        return json.loads(z["meta_json"].tobytes().decode()).get("build")


def _to_numpy(x: torch.Tensor):
    x = x.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(np.uint16), "bf16"
    a = x.numpy()
    return a, str(a.dtype)


def save_hier_bank(hb: HierBank, path: str, build: Optional[dict] = None
                   ) -> None:
    """One npz in the JAX package's format (`retrieval_hier.py:3470-3518`):
    bf16 arrays as uint16 bit patterns, meta as JSON bytes."""
    arrays, meta = {}, {"dtypes": {}}
    for field in _ARRAY_FIELDS:
        v = getattr(hb, field)
        if v is not None:
            arrays[field], meta["dtypes"][field] = _to_numpy(v)
    for field in ("locs_lonlat", "xyz", "keys_sem", "valid_mask", "values",
                  "value_scale"):
        v = getattr(hb.bank, field)
        if v is not None:
            key = "bank_" + field
            arrays[key], meta["dtypes"][key] = _to_numpy(v)
    arrays["bank_n_valid"] = np.asarray(int(hb.bank.n_valid))
    for field in _META_FIELDS:
        meta[field] = getattr(hb, field)
    if build is not None:
        meta["build"] = build
    arrays["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                        dtype=np.uint8)
    np.savez(path, **arrays)


def load_hier_bank(path: str, device="cuda") -> HierBank:
    """Load a `save_hier_bank` archive, from either package, onto
    ``device`` (`retrieval_hier.py:3521-3574`)."""
    with np.load(path) as z:
        raw = dict(z)
    meta = json.loads(raw.pop("meta_json").tobytes().decode())

    def dec(name):
        if name not in raw:
            return None
        x = raw[name]
        if meta["dtypes"].get(name) == "bf16":
            t = torch.from_numpy(np.ascontiguousarray(x).view(np.int16))
            return t.view(torch.bfloat16).to(device)
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    bank = GeoBank(locs_lonlat=dec("bank_locs_lonlat"), xyz=dec("bank_xyz"),
                   keys_sem=dec("bank_keys_sem"), values=dec("bank_values"),
                   n_valid=int(raw["bank_n_valid"]),
                   valid_mask=dec("bank_valid_mask"),
                   value_scale=dec("bank_value_scale"))
    defaults = {f.name: f.default for f in dataclasses.fields(HierBank)}
    return HierBank(bank=bank, **{f: dec(f) for f in _ARRAY_FIELDS},
                    **{f: meta.get(f, defaults[f]) for f in _META_FIELDS})


def prepare_hier_bank(bank: GeoBank, *, cache_path: Optional[str] = None,
                      **build_kw) -> HierBank:
    """Build a HierBank, or load it from a signature-checked archive
    (`retrieval_hier.py:3576-3626`).  A stale archive (another bank or other
    knobs) is rebuilt and overwritten, never served.  ``build_kw`` are
    `build_hier_bank`'s knobs."""
    sig_kw = {k: build_kw.get(k, d) for k, d in (
        ("bn", 512), ("gsz_sem", 8), ("gsz_geo", 64), ("gsz_super", 0),
        ("tier", "fast"), ("seed", 0), ("shards", 1),
        ("group_by", "key_value"), ("group_value_weight", 1.0),
        ("topk_gsz", 0), ("topk_lr", 0), ("tail_super", 0), ("sel_lr", 0))}
    sig = hier_build_signature(
        bank, lr_rank=build_kw.get("lr_rank") or 0,
        lr_geo=build_kw.get("lr_geo") or 0,
        res_rank=build_kw.get("res_rank") or 0, **sig_kw)
    if cache_path and os.path.exists(cache_path):
        got = peek_hier_build(cache_path)
        # the signature (the JAX package's) does not record the serving
        # values' dtype (int8 codes, bf16, or a ``value_dtype`` override):
        # an archive whose values are not the requested ones is stale too
        with np.load(cache_path) as z:
            got_v = json.loads(z["meta_json"].tobytes().decode())["dtypes"][
                "values"]
        want_v = ("int8" if bank.value_scale is not None else
                  _to_numpy(torch.empty(0, dtype=build_kw.get("value_dtype")
                                        or torch.bfloat16))[1])
        if got == sig and got_v == want_v:
            return load_hier_bank(cache_path, device=bank.device)
        logging.getLogger("range_tpu_torch").warning(
            "hier cache %s is stale (built %s, values %s; requested %s, "
            "values %s): rebuilding", cache_path, got, got_v, sig, want_v)
    hb = build_hier_bank(bank, **build_kw)
    if cache_path:
        save_hier_bank(hb, cache_path, build=sig)
    return hb


# ---------------------------------------------------------------------------
# serving glue: padding, the geographic query sort, tile selection


def _pad_queries(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor], bm: int):
    B = q_sem.shape[0]
    pad = _round_up(B, bm) - B
    q_s = torch.nn.functional.pad(q_sem.to(torch.float32), (0, 0, 0, pad))
    q_x = (torch.nn.functional.pad(q_xyz.to(torch.float32), (0, 0, 0, pad))
           if q_xyz is not None else None)
    return q_s, q_x


def _home_tile(m_s: torch.Tensor, t_real: int) -> torch.Tensor:
    """Per-query hottest REAL tile from scan stats [Bp, t_pad]
    (`retrieval_hier.py:2701-2708`).  Pad tiles' zero centroids score
    logit 0, which would win for queries whose real-tile logits are all
    negative: they are masked out.  The lowest index wins ties."""
    real = torch.arange(m_s.shape[1], device=m_s.device) < t_real
    return first_argmax(torch.where(real[None, :], m_s, float("-inf")))


def _hybrid_order(q_xyz: Optional[torch.Tensor], n_valid: int,
                  home: Optional[torch.Tensor] = None, t_pad: int = 0,
                  sort: str = "geo") -> torch.Tensor:
    """Query order with coherent bm-query blocks (`retrieval_hier.py:
    2720-2750`), padded rows last, stable argsort.  ``sort='geo'``: 12
    latitude bands x 4096 longitude bins.  ``sort='hybrid'``: 8 bands x 6
    longitude cells, then each cell's queries by their home tile
    (`_home_tile` of a stats scan): key = cell * (t_pad + 1) + home.  No
    locations: the home tile alone."""
    if q_xyz is None:
        key = home
    else:
        lat = torch.arcsin(torch.clamp(q_xyz[:, 2], -1, 1))
        lon = torch.atan2(q_xyz[:, 1], q_xyz[:, 0])
        nb, nl = (12, 4096) if sort == "geo" else (8, 6)
        band = torch.clamp(((lat / math.pi + 0.5) * nb).to(torch.int32), 0,
                           nb - 1)
        cell = band * nl + torch.clamp(
            ((lon / (2 * math.pi) + 0.5) * nl).to(torch.int32), 0, nl - 1)
        key = cell if sort == "geo" else cell * (t_pad + 1) + home
    rows = torch.arange(key.shape[0], device=key.device)
    key = torch.where(rows < n_valid, key, torch.iinfo(torch.int32).max)
    return torch.argsort(key, stable=True)


def select_tiles(m_s, s_s, m_g, s_g, *, t_real: int, k_tiles: int, bm: int,
                 n_valid: int, j_sem: int = 2, j_geo: int = 2,
                 mode: str = "range+"):
    """Tile selection from the scan stats [Bp, t_pad] f32
    (`retrieval_hier.py:1966-2022`): per-query top-j tiles by max group
    logit (rank weights j..1) unioned over each block of bm queries, then
    the tile's summed normalized exp-mass as priority.  The score
    ``sel * 1e9 + pri`` is rounded in f32 as in JAX (within a sel level,
    pri snaps to multiples of 64-256), and its first K under a stable
    descending sort reproduce `lax.top_k`'s lowest-index tie order.

    Returns (idx [nB, K] int32, distinct tiles; sel [nB, t_pad] f32, 1 at
    the selected tiles)."""
    Bp, t_pad = m_s.shape
    nB = Bp // bm
    k_tiles = min(k_tiles, t_real)
    dev = m_s.device
    row_valid = (torch.arange(Bp, device=dev) < n_valid)[:, None]
    col_real = (torch.arange(t_pad, device=dev) < t_real)[None, :]
    neg_inf = torch.tensor(float("-inf"), device=dev)

    def rank_weights(m, j):
        m = torch.where(col_real, m, neg_inf)
        w = torch.zeros_like(m)
        rem = m
        for _ in range(j):
            thr = torch.amax(rem, dim=1, keepdim=True)
            w = w + (m >= thr).to(torch.float32)
            rem = torch.where(rem >= thr, neg_inf, rem)
        w = torch.where(row_valid, w, 0.0)
        return torch.amax(w.reshape(nB, bm, t_pad), dim=1)

    def tile_mass(s):
        s = torch.where(col_real, s, 0.0)
        p = s / torch.clamp_min(s.sum(dim=1, keepdim=True), 1e-30)
        p = torch.where(row_valid, p, 0.0)
        return p.reshape(nB, bm, t_pad).sum(dim=1)

    sel = rank_weights(m_s, j_sem)
    pri = tile_mass(s_s)
    if mode == "range+":
        sel = torch.maximum(sel, rank_weights(m_g, j_geo))
        pri = pri + tile_mass(s_g)
    score = torch.where(col_real, sel * 1e9 + pri, neg_inf)
    _, idx = topk_stable(score, k_tiles)
    onehot = torch.zeros((nB, t_pad), dtype=torch.float32, device=dev)
    onehot.scatter_(1, idx, 1.0)
    return idx.to(torch.int32), onehot


def _gather_cols(stats: torch.Tensor, idx: torch.Tensor, bm: int
                 ) -> torch.Tensor:
    """stats [Bp, t_pad], idx [Bp / bm, M] -> [Bp, M]: each query's stats at
    its query block's listed tiles (`retrieval_hier.py:3030-3036`)."""
    return torch.gather(stats, 1, idx.long().repeat_interleave(bm, dim=0))


def _topk_budget(B: int, k_tiles: int, bm: int, j_sem: int):
    """Small-batch widening of the top-k endpoint's budget
    (`retrieval_hier.py:1832-1847`): selection tiles are shared by bm
    sorted queries, and a small batch spans too much sphere per block.
    bm 128 and 3x tiles / j+4 below 2,048 queries, 2x tiles / j+2 below
    8,192.  Returns (k_tiles, bm, j_sem)."""
    if B < 2048:
        return 3 * k_tiles, min(bm, 128), j_sem + 4
    if B < 8192:
        return 2 * k_tiles, min(bm, 128), j_sem + 2
    return k_tiles, bm, j_sem


# ---------------------------------------------------------------------------
# kernel wrappers and their plain versions


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_cuda(name: str, tensors: dict, dtypes: dict) -> None:
    """Raise unless every tensor lies on CUDA with its expected dtype."""
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        if t.dtype != dtypes[key]:
            raise ValueError(f"{name} kernel: {key} must be {dtypes[key]}, "
                             f"got {t.dtype}")


def _launch(name: str, fn: str, *args) -> None:
    from ..kernels._build import load_kernel_library

    rc = getattr(load_kernel_library(name), fn)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


# The CUDA-core body (`csrc/hier_cores.cu`): every form of kernels 8, 9 and
# 12-15 whose operands are f32 (the `exact` tier) or whose logits are deeper
# than the other bodies' 256 columns (the `high` tier), composed from its
# kernels, the group pass (with its segments' fold) and the row pass
CORES_DEPTH = 256  # logit columns the Hopper and mma.sync bodies take at most
CORES_NC = 512  # output columns of a CUDA-core block (a slice)
_CORES_DT = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}


def _cores_smem(depth: int, ltc: bool, vtc: bool, values: bool, K: int) -> int:
    """Shared memory of a CUDA-core block (`layout` in `csrc/hier_cores.cu`):
    the 64-query block resident over every logit column (bf16 with ``ltc``,
    else f32), a ring of 3 operand pieces of 32 rows x 64 columns, the
    logit and weight tiles, the chunk's 32 value rows of 520 columns (bf16
    with ``vtc``) where there are ``values``, and the list of K entries."""
    es = 2 if ltc else 4
    pad = 8 if ltc else 4
    dp = -(-depth // 64) * 64
    return (64 * (dp + pad) * es + 3 * 32 * (64 + pad) * es + 2 * 64 * 36 * 4
            + (32 * 520 * (2 if vtc else 4) if values else 0) + 4 * 32 + 8 * K)


def _cores_fits(name: str, depth: int, ltc: bool, vtc: bool, values: bool, K: int) -> None:
    """Raise unless the block's shared memory fits the card's (the launch
    refuses it): f32 logits over about 450 columns, bf16 ones over ~1,290."""
    if _cores_smem(depth, ltc, vtc, values, K) > _SM90_MAX_SMEM:
        raise ValueError(f"{name} kernel (CUDA cores): {depth} logit columns "
                         f"({'bf16' if ltc else 'f32'}) do not fit a block's shared memory")


def _cores_form(depth: int, *ops) -> Optional[str]:
    """The CUDA-core form a launch takes: "f32" when an operand is f32,
    "deep" when its logits read more than `CORES_DEPTH` columns, else None
    (the function's own body)."""
    if any(t is not None and t.dtype == torch.float32 for t in ops):
        return "f32"
    return "deep" if depth > CORES_DEPTH else None


def _cores_check(name: str, ops: dict) -> None:
    """Raise unless every operand lies on CUDA in a dtype the body takes:
    bf16 or f32 (int8 for value codes), int32 lists and f32 masks."""
    for key, t in ops.items():
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, not CUDA")
        ok = ((torch.int32,) if key == "idx" else (torch.float32,)
              if key in ("mask_neg", "scale") else
              (torch.bfloat16, torch.float32, torch.int8) if key == "values"
              else (torch.bfloat16, torch.float32))
        if t.dtype not in ok:
            raise ValueError(f"{name} kernel: {key} must be one of {ok}, got {t.dtype}")


def _cores_groups(q, g, *, wk: int, gpt: int, out=None, idx=None, bm: int = 64,
                  n_tiles: int = 0, qc0: int = 0, stats=None, vw=None, sup: int = 1,
                  nvc: int = 0, oc0: int = 0, cntc: int = -1, dcol: int = -1,
                  ps=None, mode: int = 0, lrr: int = 0, sign: float = 1.0,
                  accumulate: bool = False, dedup: bool = False, n_seg: int = 1) -> None:
    """One launch of the CUDA-core group pass (`groups_kernel`): over each
    64 queries' list row of ``idx`` [Bp / bm, K] (None: every one of
    ``n_tiles`` tiles), the group logits q[:, qc0:qc0 + wk] . g[:, :wk]; into
    ``stats`` (m, s) [Bp, K] each entry's max and sum of p; with ``vw``, E
    (p; mode 1: p - ps / cnt, 2: ps / cnt - p, cnt = vw[:, lrr]; summed over
    ``sup`` groups) rounded to vw's dtype, and out[:, oc0:oc0 + nvc] (=, or
    += with ``accumulate``) sign * E @ vw[:, :nvc], vw column ``cntc`` into
    out column ``dcol``.  ``n_seg`` > 1 splits each block's entries into
    that many segments, a block each, whose partial products a work buffer
    holds until `fold_kernel` adds them in order.  Contiguous operands;
    nothing counted."""
    Bp = q.shape[0]
    K = idx.shape[1] if idx is not None else n_tiles
    _cores_fits("hier_groups", wk, q.dtype == g.dtype == torch.bfloat16,
                vw is not None and vw.dtype == torch.bfloat16, vw is not None,
                K if idx is not None else 0)
    work = (torch.empty((n_seg, Bp, nvc), dtype=torch.float32, device=q.device)
            if n_seg > 1 and vw is not None else None)
    held = [q.contiguous(), g.contiguous(),
            None if idx is None else idx.contiguous(),
            *(stats if stats is not None else (None, None)),
            None if vw is None else vw.contiguous(), ps, out, work]
    ptrs = (ctypes.c_void_p * 9)(*[None if t is None else t.data_ptr() for t in held])
    m = stats[0] if stats is not None else None
    ints = [Bp, _CORES_DT[q.dtype], q.shape[1], qc0, wk, _CORES_DT[g.dtype], g.shape[1], K,
            bm, int(dedup), gpt, 0 if m is None else m.shape[1],
            _CORES_DT[vw.dtype] if vw is not None else 0,
            0 if vw is None else vw.shape[1], sup, nvc, cntc, dcol,
            0 if ps is None else ps.shape[1], mode, lrr, int(accumulate),
            0 if out is None else out.shape[1], oc0, n_seg]
    _launch("hier_cores", "hier_groups_launch", ptrs, (ctypes.c_int * len(ints))(*ints),
            sign, _stream(q))


def _cores_rows(q, k, mask_neg, idx, x, out, *, kf: int, bm: int, bn: int, qc0: int = 0,
                kc0: int = 0, scale=None, oc0: int = 0, dcol: int = -1, rr: bool = False,
                ps=None, gsz: int = 1, accumulate: bool = False, dedup: bool = False) -> None:
    """One launch of the CUDA-core row pass (`rows_kernel`): over each 64
    queries' list row of ``idx``, the row logits q[:, qc0:qc0 + kf] .
    k[:, kc0:kc0 + kf] + mask, p; d = sum of p into out column ``dcol``; the
    weight (p, p * scale with int8 codes; with ``rr`` p itself, whose
    segment sums over gsz rows go to ``ps`` [Bp, K bn / gsz]) rounded to
    x's dtype, and out[:, oc0:oc0 + x's width] (=, or += with
    ``accumulate``) weight @ x.  Nothing counted."""
    Bp, nx = q.shape[0], x.shape[1]
    _cores_fits("hier_rows", kf, q.dtype == k.dtype == torch.bfloat16,
                x.dtype != torch.float32, True, idx.shape[1])
    held = [q.contiguous(), k.contiguous(), mask_neg.contiguous(), idx.contiguous(),
            x.contiguous(), None if scale is None else scale.contiguous(), ps, out]
    ptrs = (ctypes.c_void_p * 8)(*[None if t is None else t.data_ptr() for t in held])
    ints = [Bp, _CORES_DT[q.dtype], q.shape[1], qc0, kf, _CORES_DT[k.dtype], k.shape[1], kc0,
            idx.shape[1], bm, bn, int(dedup), _CORES_DT[x.dtype], x.shape[1], nx, int(rr),
            0 if ps is None else ps.shape[1], gsz, int(accumulate), out.shape[1], oc0, dcol]
    _launch("hier_cores", "hier_rows_launch", ptrs, (ctypes.c_int * len(ints))(*ints),
            _stream(q))


def _cores_segments(Bp: int, n_slices: int, K: int) -> int:
    """Segments of a group pass without a list (the scans: every one of K
    tiles for each 64 queries): enough blocks for about four waves of the
    CUDA-core body's one block an SM, each segment at least 4 tiles."""
    blocks = -(-Bp // 64) * n_slices
    return max(1, min(-(-4 * SM90_SMS // blocks), K // 4))


def _count_cores(fn, form: str) -> None:
    """Count one launch of a wrapper's CUDA-core form."""
    fn.launches += 1
    setattr(fn, f"{form}_launches", getattr(fn, f"{form}_launches") + 1)


def _hier_scan_plain(q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw, *,
                     gpt_s: int, gpt_g: int, has_geo: bool = True,
                     sup_r: int = 0, chunk: int = 2048):
    """Plain version of the scan kernel (`_hier_scan_kernel`,
    `retrieval_hier.py:1443-1515`): per family, group logits of the
    family's query columns (sem: the first ws, geo: the last wg) against
    the slim centroids; per tile the max logit and the sum of
    exp2(min(l, 86)); the tail  bf16(exp2(...)) @ vw  in f32.
    ``has_geo=False`` (RANGE mode) computes the sem family only and returns
    (m_s, s_s, None, None, tails [Bp, Ws]): what that mode reads.
    ``sup_r > 0`` (tail_super banks): ``g_sem_vw`` is the supergroup operand
    g_sem_ts_vw with G_s / sup_r rows, and the sem tail is
    bf16(sum of sup_r consecutive f32 exp2) @ g_sem_vw: the f32 sums are
    rounded once, not each term (`retrieval_hier.py:1489-1497`)."""
    f32 = torch.float32
    cat_d = q_cat.shape[1]
    ws, wg = g_sem_cat.shape[1], g_geo_cat.shape[1]
    fams = [(g_sem_cat.to(f32), g_sem_vw, slice(0, ws), gpt_s, sup_r)]
    if has_geo:
        fams.append((g_geo_cat.to(f32), g_geo_vw, slice(cat_d - wg, cat_d),
                     gpt_g, 0))
    stats = [[], [], [], []]
    tails = []
    for lo in range(0, q_cat.shape[0], chunk):
        q = q_cat[lo:lo + chunk].to(f32)
        tail = []
        for f, (g, vw, cols, gpt, r) in enumerate(fams):
            m, s, e = _family_stats(q[:, cols], g, gpt)
            stats[2 * f].append(m)
            stats[2 * f + 1].append(s)
            if r:
                e = e.reshape(e.shape[0], -1, r).sum(dim=2)
            tail.append(e.to(vw.dtype).to(f32) @ vw.to(f32))
        tails.append(torch.cat(tail, 1))
    return tuple(torch.cat(s) if s else None for s in stats) + (
        torch.cat(tails),)


def _family_stats(q: torch.Tensor, g: torch.Tensor, gpt: int):
    """One family's group logits l = q @ g^T (f32) and per tile of gpt
    groups: (max l, sum exp2(min(l, 86)), and the exponentials)."""
    logit = q @ g.T
    e = torch.exp2(torch.clamp_max(logit, CLAMP2))
    b, t_pad = q.shape[0], g.shape[0] // gpt
    return (torch.amax(logit.reshape(b, t_pad, gpt), dim=2),
            e.reshape(b, t_pad, gpt).sum(dim=2), e)


def _hier_scan_stats_plain(q_cat, g_sem_cat, g_geo_cat, *, gpt_s: int,
                           gpt_g: int, chunk: int = 2048):
    """Plain version of the stats-only scan (`_hier_scan_stats_kernel`,
    `retrieval_hier.py:1582-1603`): `_hier_scan_plain`'s four stats, the
    same arithmetic, without the tail."""
    f32 = torch.float32
    cat_d = q_cat.shape[1]
    ws, wg = g_sem_cat.shape[1], g_geo_cat.shape[1]
    fams = [(g_sem_cat.to(f32), slice(0, ws), gpt_s),
            (g_geo_cat.to(f32), slice(cat_d - wg, cat_d), gpt_g)]
    stats = [[], [], [], []]
    for lo in range(0, q_cat.shape[0], chunk):
        q = q_cat[lo:lo + chunk].to(f32)
        for f, (g, cols, gpt) in enumerate(fams):
            m, s, _ = _family_stats(q[:, cols], g, gpt)
            stats[2 * f].append(m)
            stats[2 * f + 1].append(s)
    return tuple(torch.cat(s) for s in stats)


def _gpt_ok(gpt: int) -> bool:
    """Groups per tile the scan kernels walk: 8, 16, 32 or a multiple of
    32 (a tile ends inside one 32-group step or on a step boundary)."""
    return gpt % 8 == 0 and (32 % gpt == 0 if gpt <= 32 else gpt % 32 == 0)


# The Hopper scan's plan (`csrc/hier_scan_sm90.cu`)
SCAN_ROWS_MAX = 12_800   # tail rows one accumulation chain sums (PR 10's bound)
_SCAN_SLICE_BOXES = 9    # 64-column boxes of a block's tail slice: 3 tail warpgroups x 3


class ScanFamily(NamedTuple):
    """One family's share of the scan: ``n_sl`` column slices of
    ``sl_boxes`` 64-column boxes (the last one ragged), ``n_seg`` segments
    of ``seg_tiles`` tiles (the last one ragged), one block each per
    64-query block."""
    n_sl: int
    sl_boxes: int
    n_seg: int
    seg_tiles: int


class ScanPlan(NamedTuple):
    """``bn`` groups a step, ``gs`` / ``vs`` stages of the centroid and
    value rings, and each family's `ScanFamily` (sem first)."""
    bn: int
    gs: int
    vs: int
    fams: Tuple[ScanFamily, ...]


def _scan_rows(bn: int, sup: int) -> int:
    """Tail rows a step puts in shared memory: bn / sup, at least one k16
    step (the p columns past bn / sup stay zero)."""
    return max(16, bn // sup)


def _scan_smem(bn: int, gs: int, vs: int, kb: int, sl_boxes: int, rv: int) -> int:
    """One block's shared memory (`layout` in the kernel's source): the
    query block, gs centroid tiles, vs value tiles of the slice, two p
    tiles, the barriers."""
    return (kb * 64 * 128 + gs * kb * bn * 128 + vs * sl_boxes * rv * 128
            + 2 * (rv // 16) * 2048 + 8 * (1 + 2 * gs + 2 * vs + 4) + 1024)


def _scan_segments(T: int, gpt: int, sup: int, bn: int, want: int,
                   rows_max: int, up: bool = False) -> Tuple[int, int]:
    """(segments, tiles a segment) cutting T tiles into about ``want``
    segments of whole steps (whole tiles where a tile is a step or longer:
    T / want rounded down to them, or ``up``), none over ``rows_max`` tail
    rows, the tiles spread evenly (the last segment ragged)."""
    a = math.lcm(gpt, bn) // gpt                     # tiles of whole steps
    cap = max(a, rows_max // (gpt // sup) // a * a)  # the chain bound
    tps = T / max(1, want) / a
    tps = min(cap, a * max(1, math.ceil(tps) if up else math.floor(tps)))
    n = -(-T // tps)
    tps = -(-(-(-T // n)) // a) * a
    return -(-T // tps), tps


def _makespan(blocks, sms: int) -> float:
    """The last finish when ``blocks`` (their costs, in launch order) go
    one at a time to the first free SM: how the card schedules a grid of
    blocks that each fill an SM."""
    free = [0.0] * sms
    for c in blocks:
        heapq.heappush(free, heapq.heappop(free) + c)
    return max(free)


@functools.lru_cache(maxsize=256)
def _scan_plan(Bp: int, fams: tuple, rows_max: int = SCAN_ROWS_MAX) -> ScanPlan:
    """The Hopper scan's tiles, rings, slices and segments: a function of
    the shape alone, ``fams`` one (G, wk, W, gpt, sup) a family, sem first
    (groups, logit depth, tail width, groups a tile, groups a tail row).

    Slices: a tail of up to 9 boxes of 64 columns (576) is one slice, a
    wider one (the full-width 1,152) the fewest slices of equal width.
    Steps of 32 groups (the kernel's BN) with the deepest centroid and
    value rings that fit in a block's shared memory (4 + 4 stages, else
    3 + 4 or 3 + 3: the centroid ring runs gs - 2 steps ahead of the
    logits, so at least 3).
    Segments: whole tiles (whole steps where a tile is shorter than a
    step), none over ``rows_max`` tail rows (one wgmma accumulation chain).
    Their number: for k = 1, 2, 3, 4, 6, 8 waves of blocks of U / (132 k)
    work each (U the request's: groups times logit and tail columns), the
    segments rounded down or up to whole steps, the cut whose blocks, in
    launch order on the card's 132 SMs, finish first, each block counted
    two steps of fixed cost (its prologue, its tail's write-out); a cut
    that gives every SM a block comes before one that does not.
    lru-cached: serving asks for the same few shapes."""
    n_qb = -(-Bp // 64)
    shapes = []
    for G, wk, W, gpt, sup in fams:
        boxes = W // 64
        n_sl = -(-boxes // _SCAN_SLICE_BOXES)
        shapes.append((G // gpt, -(-wk // 64), gpt, sup, n_sl, -(-boxes // n_sl)))
    for bn, gs, vs in ((32, 4, 4), (32, 3, 4), (32, 3, 3)):
        if all(_scan_smem(bn, gs, vs, kb, slb, _scan_rows(bn, sup)) <= _SM90_MAX_SMEM
               for _, kb, _, sup, _, slb in shapes):
            break
    else:
        raise ValueError(f"hier_scan kernel: no tiles for {fams} fit in a "
                         "block's shared memory")
    # a tile's work in one slice: its logits and its share of the slice's tail
    tile_work = [gpt * 64 * (kb + slb // sup) for _, kb, gpt, sup, _, slb in shapes]
    U = n_qb * sum(T * n_sl * w for (T, _, _, _, n_sl, _), w in zip(shapes, tile_work))
    best = None
    for k, up in itertools.product((1, 2, 3, 4, 6, 8), (False, True)):
        segs = [_scan_segments(T, gpt, sup, bn, math.ceil(T * w * SM90_SMS * k / U),
                               rows_max, up)
                for (T, _, gpt, sup, _, _), w in zip(shapes, tile_work)]
        costs = []
        for (T, _, gpt, _, n_sl, _), w, (n, tps) in zip(shapes, tile_work, segs):
            fixed = 2 * w * bn / gpt  # two steps
            for seg in range(n):
                costs += [min(tps, T - seg * tps) * w + fixed] * (n_qb * n_sl)
        # fill the card where the tiles allow it, then finish first
        key = (len(costs) < SM90_SMS, _makespan(costs, SM90_SMS), len(costs))
        if best is None or key < best[0]:
            best = (key, segs)
    out = tuple(ScanFamily(n_sl, slb, n, tps)
                for (_, _, _, _, n_sl, slb), (n, tps) in zip(shapes, best[1]))
    return ScanPlan(bn, gs, vs, out)


def _hier_scan_stats_call(q_cat, g_sem_cat, g_geo_cat, *, gpt_s: int,
                          gpt_g: int):
    """The stats-only group scan: (m_s, s_s, m_g, s_g) [Bp, t_pad] f32.

    CPU tensors: `_hier_scan_stats_plain`.  CUDA tensors:
    `csrc/hier_scan_stats.cu`, which replaces `_hier_scan_stats_kernel`
    (`range_tpu/ops/retrieval_hier.py:1582`), on bf16 operands whose query
    block and group tiles fit its shared memory (`_stats_smem`: up to 864
    logit columns, the `high` tier's 768 included); f32 operands, and
    deeper bf16 ones, on the CUDA-core body.  Launches of f32 operands also
    count in ``.f32_launches``, of logits deeper than 256 columns in
    ``.deep_launches``.  A shape the kernel does not take or a failed
    launch raises."""
    if q_cat.device.type == "cpu":
        return _hier_scan_stats_plain(q_cat, g_sem_cat, g_geo_cat,
                                      gpt_s=gpt_s, gpt_g=gpt_g)
    ops = dict(q_cat=q_cat, g_sem_cat=g_sem_cat, g_geo_cat=g_geo_cat)
    depth = max(g_sem_cat.shape[1], g_geo_cat.shape[1])
    form = _cores_form(depth, *ops.values())
    if form == "f32" or _stats_smem(depth) > _SM90_MAX_SMEM:
        return _scan_cores(form, q_cat, g_sem_cat, g_geo_cat, None, None, gpt_s=gpt_s,
                           gpt_g=gpt_g)
    _check_cuda("hier_scan_stats", ops, dict.fromkeys(ops, torch.bfloat16))
    Bp, cat_d = q_cat.shape
    (Gs, ws), (Gg, wg) = g_sem_cat.shape, g_geo_cat.shape
    t_pad = Gs // gpt_s
    if (not _gpt_ok(gpt_s) or not _gpt_ok(gpt_g) or Gs != t_pad * gpt_s
            or Gg != t_pad * gpt_g or Gs % 32 or Gg % 32 or ws % 16 or wg % 16
            or ws > cat_d or wg > cat_d or cat_d % 8):
        raise ValueError(
            f"hier_scan_stats kernel: unsupported shapes q "
            f"{tuple(q_cat.shape)}, g_sem {tuple(g_sem_cat.shape)}, g_geo "
            f"{tuple(g_geo_cat.shape)}, gpt {gpt_s} / {gpt_g}")
    ops = [t.contiguous() for t in ops.values()]
    stats = [torch.empty((Bp, t_pad), dtype=torch.float32, device=q_cat.device)
             for _ in range(4)]
    if Bp:
        _launch("hier_scan_stats", "hier_scan_stats_launch",
                *[t.data_ptr() for t in ops + stats], Bp, cat_d, ws, wg, Gs,
                Gg, gpt_s, gpt_g, t_pad, _stream(q_cat))
        _hier_scan_stats_call.launches += 1
        if form:  # deep
            _hier_scan_stats_call.deep_launches += 1
    return tuple(stats)


def _stats_smem(wk: int) -> int:
    """The stats kernel's shared memory at logit depth wk (`layout` in
    `csrc/hier_scan_stats.cu`): the 64-query block and two 32-group tiles
    of wk + 8 bf16 columns, and the f32 logit tile."""
    return 64 * (wk + 8) * 2 + 2 * 32 * (wk + 8) * 2 + 64 * 33 * 4


_hier_scan_stats_call.launches = 0
_hier_scan_stats_call.f32_launches = 0
_hier_scan_stats_call.deep_launches = 0


def _scan_cores_shapes(q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw, *, gpt_s: int,
                       gpt_g: int, has_geo: bool = True, sup_r: int = 0) -> int:
    """t_pad of a scan on the CUDA-core body; raises on a shape it does not
    take (what `hier_groups_launch` refuses)."""
    cat_d = q_cat.shape[1]
    t_pad = g_sem_cat.shape[0] // max(gpt_s, 1)
    fams = [(g_sem_cat, g_sem_vw, gpt_s, sup_r or 1)]
    if has_geo:
        fams.append((g_geo_cat, g_geo_vw, gpt_g, 1))
    bad = sup_r < 0 or sup_r == 1 or t_pad < 1
    for g, vw, gpt, sup in fams:
        bad = bad or (gpt < 1 or g.shape[0] != t_pad * gpt or not 0 < g.shape[1] <= cat_d
                      or 32 % sup or gpt % sup
                      or (vw is not None and vw.shape[0] * sup != g.shape[0]))
    if bad:
        raise ValueError(
            f"hier_scan kernel (CUDA cores): unsupported shapes q {tuple(q_cat.shape)}, "
            f"g_sem {tuple(g_sem_cat.shape)}, g_geo {tuple(g_geo_cat.shape)}, gpt "
            f"{gpt_s} / {gpt_g}, sup_r={sup_r}")
    return t_pad


def _scan_cores(form: str, q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw, *,
                gpt_s: int, gpt_g: int, has_geo: bool = True, sup_r: int = 0):
    """The two scans on the CUDA-core body, a group pass a family: (m_s,
    s_s, m_g, s_g), and without ``g_sem_vw`` (the stats scan) nothing more,
    else the tails [Bp, Ws (+ Wg)] too; counted in the scan's counters."""
    ops = dict(q_cat=q_cat, g_sem_cat=g_sem_cat, g_sem_vw=g_sem_vw)
    if has_geo:
        ops.update(g_geo_cat=g_geo_cat, g_geo_vw=g_geo_vw)
    tails = g_sem_vw is not None
    name = "hier_scan" if tails else "hier_scan_stats"
    _cores_check(name, ops)
    t_pad = _scan_cores_shapes(q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw, gpt_s=gpt_s,
                               gpt_g=gpt_g, has_geo=has_geo, sup_r=sup_r)
    Bp, cat_d = q_cat.shape
    dev = q_cat.device
    stats = [torch.empty((Bp, t_pad), dtype=torch.float32, device=dev)
             for _ in range(4 if has_geo else 2)]
    Ws = g_sem_vw.shape[1] if tails else 0
    Wg = g_geo_vw.shape[1] if tails and has_geo else 0
    out = torch.empty((Bp, Ws + Wg), dtype=torch.float32, device=dev) if tails else None
    if not Bp:
        return tuple(stats) + ((out,) if tails else ())
    fams = [(g_sem_cat, g_sem_vw, gpt_s, sup_r or 1, 0, 0, Ws)]
    if has_geo:
        fams.append((g_geo_cat, g_geo_vw, gpt_g, 1, cat_d - g_geo_cat.shape[1], Ws, Wg))
    for f, (g, vw, gpt, sup, qc0, oc0, W) in enumerate(fams):
        _cores_groups(q_cat, g, wk=g.shape[1], gpt=gpt, n_tiles=t_pad, qc0=qc0,
                      stats=stats[2 * f:2 * f + 2], vw=vw, sup=sup, nvc=W, out=out, oc0=oc0,
                      n_seg=_cores_segments(Bp, -(-W // CORES_NC) if tails else 1, t_pad))
    fn = _hier_scan_call if tails else _hier_scan_stats_call
    _count_cores(fn, form)
    return tuple(stats) + ((out,) if tails else ())


def _scan_shapes(q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw, *, gpt_s: int,
                 gpt_g: int, has_geo: bool = True, sup_r: int = 0) -> tuple:
    """The scan plan's families, (G, wk, W, gpt, sup) each, sem first;
    raises on a shape the kernel does not take."""
    cat_d = q_cat.shape[1]
    Gs, ws = g_sem_cat.shape
    t_pad = Gs // gpt_s
    if sup_r and (sup_r < 2 or 32 % sup_r or gpt_s % sup_r):
        raise ValueError(f"hier_scan kernel: sup_r={sup_r} must divide the "
                         f"32-group step and gpt_s={gpt_s}")
    fams = [(gpt_s, Gs, ws, g_sem_vw.shape[1], g_sem_vw, sup_r or 1)]
    if has_geo:
        fams.append((gpt_g, *g_geo_cat.shape, g_geo_vw.shape[1], g_geo_vw, 1))
    for gpt, G, w, W, vw, r in fams:
        if not _gpt_ok(gpt):
            raise ValueError(f"hier_scan kernel: groups per tile {gpt} must "
                             "be 8, 16, 32 or a multiple of 32")
        if (G != t_pad * gpt or G % 32 or vw.shape[0] * r != G or w > 256
                or w % 16 or w > cat_d or cat_d % 8 or W % 128):
            raise ValueError(
                f"hier_scan kernel: unsupported shapes q {tuple(q_cat.shape)}"
                f", g_sem {tuple(g_sem_cat.shape)}, g_geo "
                f"{tuple(g_geo_cat.shape)}, vw {tuple(g_sem_vw.shape)} / "
                f"{tuple(g_geo_vw.shape)}")
    return tuple((G, w, W, gpt, r) for gpt, G, w, W, _, r in fams)


def _launch_scan_sm90(q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw, *,
                      gpt_s: int, gpt_g: int, has_geo: bool = True,
                      sup_r: int = 0, plan: Optional[ScanPlan] = None):
    """Launch `csrc/hier_scan_sm90.cu` (and its segment reduction) on bf16
    CUDA operands: `_hier_scan_call`'s outputs, counted nowhere.  ``plan``
    defaults to `_scan_plan`'s."""
    bf = torch.bfloat16
    ops = dict(q_cat=q_cat, g_sem_cat=g_sem_cat, g_sem_vw=g_sem_vw)
    if has_geo:
        ops.update(g_geo_cat=g_geo_cat, g_geo_vw=g_geo_vw)
    _check_cuda("hier_scan", ops, dict.fromkeys(ops, bf))
    fams = _scan_shapes(q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw,
                        gpt_s=gpt_s, gpt_g=gpt_g, has_geo=has_geo, sup_r=sup_r)
    Bp, cat_d = q_cat.shape
    t_pad = g_sem_cat.shape[0] // gpt_s
    dev = q_cat.device
    stats = [torch.empty((Bp, t_pad), dtype=torch.float32, device=dev)
             for _ in range(4 if has_geo else 2)]
    tails = torch.empty((Bp, sum(f[2] for f in fams)), dtype=torch.float32,
                        device=dev)
    if not Bp:
        return stats, tails
    plan = plan or _scan_plan(Bp, fams)
    work = sum(f.n_seg * Bp * W for f, (_, _, W, _, _) in zip(plan.fams, fams)
               if f.n_seg > 1)
    work = torch.empty(work, dtype=torch.float32, device=dev) if work else None
    q, gs, vs = (t.contiguous() for t in (q_cat, g_sem_cat, g_sem_vw))
    gg, vg = ((g_geo_cat.contiguous(), g_geo_vw.contiguous()) if has_geo
              else (None, None))
    ptr = [None if t is None else t.data_ptr() for t in (
        q, gs, gg, vs, vg, *stats[:2], *(stats[2:] or [None, None]), tails,
        work)]
    fam_plan = [v for f in plan.fams for v in f] + [0] * 4 * (2 - len(plan.fams))
    _launch("hier_scan_sm90", "hier_scan_sm90_launch", *ptr, Bp, cat_d,
            g_sem_cat.shape[1], g_geo_cat.shape[1], g_sem_cat.shape[0],
            g_geo_cat.shape[0], fams[0][2], fams[1][2] if has_geo else 0,
            gpt_s, gpt_g, t_pad, int(has_geo), sup_r, plan.bn, plan.gs,
            plan.vs, *fam_plan, _stream(q_cat))
    return stats, tails


def _hier_scan_call(q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw, *,
                    gpt_s: int, gpt_g: int, has_geo: bool = True,
                    sup_r: int = 0):
    """The fused group scan: (m_s, s_s, m_g, s_g [Bp, t_pad] f32, tails
    [Bp, Ws + Wg] f32).  ``has_geo=False`` (RANGE mode): (m_s, s_s, None,
    None, tails [Bp, Ws]), the geo operands untouched.  ``sup_r > 0``: the
    segment-sum variant of tail_super banks (`_hier_scan_plain`), which
    also counts in ``.sup_launches``.  Tails wider than 512 columns (the
    full-width group value sums, Dv + 128) also count in
    ``.wide_launches``.

    CPU tensors: `_hier_scan_plain`.  CUDA tensors: the Hopper kernel
    `csrc/hier_scan_sm90.cu` over `_scan_plan`'s segments, which replaces
    `_hier_scan_kernel` (`range_tpu/ops/retrieval_hier.py:1443`), on bf16
    operands of at most 256 logit columns; f32 operands (the `exact` tier)
    and deeper logits (`high`) on the CUDA-core body `csrc/hier_cores.cu`
    (`_cores_form`), counted in ``.f32_launches`` / ``.deep_launches`` and
    not in the Hopper body's ``.sup_launches`` / ``.wide_launches``.  A
    shape the kernel does not take or a failed launch raises.
    The TPU tiling knobs (bm, tc) have no counterpart: they only set
    speed."""
    if q_cat.device.type == "cpu":
        return _hier_scan_plain(q_cat, g_sem_cat, g_geo_cat, g_sem_vw,
                                g_geo_vw, gpt_s=gpt_s, gpt_g=gpt_g,
                                has_geo=has_geo, sup_r=sup_r)
    geo_ops = (g_geo_cat, g_geo_vw) if has_geo else ()
    form = _cores_form(max(g_sem_cat.shape[1], g_geo_cat.shape[1] if has_geo else 0),
                       q_cat, g_sem_cat, g_sem_vw, *geo_ops)
    if form:
        out = _scan_cores(form, q_cat, g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw,
                          gpt_s=gpt_s, gpt_g=gpt_g, has_geo=has_geo, sup_r=sup_r)
        return out if has_geo else out[:2] + (None, None, out[2])
    stats, tails = _launch_scan_sm90(q_cat, g_sem_cat, g_geo_cat, g_sem_vw,
                                     g_geo_vw, gpt_s=gpt_s, gpt_g=gpt_g,
                                     has_geo=has_geo, sup_r=sup_r)
    if q_cat.shape[0]:
        _hier_scan_call.launches += 1
        if sup_r:
            _hier_scan_call.sup_launches += 1
        if max(g_sem_vw.shape[1], g_geo_vw.shape[1] if has_geo else 0) > 512:
            _hier_scan_call.wide_launches += 1
    if not has_geo:
        stats += [None, None]
    return tuple(stats) + (tails,)


_hier_scan_call.launches = 0
_hier_scan_call.sup_launches = 0
_hier_scan_call.wide_launches = 0
_hier_scan_call.f32_launches = 0
_hier_scan_call.deep_launches = 0


def _block_groups(tiles: torch.Tensor, gpt: int) -> torch.Tensor:
    """The group rows [M * gpt] of a block's tile list [M], in list order."""
    return (tiles.long()[:, None] * gpt
            + torch.arange(gpt, device=tiles.device)).reshape(-1)


def _hier_refine_plain(q_cat, idx, g_sem_cat, *, bm: int, gpt_f: int,
                       g_sup_cat=None, g_sem_vw=None, g_sup_vw=None,
                       gpt_sup: int = 0, magnitude: bool = False):
    """Plain version of the refine kernel (`_hier_refine_kernel`,
    `retrieval_hier.py:2077-2133`): per query block and each of its M
    listed tiles, the fine group logits q[:, :wf] . g^T (wf = g_sem_cat's
    width) over the tile's gpt_f groups, their max and the sum of
    exp2(min(l, 86)).  Returns (m_f, s_f) [Bp, M] f32, column j the
    block's j-th listed tile: `_hier_scan_stats_plain`'s sem stats at those
    tiles.

    With ``g_sem_vw`` (the has_parts form) also the fine-minus-supergroup
    tail partial over the listed tiles, [Bp, Dvp] f32 (count column at Dv):
    bf16(exp2(min(l_f, 86))) @ g_sem_vw[tile groups] - bf16(exp2(min(q .
    g_sup, 86))) @ g_sup_vw[tile's gpt_sup supergroups], returned third.
    ``magnitude=True`` sums the terms' magnitudes instead (|vw| and the
    two products added): the per-element scale that a bf16 rounding point
    landing the other way is measured against."""
    f32 = torch.float32
    nB, M = idx.shape
    wf = g_sem_cat.shape[1]
    m_f, s_f, parts = [], [], []
    for i in range(nB):
        grps = _block_groups(idx[i], gpt_f)
        q = q_cat[i * bm:(i + 1) * bm].to(f32)
        m, s, e = _family_stats(q[:, :wf], g_sem_cat[grps].to(f32), gpt_f)
        m_f.append(m)
        s_f.append(s)
        if g_sem_vw is None:
            continue
        sup = _block_groups(idx[i], gpt_sup)
        ls = q[:, :g_sup_cat.shape[1]] @ g_sup_cat[sup].to(f32).T
        es = torch.exp2(torch.clamp_max(ls, CLAMP2)).to(g_sup_vw.dtype).to(f32)
        ef = e.to(g_sem_vw.dtype).to(f32)
        vf, vs = g_sem_vw[grps].to(f32), g_sup_vw[sup].to(f32)
        parts.append(ef @ vf.abs() + es @ vs.abs() if magnitude
                     else ef @ vf - es @ vs)
    return (torch.cat(m_f), torch.cat(s_f)) + (
        (torch.cat(parts),) if g_sem_vw is not None else ())


def _hier_refine_call(q_cat, idx, g_sem_cat, g_sup_cat, g_sem_vw, g_sup_vw,
                      *, bm: int, gpt_f: int, gpt_sup: int,
                      stats_only: bool = False):
    """Fine stats over each query block's M listed tiles: (m_f, s_f [Bp, M]
    f32, parts).  q_cat [Bp, cat_d], idx [Bp / bm, M] int32 (real tiles, as
    `select_tiles` gives them), g_sem_cat [G, wf].  The stats-only form
    reads neither the supergroup centroids nor any value operand and
    returns parts None.  ``stats_only=False`` (the has_parts form, the
    two-level feature path) also returns the fine-minus-supergroup tail
    partial [Bp, Dvp] f32 over the listed tiles (g_sup_cat [G / (gpt_f /
    gpt_sup), ws], g_sem_vw [G, Dvp], g_sup_vw [G_sup, Dvp]).

    CPU tensors: `_hier_refine_plain`.  CUDA tensors: `csrc/hier_refine.cu`,
    which replaces `_hier_refine_kernel` (`range_tpu/ops/retrieval_hier.py:
    2077`), on bf16 operands of at most 256 logit columns; f32 operands and
    deeper logits on the CUDA-core body (`_refine_cores`, counted in
    ``.f32_launches`` / ``.deep_launches``, not ``.parts_launches``).  A
    shape the kernel does not take or a failed launch raises.  The stats come
    out in [query, column] order: the TPU's one-hot scratch and its 2 Mp
    packing have no counterpart.  has_parts launches also count in
    ``.parts_launches``."""
    if q_cat.device.type == "cpu":
        if stats_only:
            return _hier_refine_plain(q_cat, idx, g_sem_cat, bm=bm,
                                      gpt_f=gpt_f) + (None,)
        return _hier_refine_plain(q_cat, idx, g_sem_cat, bm=bm, gpt_f=gpt_f,
                                  g_sup_cat=g_sup_cat, g_sem_vw=g_sem_vw,
                                  g_sup_vw=g_sup_vw, gpt_sup=gpt_sup)
    bf = torch.bfloat16
    ops = dict(q_cat=q_cat, idx=idx, g_sem_cat=g_sem_cat)
    if not stats_only:
        ops.update(g_sup_cat=g_sup_cat, g_sem_vw=g_sem_vw, g_sup_vw=g_sup_vw)
    form = _cores_form(max(g_sem_cat.shape[1], 0 if stats_only else g_sup_cat.shape[1]),
                       *[t for k, t in ops.items() if k != "idx"])
    if form:
        return _refine_cores(form, q_cat, idx, g_sem_cat, g_sup_cat, g_sem_vw, g_sup_vw,
                             bm=bm, gpt_f=gpt_f, gpt_sup=gpt_sup, stats_only=stats_only)
    _check_cuda("hier_refine", ops, {k: torch.int32 if k == "idx" else bf
                                     for k in ops})
    Bp, cat_d = q_cat.shape
    nB, M = idx.shape
    G, wf = g_sem_cat.shape
    bad = (Bp != nB * bm or bm % 64 or not _gpt_ok(gpt_f) or G % gpt_f
           or wf % 16 or wf > 256 or wf > cat_d or cat_d % 8)
    if not stats_only:
        Gs, ws = g_sup_cat.shape
        W = g_sem_vw.shape[1]
        bad = bad or (gpt_sup < 1 or Gs * gpt_f != G * gpt_sup or ws % 16
                      or ws > 256 or ws > cat_d or W % 128
                      or g_sem_vw.shape[0] != G or g_sup_vw.shape != (Gs, W))
    if bad:
        raise ValueError(
            f"hier_refine kernel: unsupported shapes q {tuple(q_cat.shape)}, "
            f"idx {tuple(idx.shape)}, g {tuple(g_sem_cat.shape)}, bm={bm}, "
            f"gpt_f={gpt_f}, gpt_sup={gpt_sup}, stats_only={stats_only}")
    ops = [t.contiguous() for t in ops.values()]
    dev = q_cat.device
    m_f, s_f = (torch.empty((Bp, M), dtype=torch.float32, device=dev)
                for _ in range(2))
    parts = None
    if stats_only:
        if Bp and M:
            _launch("hier_refine", "hier_refine_launch",
                    *[t.data_ptr() for t in ops + [m_f, s_f]], Bp, cat_d, wf,
                    bm, M, gpt_f, _stream(q_cat))
            _hier_refine_call.launches += 1
        return m_f, s_f, None
    parts = torch.empty((Bp, W), dtype=torch.float32, device=dev)
    if Bp and M:
        _launch("hier_refine", "hier_refine_parts_launch",
                *[t.data_ptr() for t in ops + [m_f, s_f, parts]], Bp, cat_d,
                wf, ws, W, bm, M, gpt_f, gpt_sup, _stream(q_cat))
        _hier_refine_call.launches += 1
        _hier_refine_call.parts_launches += 1
    elif Bp:
        parts.zero_()
    return m_f, s_f, parts


_hier_refine_call.launches = 0
_hier_refine_call.parts_launches = 0
_hier_refine_call.f32_launches = 0
_hier_refine_call.deep_launches = 0


def _list_shapes(name: str, q_cat, idx, *, bm: int, fams) -> None:
    """Raise unless a listed launch's shapes are ones the CUDA-core body
    takes: Bp = blocks x bm, bm a multiple of 64, and per family (g, vw,
    gpt) whole tiles of gpt groups, at most q's columns, vw one row a
    group."""
    Bp, qw = q_cat.shape
    bad = idx.dim() != 2 or Bp != idx.shape[0] * bm or bm < 64 or bm % 64
    for g, vw, gpt in fams:
        bad = bad or (gpt < 1 or g.shape[0] % gpt or not 0 < g.shape[1] <= qw
                      or (vw is not None and vw.shape[0] != g.shape[0]))
    if bad:
        raise ValueError(
            f"{name} kernel (CUDA cores): unsupported shapes q {tuple(q_cat.shape)}, idx "
            f"{tuple(idx.shape)}, g {[tuple(f[0].shape) for f in fams]}, bm={bm}, gpt "
            f"{[f[2] for f in fams]}")


def _refine_cores(form: str, q_cat, idx, g_sem_cat, g_sup_cat, g_sem_vw, g_sup_vw, *,
                  bm: int, gpt_f: int, gpt_sup: int, stats_only: bool):
    """`_hier_refine_call` on the CUDA-core body: the fine group pass (the
    stats, and with parts E @ g_sem_vw), then the supergroups' E @ g_sup_vw
    subtracted."""
    ops = dict(q_cat=q_cat, idx=idx, g_sem_cat=g_sem_cat)
    fams = [(g_sem_cat, None if stats_only else g_sem_vw, gpt_f)]
    if not stats_only:
        ops.update(g_sup_cat=g_sup_cat, g_sem_vw=g_sem_vw, g_sup_vw=g_sup_vw)
        fams.append((g_sup_cat, g_sup_vw, gpt_sup))
    _cores_check("hier_refine", ops)
    _list_shapes("hier_refine", q_cat, idx, bm=bm, fams=fams)
    if not stats_only and g_sem_vw.shape[1] != g_sup_vw.shape[1]:
        raise ValueError("hier_refine kernel (CUDA cores): g_sem_vw and g_sup_vw widths "
                         f"{g_sem_vw.shape[1]} != {g_sup_vw.shape[1]}")
    Bp, M = q_cat.shape[0], idx.shape[1]
    dev = q_cat.device
    m_f, s_f = (torch.empty((Bp, M), dtype=torch.float32, device=dev) for _ in range(2))
    W = 0 if stats_only else g_sem_vw.shape[1]
    parts = None if stats_only else torch.zeros((Bp, W), dtype=torch.float32, device=dev)
    if not (Bp and M):
        return m_f, s_f, parts
    _cores_groups(q_cat, g_sem_cat, wk=g_sem_cat.shape[1], gpt=gpt_f, idx=idx, bm=bm,
                  stats=(m_f, s_f), vw=fams[0][1], nvc=W, out=parts)
    if not stats_only:
        _cores_groups(q_cat, g_sup_cat, wk=g_sup_cat.shape[1], gpt=gpt_sup, idx=idx, bm=bm,
                      vw=g_sup_vw, nvc=W, out=parts, sign=-1.0, accumulate=True)
    _count_cores(_hier_refine_call, form)
    return m_f, s_f, parts


def _hier_corr_plain(q_cat, idx, g_cat, dvw, *, bm: int, gpt: int,
                     magnitude: bool = False):
    """Plain version of the tail_super correction kernel
    (`_hier_corr_kernel`, `retrieval_hier.py:2209-2279`): per query block,
    over its listed tiles, e = bf16(exp2(min(q[:, :gw] . g^T, 86))) over each
    tile's gpt groups and out += e @ dvw in f32.  Out [Bp, W].

    ``magnitude=True`` sums the terms' magnitudes instead, e @ |dvw|: the
    per-element scale that a bf16 rounding point landing the other way is
    measured against."""
    f32 = torch.float32
    nB, M = idx.shape
    gw = g_cat.shape[1]
    out = []
    for i in range(nB):
        grps = _block_groups(idx[i], gpt)
        logit = q_cat[i * bm:(i + 1) * bm, :gw].to(f32) @ g_cat[grps].to(f32).T
        e = torch.exp2(torch.clamp_max(logit, CLAMP2)).to(dvw.dtype).to(f32)
        w = dvw[grps].to(f32)
        out.append(e @ (w.abs() if magnitude else w))
    return torch.cat(out)


def _hier_corr_call(q_cat, idx, g_cat, dvw, *, bm: int, gpt: int):
    """The fine-minus-supergroup sem tail correction over each query
    block's listed tiles: [Bp, W] f32 to add to the supergroup scan's sem
    tail.  q_cat [Bp, cat_d], idx [Bp / bm, M] int32, g_cat [G, gw]
    (g_sem_cat), dvw [G, W] (g_sem_ts_dvw).

    CPU tensors: `_hier_corr_plain`.  CUDA tensors: `csrc/hier_corr.cu`,
    which replaces `_hier_corr_kernel` (`range_tpu/ops/retrieval_hier.py:
    2209`), on bf16 operands of at most 256 logit columns; f32 operands and
    deeper logits on the CUDA-core body (one group pass, counted in
    ``.f32_launches`` / ``.deep_launches``, not ``.wide_launches``).  A
    shape the kernel does not take or a failed launch raises.  A dvw wider than
    512 columns (a bank without lr_rank) runs in column slices, counted
    also in ``.wide_launches``."""
    if q_cat.device.type == "cpu":
        return _hier_corr_plain(q_cat, idx, g_cat, dvw, bm=bm, gpt=gpt)
    bf = torch.bfloat16
    ops = dict(q_cat=q_cat, idx=idx, g_cat=g_cat, dvw=dvw)
    form = _cores_form(g_cat.shape[1], q_cat, g_cat, dvw)
    if form:
        _cores_check("hier_corr", ops)
        _list_shapes("hier_corr", q_cat, idx, bm=bm, fams=[(g_cat, dvw, gpt)])
        out = torch.empty((q_cat.shape[0], dvw.shape[1]), dtype=torch.float32,
                          device=q_cat.device)
        if not (q_cat.shape[0] and idx.shape[1]):
            return out.zero_()
        _cores_groups(q_cat, g_cat, wk=g_cat.shape[1], gpt=gpt, idx=idx, bm=bm, vw=dvw,
                      nvc=dvw.shape[1], out=out)
        _count_cores(_hier_corr_call, form)
        return out
    _check_cuda("hier_corr", ops, dict(q_cat=bf, idx=torch.int32, g_cat=bf,
                                       dvw=bf))
    Bp, cat_d = q_cat.shape
    nB, M = idx.shape
    G, gw = g_cat.shape
    W = dvw.shape[1]
    if (Bp != nB * bm or bm % 64 or gpt < 1 or G % gpt or dvw.shape[0] != G
            or gw % 16 or gw > 256 or gw > cat_d or cat_d % 8 or W % 128):
        raise ValueError(
            f"hier_corr kernel: unsupported shapes q {tuple(q_cat.shape)}, "
            f"idx {tuple(idx.shape)}, g {tuple(g_cat.shape)}, dvw "
            f"{tuple(dvw.shape)}, bm={bm}, gpt={gpt}")
    ops = [t.contiguous() for t in ops.values()]
    out = torch.empty((Bp, W), dtype=torch.float32, device=q_cat.device)
    if Bp and M:
        _launch("hier_corr", "hier_corr_launch",
                *[t.data_ptr() for t in ops + [out]], Bp, cat_d, gw, W, bm, M,
                gpt, _stream(q_cat))
        _hier_corr_call.launches += 1
        if W > 512:
            _hier_corr_call.wide_launches += 1
    elif Bp:
        out.zero_()
    return out


_hier_corr_call.launches = 0
_hier_corr_call.wide_launches = 0
_hier_corr_call.f32_launches = 0
_hier_corr_call.deep_launches = 0


def _family_cols(geo: bool, sem_d: int, cat_d: int, gw: int, qw: int,
                 sel: bool = False):
    """(row-logit columns, group-logit query columns) of one family, for a
    query operand qw columns wide over cat_d-column keys.  The geo family's
    group logits, and the sem family's on sel_lr banks (``sel``: the
    rank-k query sketch appended past cat_d, `retrieval_hier.py:
    2341-2346`), read the query's last gw columns."""
    if geo:
        return slice(sem_d, cat_d), slice(qw - gw, qw)
    return slice(0, sem_d), (slice(qw - gw, qw) if sel else slice(0, gw))


def _distinct_runs(tiles: torch.Tensor) -> torch.Tensor:
    """A tile list without its entries equal to the entry before them: the
    repeat padding of `_dedup_union`, which a parts kernel skips (running
    a tile twice would double its exact minus approx term)."""
    keep = torch.ones_like(tiles, dtype=torch.bool)
    keep[1:] = tiles[1:] != tiles[:-1]
    return tiles[keep]


def _hier_parts_family_plain(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, *,
                             sem_d: int, bm: int, bn: int, gpt: int,
                             geo: bool, lrr: int, lr: bool = True,
                             values=None, scale=None, sel: bool = False,
                             dedup_pad: bool = False, magnitude: bool = False,
                             geo_cols: Optional[int] = None):
    """Plain version of the family parts kernel (`_hier_parts_family_kernel`,
    `retrieval_hier.py:2282-2418`), its four shapes.  Per query block and
    selected tile: p = exp2(min(q.k + mask, 86)) over the family's columns;
    the group logits e = exp2(min(q.g, 86)).

    ``z`` given (rr): ps = segment sums of bf16(p) in f32, az += bf16(p) @ z,
    and with ``lr`` alr += bf16(e - ps / max(cnt, 1)) @ vw (cnt column
    ``lrr`` of vw): out [Bp, rrp + 128 + W] = az | d (0) | pad | alr;
    without it [acc | d] += bf16(ps / cnt - e) @ vw (full-width vw, count
    in column lrr = Dv): out [Bp, Dv + 128 + rrp] = acc | d | pad | az.
    ``z`` None (the value variants, ``values`` [N, Dv] bf16 or int8 codes
    with ``scale`` [1, N]): d += sum p, acc += bf16(p * s) @ v, and the
    group approximation bf16(e) @ vw goes to alr with ``lr`` (out [Bp, Dv +
    128 + W] = acc | d | pad | alr), else is subtracted from [acc | d]
    (out [Bp, Dv + 128]).

    ``sel`` (sel_lr banks, the sem family): q_cat is [q_cat | q_sel], the
    rank-k sketch appended, and g_cat the sketched centroids g_sem_sel: the
    row logits read the first sem_d columns, the group logits the last gw.
    ``dedup_pad`` (lists merged by `_dedup_union`): an entry equal to the
    one before it in its row is skipped.

    ``magnitude=True`` sums the terms' magnitudes instead (|v|, |vw|, |z|,
    e + ps/cnt, the approximations added): the per-element scale that a
    bf16 rounding point landing the other way is measured against.

    ``geo_cols`` (the geo family): its row and group logits over the first
    k16 steps of its columns that hold its ``geo_cols`` real ones, as the
    card's rr kernel reads them; the columns past them are zeros and add
    0.  None reads them all, as JAX."""
    f32 = torch.float32
    Bp, qw = q_cat.shape
    cat_d = k_cat.shape[1]
    nB = idx.shape[0]
    W, gw = g_vw.shape[1], g_cat.shape[1]
    gsz = bn // gpt
    cols, qcols = _family_cols(geo, sem_d, cat_d, gw, qw, sel)
    if geo and geo_cols:
        cut = _round_up(geo_cols, 16)
        cols = slice(cols.start, min(cols.stop, cols.start + cut))
        qcols = slice(qcols.start, min(qcols.stop, qcols.start + cut))
        g_cat = g_cat[:, :qcols.stop - qcols.start]
    dev = q_cat.device
    if z is not None:
        rrp = z.shape[1]
        Dv = lrr
        width = rrp + 128 + W if lr else Dv + 128 + rrp
    else:
        Dv = values.shape[1]
        width = Dv + 128 + (W if lr else 0)
    out = torch.zeros((Bp, width), dtype=f32, device=dev)
    ar_rows = torch.arange(bn, device=dev)
    ar_grp = torch.arange(gpt, device=dev)
    for i in range(nB):
        tiles = idx[i].long()
        if dedup_pad:
            tiles = _distinct_runs(tiles)
        K = tiles.shape[0]
        rows = (tiles[:, None] * bn + ar_rows).reshape(-1)
        grps = (tiles[:, None] * gpt + ar_grp).reshape(-1)
        q = q_cat[i * bm:(i + 1) * bm].to(f32)
        o = out[i * bm:(i + 1) * bm]
        logit = q[:, cols] @ k_cat[rows][:, cols].to(f32).T + mask_neg[0, rows]
        p = torch.exp2(torch.clamp_max(logit, CLAMP2))
        vw = g_vw[grps].to(f32)
        e = torch.exp2(torch.clamp_max(q[:, qcols] @ g_cat[grps].to(f32).T,
                                       CLAMP2))
        if z is not None:
            p = p.to(z.dtype).to(f32)
            ps = p.reshape(bm, K, gpt, gsz).sum(dim=3).reshape(bm, K * gpt)
            psn = ps / torch.clamp_min(vw[:, lrr], 1.0)
            zr = z[rows].to(f32)
            if magnitude:
                d, vw, zr = e + psn, vw.abs(), zr.abs()
            elif lr:
                d = (e - psn).to(g_vw.dtype).to(f32)
            else:
                d = (psn - e).to(g_vw.dtype).to(f32)
            if lr:
                o[:, rrp + 128:] = d @ vw
                o[:, :rrp] = p @ zr
            else:
                dvv = d @ vw
                o[:, :Dv + 1] = dvv[:, :Dv + 1]
                o[:, Dv + 128:] = p @ zr
            continue
        v = values[rows].to(f32)
        w = p * scale[0, rows].to(f32) if scale is not None else p
        wdt = torch.bfloat16 if scale is not None else values.dtype
        o[:, :Dv] = w.to(wdt).to(f32) @ (v.abs() if magnitude else v)
        o[:, Dv] = p.sum(dim=1)
        appr = e.to(g_vw.dtype).to(f32) @ (vw.abs() if magnitude else vw)
        if lr:
            o[:, Dv + 128:] = appr
        else:
            sign = 1.0 if magnitude else -1.0
            o[:, :Dv] += sign * appr[:, :Dv]
            o[:, Dv] += sign * appr[:, Dv]
    return out


def _hier_parts_family_call(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, *,
                            sem_d: int, bm: int, bn: int, gpt: int,
                            geo: bool, lrr: int, lr: bool = True,
                            values=None, scale=None, sel: bool = False,
                            dedup_pad: bool = False,
                            geo_cols: Optional[int] = None):
    """Exact minus group approximation of one family over each query
    block's selected tiles, in the four shapes of `_hier_parts_family_plain`
    (``z`` given: rr + lr, or rr alone with full-width ``g_vw`` and lrr =
    Dv; ``z`` None: the value variants, with ``values`` and ``scale``),
    each with the ``sel`` form (a query operand wider than the keys, the
    sketch's group logits from its last columns) and the ``dedup_pad`` form
    (repeats of the entry before skipped).

    CPU tensors: `_hier_parts_family_plain` over all the family's columns,
    as JAX.  CUDA tensors: the rr shapes the Hopper kernel
    `csrc/hier_parts_family_sm90.cu` over `_parts_plan`'s segments (the
    geo family's logits over the k16 steps holding its ``geo_cols`` real
    columns, the packing's: `retrieval_fused.geo_real_cols`), the value shapes
    the Hopper values kernel `csrc/hier_parts_sm90.cu` over
    `_values_plan`'s segments; both replace
    `_hier_parts_family_kernel` (`range_tpu/ops/retrieval_hier.py:2282`),
    on bf16 operands of up to DEEP_MAX logit columns (over 256, the `high`
    tier's 768 or wide keys, in passes of 256; the query columns past what
    a block holds beside the ring stream with passes of 128); f32 operands go to the
    CUDA-core body (`_parts_family_cores`, every shape and form, counted in
    ``.launches`` and ``.f32_launches`` only).  A shape they do not take
    raises ValueError before any launch, and a failed launch raises.  Each
    launch of the Hopper bodies counts in ``.launches`` and in its shape's
    own counter:
    ``.rrlr_launches``, ``.rr_launches``, ``.lr_launches`` or
    ``.plain_launches``; and the sel form in ``.sel_launches``, the
    dedup_pad form in ``.dedup_launches`` (those of the rr shapes also in
    ``.sel_rr_launches`` / ``.dedup_rr_launches``)."""
    if q_cat.device.type == "cpu":
        return _hier_parts_family_plain(
            q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, sem_d=sem_d, bm=bm,
            bn=bn, gpt=gpt, geo=geo, lrr=lrr, lr=lr, values=values,
            scale=scale, sel=sel, dedup_pad=dedup_pad)
    if any(t is not None and t.dtype == torch.float32
           for t in (q_cat, k_cat, g_cat, g_vw, z, values)):
        out = _parts_family_cores(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, sem_d=sem_d,
                                  bm=bm, bn=bn, gpt=gpt, geo=geo, lrr=lrr, lr=lr,
                                  values=values, scale=scale, sel=sel, dedup_pad=dedup_pad,
                                  geo_cols=geo_cols)
        if q_cat.shape[0] and idx.shape[1]:
            _count_cores(_hier_parts_family_call, "f32")
        return out
    if z is None:  # the geo family's logits over one k16 step, as the merged launch's
        out = _values_sm90("hier_parts_family", q_cat, k_cat, values, scale, mask_neg, idx,
                           (g_cat, g_vw, gpt), None, sem_d=sem_d, bm=bm, bn=bn,
                           merged=False, geo0=geo, lr=lr, sel=sel, dedup=dedup_pad)
        shape = "lr" if lr else "plain"
    else:
        out = _parts_family_rr(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z,
                               sem_d=sem_d, bm=bm, bn=bn, gpt=gpt, geo=geo,
                               lrr=lrr, lr=lr, sel=sel, dedup_pad=dedup_pad,
                               geo_cols=geo_cols)
        shape = "rrlr" if lr else "rr"
    if q_cat.shape[0] and idx.shape[1]:
        fam = _hier_parts_family_call
        counters = [f"{shape}_launches"]
        for form, on in (("sel", sel), ("dedup", dedup_pad)):
            if on:
                counters.append(f"{form}_launches")
                if z is not None:
                    counters.append(f"{form}_rr_launches")
        fam.launches += 1
        for c in counters:
            setattr(fam, c, getattr(fam, c) + 1)
    return out


# The Hopper family parts kernel's plan (`csrc/hier_parts_family_sm90.cu`)
PARTS_ROWS_MAX = SCAN_ROWS_MAX  # rows one az accumulation chain sums
_PARTS_STEP = 64                # bank rows a step (the kernel's BN)
_SM_FLOP_PER_US = 989e12 / SM90_SMS / 1e6  # bf16 tensor rate of one SM
# logits deeper than PASS_BOXES boxes of 64 columns take passes of that
# many, the accumulator carried (both parts kernels' deep layouts); where
# the query boxes over every column do not fit beside the ring, passes of
# STREAM_BOXES past the resident ones carry their query boxes too
PASS_BOXES = 4
STREAM_BOXES = 2
DEEP_MAX = 2048  # logit columns the parts kernels take


class PartsPlan(NamedTuple):
    """``n_seg`` segments of each query block's tile list (a block each,
    segment s the distinct entries [s n / n_seg, (s + 1) n / n_seg)), of at
    most ``seg_cap`` tiles, and ``S`` stages of the key / z ring; where the
    common layout fits no block (`_parts_layout`), ``direct`` (the unit
    sums read from the p tile) and ``dglob`` (the D block in device
    memory); ``res`` the query boxes resident (None: every one)."""
    n_seg: int
    seg_cap: int
    S: int
    direct: bool = False
    dglob: bool = False
    res: Optional[int] = None


# the (EG, NG) pairs the kernel's segment-matrix walk is built for
# (`groups_any`; the DIRECT walk takes any EG with NG = 64)
_PARTS_PAIRS = {(8, 8), (16, 8), (32, 8), (32, 16), (32, 32), (64, 64), (16, 16), (8, 16),
                (8, 32), (16, 32)}


def _parts_groups(gpt: int, gsz: int) -> Tuple[int, int]:
    """(EG, NG): the groups of a tile whose exponentials the kernel holds
    at once (the whole tile up to 32, else 32, or 64 for groups of an odd
    size, so a chunk ends on a 64-row step or is the tile), and the columns
    of a step's sums over units of gcd(gsz, 64) rows (its 64 / unit units,
    at least one n8 tile)."""
    return (gpt if gpt <= 32 else (32 if gsz % 2 == 0 else 64),
            max(8, 64 // math.gcd(gsz, 64)))


class PartsLayout(NamedTuple):
    """One block's shared memory in the Hopper family parts kernel, in
    bytes from its 1024-aligned base (the launch takes it as given): EG,
    NG (`_parts_groups`), pb alr boxes a pass and S2 vw stages of the
    second phase, a ring stage's size and its z boxes' and mask's offsets
    within it, then the query block(s), the ring, two p tiles, a chunk's
    centroids, exponentials and counts, the unit sums (groups of several
    units ending inside a step), the segment matrix, the D block of
    seg_cap tiles, the tile list, the barriers, and the total; then the
    DIRECT walk and dglob (`PartsPlan`), the query boxes resident and a
    streamed group pass's query boxes (past the centroids)."""
    EG: int
    NG: int
    pb: int
    S2: int
    stage: int
    kz: int
    msk: int
    q: int
    qg: int
    ring: int
    p: int
    g: int
    e: int
    cnt: int
    us: int
    sm: int
    d: int
    lst: int
    bars: int
    total: int
    direct: int = 0
    dglob: int = 0
    res: int = 0
    gqs: int = 0


def _parts_layout(K: int, bn: int, gpt: int, kf: int, gwe: int, share: bool, rrp: int,
                  acols: int, seg_cap: int, S: int, direct: bool = False,
                  dglob: bool = False, res: Optional[int] = None) -> PartsLayout:
    """The Hopper family parts kernel's shared-memory layout (a box is 64
    rows of a 64-column bf16 block, 8 KB).  ``direct``: no segment matrix
    and no unit sums (read from the p tile); ``dglob``: no D block (in
    device memory; phase 2's vw stages carry each k16 block of it).  Row
    logits over more than PASS_BOXES boxes (deep): a stage holds one pass's
    key boxes, or in their place the payload's z boxes, then the mask;
    group logits over more than PASS_BOXES: the centroid buffer holds one
    pass's boxes.  ``res`` (default: every one) the query boxes resident of
    each query block, a multiple of PASS_BOXES below its boxes: a row pass
    past them takes STREAM_BOXES key boxes and their query boxes a stage, a
    group pass its query boxes through a buffer of their own."""
    box = 8192
    kb, kbg = -(-kf // 64), -(-gwe // 64)
    res = max(kb, kbg) if res is None else res
    qres, gres = min(kb, res), min(kbg, res)
    gsz = bn // gpt
    eg, ng = _parts_groups(gpt, gsz)
    # groups of several units ending inside a step
    units = gsz % 64 and 64 % gsz and not direct
    deep = kb > PASS_BOXES
    kz = 0 if deep else kb * box
    msk = max(PASS_BOXES, rrp // 64) * box if deep else kz + rrp // 64 * box
    stage = msk + 1024  # the mask's 256 bytes, the next stage 1024-aligned
    qg = qres * box
    ring = qg + (0 if share else gres * box)
    p = ring + S * stage
    g = p + 2 * box
    gqs = g + min(kbg, PASS_BOXES) * eg * 128
    e = gqs + (STREAM_BOXES * box if gres < kbg else 0)
    cnt = e + _round_up(64 * (eg + 1) * 4, 16)
    us = _round_up(cnt + eg * 4, 16)
    sm = _round_up(us + (64 * (ng + 1) * 4 if units else 0), 1024)
    d = sm + (0 if direct else ng * 128)
    lst = d + (0 if dglob else seg_cap * _round_up(gpt, 16) * 128)
    bars = lst + _round_up(K * 4, 16)
    abox = -(-acols // 64)
    pb = -(-abox // -(-abox // 8))  # up to 8 boxes a pass, the passes even
    S2 = min(4, S * stage // ((pb + (1 if dglob else 0)) * 2048))
    # the barriers, a segment's first entry and length, slack to align the base
    total = bars + 8 * (6 + 2 * S + S2) + 16 + 1024
    return PartsLayout(eg, ng, pb, S2, stage, kz, msk, 0, qg, ring, p, g, e, cnt, us, sm, d,
                       lst, bars, total, int(direct), int(dglob), res, gqs)


def _parts_modes(bn: int, gpt: int):
    """The layouts the plan tries, in order, as (direct, dglob): the common
    one where the kernel has its (EG, NG) pair; for units of one row (odd
    gsz) the DIRECT walk (the only one at up to 32 groups a tile, whose
    pairs (EG, 64) have no segment-matrix instance); then the D block in
    device memory (a whole number of 16-group k16 blocks a tile)."""
    gsz = bn // gpt
    direct = math.gcd(gsz, 64) == 1
    built = _parts_groups(gpt, gsz) in _PARTS_PAIRS
    modes = ([(False, False)] if built else []) + ([(True, False)] if direct else [])
    if gpt % 16 == 0:
        modes.append((direct, True))
    return modes


def _parts_fits(lay: PartsLayout) -> bool:
    """The layout fits a block's shared memory with two vw stages."""
    return lay.total <= _SM90_MAX_SMEM and lay.S2 >= 2


@functools.lru_cache(maxsize=256)
def _parts_plan(Bp: int, K: int, bn: int, gpt: int, kf: int, gwe: int,
                share: bool, rrp: int, acols: int, out_w: int,
                rows_max: int = PARTS_ROWS_MAX) -> PartsPlan:
    """The Hopper family parts kernel's segments and ring: a function of
    the shape alone (Bp padded queries, lists of K tiles of bn rows and gpt
    groups, logits over kf / gwe columns, rrp z columns, acols alr columns,
    out_w output columns).

    Segments are whole tiles, none over ``rows_max`` rows (one wgmma
    accumulation chain) or past what the block's D block holds; each is
    planned over K, a dedup_pad list's distinct entries split at run time.
    Their number: of the cuts (up to 8 waves of blocks past the first that
    fits) that give the card's 132 SMs a block each where the lists allow
    it, the one that finishes first (`_makespan`),
    counting each block's 64-row steps at ~0.9 us plus the row logits'
    tensor time, its alr steps (16 rows of vw a pass) at ~0.4 us, ~6 us a
    block (the paces measured on the H100, PERF.md) and, past one
    segment, the planes' writes and the reduction's pass over them at ~3
    TB/s.  The ring: the deepest of 4, 3, 2 stages that fits.  The layout:
    the first of `_parts_modes` in which a cut fits (the common groupings
    never leave the first); deep, where no cut fits with every query box
    resident, the same search with the most resident boxes (a multiple of
    PASS_BOXES) that fit each cut with any ring.
    lru-cached: serving asks for the same few shapes."""
    n_qb = Bp // 64
    spt = -(-bn // _PARTS_STEP)
    ks = 1 if kf <= 16 else 4 * -(-kf // 64)
    step_us = 2 * 64 * 64 * 16 * ks / _SM_FLOP_PER_US + 0.9
    alr_us = 0.4 * _round_up(gpt, 16) / 16 * -(-acols // 512)  # a tile's alr steps
    row_us = out_w * 4 / 3.0e6  # one query row of a plane, written or read
    cap = max(1, rows_max // bn)
    want = min(SM90_SMS, n_qb * K)
    boxes = max(-(-kf // 64), -(-gwe // 64))
    streamed = list(range((boxes - 1) // PASS_BOXES * PASS_BOXES, 0, -PASS_BOXES)
                    if boxes > PASS_BOXES else [])
    best = None
    # every query box resident where any cut allows it, else the most that fit
    for resident in ([None], streamed):
        for direct, dglob in _parts_modes(bn, gpt):
            limit = None  # up to 8 waves of blocks past the first cut that fits
            for n_seg in range(-(-K // cap), K + 1):
                seg_cap = -(-K // n_seg)
                if limit is not None and n_qb * n_seg > limit:
                    break
                S, res = next(((S, r) for r in resident for S in (4, 3, 2) if _parts_fits(
                    _parts_layout(K, bn, gpt, kf, gwe, share, rrp, acols, seg_cap, S, direct,
                                  dglob, r))), (None, None))
                if S is None:
                    continue
                if limit is None:
                    limit = max(n_qb * n_seg, 8 * SM90_SMS)
                costs = []
                for seg in range(n_seg):
                    t = (seg + 1) * K // n_seg - seg * K // n_seg
                    costs += [t * (spt * step_us + alr_us) + 6.0] * n_qb
                planes = Bp * row_us * (1 if n_seg == 1 else 2 * n_seg + 1)
                key = (n_qb * n_seg < want, _makespan(costs, SM90_SMS) + planes)
                if best is None or key < best[0]:
                    best = (key, PartsPlan(n_seg, seg_cap, S, direct, dglob, res))
            if best is not None:
                break
        if best is not None:
            break
    if best is None:
        raise ValueError(
            f"hier_parts_family kernel: no segment of a {K}-tile list of {gpt} "
            f"groups fits a block's shared memory (kf={kf}, gw={gwe}, "
            f"rrp={rrp})")
    return best[1]


def _parts_shapes(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, *, sem_d: int,
                  bm: int, bn: int, gpt: int, geo: bool, lrr: int, lr: bool,
                  sel: bool, geo_cols: Optional[int] = None) -> dict:
    """The rr launch's column ranges and widths: the row logits' [kc0, kc0
    + kf) and the group logits' [qg0, qg0 + gwe) query columns (the geo
    family's cut to the k16 steps holding its ``geo_cols`` real ones, when
    given: the rest are zeros and add 0); raises on a shape the kernel
    does not take."""
    Bp, qw = q_cat.shape
    N, cat_d = k_cat.shape
    nB, K = idx.shape
    G, gw = g_cat.shape
    W, rrp = g_vw.shape[1], z.shape[1]
    cols, qcols = _family_cols(geo, sem_d, cat_d, gw, qw, sel)
    kf, gwe = cols.stop - cols.start, gw
    if geo and geo_cols:
        kf, gwe = min(kf, _round_up(geo_cols, 16)), min(gw, _round_up(geo_cols, 16))
    gsz = bn // max(gpt, 1)
    eg, ng = _parts_groups(max(gpt, 1), max(gsz, 1))
    if (qw != (cat_d + gw if sel else cat_d) or (sel and geo)
            or Bp != nB * bm or bm % 64 or gpt < 8 or gpt * gsz != bn
            or not _gpt_ok(gpt)
            or ((eg, ng) not in _PARTS_PAIRS and math.gcd(gsz, 64) > 1)
            or (eg * gsz % _PARTS_STEP and eg != gpt) or kf % 16
            or kf > DEEP_MAX or gwe % 16 or gwe > DEEP_MAX or cols.start % 8
            or qcols.start % 8 or gw % 8 or cat_d % 8 or W % 128
            or rrp not in (128, 256) or not 0 <= lrr < W
            or (not lr and lrr % 4) or z.shape[0] != N or g_vw.shape[0] != G
            or G % gpt or mask_neg.shape != (1, N) or N % bn):
        raise ValueError(
            f"hier_parts_family kernel: unsupported shapes q "
            f"{tuple(q_cat.shape)}, k {tuple(k_cat.shape)}, idx "
            f"{tuple(idx.shape)}, g {tuple(g_cat.shape)}, vw "
            f"{tuple(g_vw.shape)}, z {tuple(z.shape)}, bm={bm}, bn={bn}, "
            f"gpt={gpt}, lr={lr}")
    return dict(kc0=cols.start, kf=kf, qg0=qcols.start, gwe=gwe,
                acols=W if lr else lrr + 1,
                out_w=rrp + 128 + W if lr else lrr + 128 + rrp,
                share=qcols.start == cols.start and gwe <= kf)


def _parts_family_rr(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, *,
                     sem_d: int, bm: int, bn: int, gpt: int, geo: bool,
                     lrr: int, lr: bool, sel: bool, dedup_pad: bool,
                     geo_cols: Optional[int] = None,
                     plan: Optional[PartsPlan] = None):
    """Launch `csrc/hier_parts_family_sm90.cu` (the rr shapes) over
    `_parts_plan`'s segments (``plan`` overrides it: chip_smoke's chain
    turns); counted nowhere."""
    bf = torch.bfloat16
    ops = dict(q_cat=q_cat, k_cat=k_cat, mask_neg=mask_neg, idx=idx,
               g_cat=g_cat, g_vw=g_vw, z=z)
    _check_cuda("hier_parts_family", ops, dict(
        q_cat=bf, k_cat=bf, mask_neg=torch.float32, idx=torch.int32,
        g_cat=bf, g_vw=bf, z=bf))
    sh = _parts_shapes(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, sem_d=sem_d,
                       bm=bm, bn=bn, gpt=gpt, geo=geo, lrr=lrr, lr=lr, sel=sel,
                       geo_cols=geo_cols)
    Bp, qw = q_cat.shape
    N, cat_d = k_cat.shape
    K, rrp, W = idx.shape[1], z.shape[1], g_vw.shape[1]
    dev = q_cat.device
    out = torch.empty((Bp, sh["out_w"]), dtype=torch.float32, device=dev)
    if not (Bp and K):
        return out.zero_()
    plan = plan or _parts_plan(Bp, K, bn, gpt, sh["kf"], sh["gwe"], sh["share"],
                               rrp, sh["acols"], sh["out_w"])
    work = (torch.empty(plan.n_seg * Bp * sh["out_w"], dtype=torch.float32,
                        device=dev) if plan.n_seg > 1 else None)
    # dglob: each block's D blocks, seg_cap tiles of gpt columns x 64 rows bf16
    dwork = (torch.empty(Bp // 64 * plan.n_seg * plan.seg_cap * gpt * 128,
                         dtype=torch.uint8, device=dev) if plan.dglob else None)
    lay = _parts_layout(K, bn, gpt, sh["kf"], sh["gwe"], sh["share"], rrp, sh["acols"],
                        plan.seg_cap, plan.S, plan.direct, plan.dglob, plan.res)
    lay = (ctypes.c_int * len(lay))(*lay)
    held = [t.contiguous() for t in ops.values()]  # referenced until queued
    ptr = [t.data_ptr() for t in held] + [out.data_ptr(),
                                          None if work is None else work.data_ptr(),
                                          None if dwork is None else dwork.data_ptr(),
                                          ctypes.addressof(lay)]
    _launch("hier_parts_family_sm90", "hier_parts_family_sm90_launch", *ptr,
            Bp, qw, cat_d, sh["kc0"], sh["kf"], sh["qg0"], g_cat.shape[1],
            sh["gwe"], bm, bn, gpt, K, W, lrr, rrp, N, g_cat.shape[0], int(lr),
            int(dedup_pad), plan.n_seg, plan.seg_cap, plan.S, _stream(q_cat))
    return out


# The Hopper values kernel (`csrc/hier_parts_sm90.cu`): kernel 15 and
# kernel 14's value shapes on one body
_VALUES_DVS = 256  # value (or alr) columns a block


def _values_eg(gpt: int) -> int:
    """A chunk's centroid box rows (the group logits' wgmma N): the first
    of 16, 32, 64 that holds min(gpt, 64) groups."""
    return 16 if gpt <= 16 else 32 if gpt <= 32 else 64


class ValuesLayout(NamedTuple):
    """One block's shared memory in the Hopper values kernel, in bytes from
    its 1024-aligned base (the launch takes it as given): the queries a
    block (64 or 128) and the ring's stages, then a query half's size and
    its geo and sel boxes' offsets, the ring, a stage's size and its geo
    box's, aux's (mask and scales, or a chunk's counts) and value boxes'
    offsets (a step's int8 codes land in the second half of its value
    boxes' memory), the warpgroups' e tiles and the size of one, the tile
    list, the barriers, the total; the sem boxes resident a query half."""
    bmb: int
    S: int
    qhalf: int
    qgeo: int
    qsel: int
    ring: int
    stage: int
    kg: int
    aux: int
    va: int
    e: int
    etile: int
    lst: int
    bars: int
    total: int
    qres: int


def _values_layout(K: int, bmb: int, kb: int, kbs: int, kbg: int, has_kg: bool,
                   egmax: int, S: int, i8: bool = False,
                   qres: Optional[int] = None) -> ValuesLayout:
    """The values kernel's layout: kb sem boxes (64 rows of 64 bf16
    columns, 8 KB) a query half and a step, kbs sel boxes a half, kbg
    centroid boxes a chunk, the geo box (2 KB) where a family is geo, e
    tiles of egmax columns.  Deep (sem logits over more than PASS_BOXES
    boxes): a stage holds one pass's PASS_BOXES boxes, or in their place
    the payload's value boxes (va = 0), with ``i8`` the step's 16 KB of
    codes past them, then the geo box and aux; ``qres`` (deep, 64 queries a
    block; default kb) sem boxes of the query half resident, the passes
    past them taking 2 key boxes and their 2 query boxes a stage."""
    box = 8192
    qres = kb if qres is None else qres
    qgeo = qres * box
    qsel = qgeo + (2048 if has_kg else 0)
    qhalf = _round_up(qsel + kbs * box, 1024)
    ring = bmb // 64 * qhalf
    deep = kb > PASS_BOXES or kbs > PASS_BOXES
    kg = (PASS_BOXES * box + (64 * _VALUES_DVS if i8 else 0)) if deep else max(kb, kbg) * box
    aux = kg + (2048 if has_kg else 0)
    va = 0 if deep else aux + 1024
    stage = aux + 1024 if deep else va + 4 * box
    e = ring + S * stage
    etile = egmax // 16 * 2048
    lst = e + 2 * etile
    bars = lst + _round_up(4 * K, 16)
    total = bars + 8 * (1 + 2 * S) + 16 + 1024
    return ValuesLayout(bmb, S, qhalf, qgeo, qsel, ring, stage, kg, aux, va, e, etile, lst,
                        bars, total, qres)


class ValuesPlan(NamedTuple):
    """128 or 64 queries a block (``bmb``), ``n_seg`` segments of each
    list (segment s a block's distinct entries [s n / n_seg, (s + 1) n /
    n_seg)), ``S`` ring stages, ``qres`` sem query boxes resident."""
    bmb: int
    n_seg: int
    S: int
    qres: Optional[int] = None


@functools.lru_cache(maxsize=256)
def _values_plan(Bp: int, K: int, bn: int, bm: int, Dv: int, Wa: int, two: bool,
                 kb: int, kbs: int, kbg: int, has_kg: bool, egmax: int, i8: bool = False,
                 rows_max: int = PARTS_ROWS_MAX) -> ValuesPlan:
    """The values kernel's plan, a function of the shape alone: 128 queries
    a block (the two halves of a selection block, one list) where the
    launch has one family, bm allows it and the layout fits, else 64; the
    deepest ring of 4, 3, 2 stages that fits; where no layout with every
    sem query box resident fits (deep), 64 queries and the most resident
    boxes, a multiple of 4, that fit with any ring; segments of whole tiles, none
    over ``rows_max`` rows (one wgmma accumulation chain), and as many more
    as the card's 132 SMs need a block each where the lists allow it (the
    value slices ceil(Dv / 256) and the alr slices ceil(Wa / 256) of every
    query block and segment are a block each; deep, one family: a pair of
    them, a warpgroup each).  lru-cached: serving asks for the same few
    shapes."""
    nsl, na = -(-Dv // _VALUES_DVS), -(-Wa // _VALUES_DVS)
    deep = kb > PASS_BOXES or kbs > PASS_BOXES
    slices = -(-nsl // 2) + -(-na // 2) if deep and not two else nsl + na
    fits = [(bmb, kb) for bmb in ((128, 64) if not two and bm % 128 == 0 else (64,))]
    if deep:
        fits += [(64, r) for r in range((kb - 1) // PASS_BOXES * PASS_BOXES, 0, -PASS_BOXES)]
    for bmb, qres in fits:
        S = next((S for S in (4, 3, 2) if _values_layout(
            K, bmb, kb, kbs, kbg, has_kg, egmax, S, i8, qres).total <= _SM90_MAX_SMEM), None)
        if S is None:
            continue
        blocks = Bp // bmb * slices
        n_seg = max(-(-K // max(1, rows_max // bn)), min(K, -(-SM90_SMS // blocks)))
        return ValuesPlan(bmb, n_seg, S, qres)
    raise ValueError(f"hier_parts kernel: unsupported shapes: no block of the values kernel "
                     f"holds sem boxes {kb}, sel boxes {kbs} and {egmax}-group chunks")


def _values_sm90(name: str, q_cat, k_cat, values, scale, mask_neg, idx, fam0, fam1, *,
                 sem_d: int, bm: int, bn: int, merged: bool, geo0: bool = False,
                 lr: bool = False, sel: bool = False, dedup: bool = False,
                 plan: Optional[ValuesPlan] = None, n_seg: Optional[int] = None):
    """Launch `csrc/hier_parts_sm90.cu`: the merged launch (``merged``:
    ``fam0`` = (g_sem_cat, g_sem_vw, gpt_s), ``fam1`` the geo family's or
    None without it) or a family launch (``fam0`` the family's, ``geo0``
    the geo one, ``sel``, ``dedup``) over `_values_plan`'s segments
    (``plan`` overrides it, ``n_seg`` only its segments: chip_smoke's
    chain turns); ``lr``: fam0's vw
    are low-rank coefficients (alr), else full-width sums with the count in
    column Dv.  A shape the kernel does not take raises ValueError before
    any launch; counted nowhere."""
    bf, f32 = torch.bfloat16, torch.float32
    g0, vw0, gpt0 = fam0
    ops = dict(q_cat=q_cat, k_cat=k_cat, values=values, mask_neg=mask_neg, idx=idx, g0=g0,
               vw0=vw0)
    dtypes = dict(q_cat=bf, k_cat=bf, values=bf, mask_neg=f32, idx=torch.int32, g0=bf, vw0=bf)
    if fam1 is not None:
        ops["g1"], ops["vw1"] = fam1[:2]
        dtypes["g1"] = dtypes["vw1"] = bf
    if scale is not None:
        ops["scale"], dtypes["scale"], dtypes["values"] = scale, f32, torch.int8
    _check_cuda(name, ops, dtypes)
    Bp, qw = q_cat.shape
    N, Dv = values.shape
    cat_d = k_cat.shape[1]
    nB, K = idx.shape
    G0, gw0 = g0.shape
    W0 = vw0.shape[1]
    two = fam1 is not None
    g1, vw1, gpt1 = fam1 if two else (g0, vw0, gpt0)
    G1, gw1 = g1.shape
    W1 = vw1.shape[1]

    def fam_ok(geo, flr, gpt, G, gw, W, vw):
        return (gpt >= 1 and bn % gpt == 0 and G >= 1 and gw % 8 == 0
                and vw.shape[0] == G
                and (not geo or (gw >= 16 and cat_d - gw == sem_d))
                and (W % 128 == 0 and W <= 512 if flr else W >= Dv + 1 and W % 8 == 0))

    if merged:
        fams = gw0 == sem_d and qw == cat_d and not (geo0 or sel or dedup) and (
            not two or fam_ok(True, False, gpt1, G1, gw1, W1, vw1))
    else:
        fams = not two and (16 <= gw0 <= 256 and gw0 % 16 == 0 and qw == cat_d + gw0
                            and not geo0 if sel
                            else qw == cat_d and (geo0 or gw0 == sem_d))
    if (k_cat.shape != (N, cat_d) or mask_neg.shape != (1, N)
            or (scale is not None and scale.shape != (1, N))
            or Bp != nB * bm or bm % 64 or bn < 32 or bn % 32 or N % bn or N == 0
            or not 16 <= sem_d <= DEEP_MAX or sem_d % 16 or sem_d + 16 > cat_d or cat_d % 8
            or Dv % 16 or Dv == 0 or not fams
            or not fam_ok(geo0, lr, gpt0, G0, gw0, W0, vw0)):
        raise ValueError(
            f"{name} kernel: unsupported shapes q {tuple(q_cat.shape)}, k "
            f"{tuple(k_cat.shape)}, values {tuple(values.shape)}, idx {tuple(idx.shape)}, "
            f"g {tuple(g0.shape)} / {tuple(g1.shape)}, vw {tuple(vw0.shape)} / "
            f"{tuple(vw1.shape)}, bm={bm}, bn={bn}, gpt {gpt0} / {gpt1}, geo={geo0}, "
            f"lr={lr}, sel={sel}")
    Wa = W0 if lr else 0
    out_w = (2 * Dv if merged else Dv) + 128 + Wa
    out = torch.empty((Bp, out_w), dtype=f32, device=q_cat.device)
    if not (Bp and K):
        return out.zero_()
    kb = 0 if geo0 else -(-sem_d // 64)
    kbs = -(-gw0 // 64) if sel else 0
    kbg = 0 if geo0 else kbs if sel else kb
    has_kg = two or geo0
    egmax = max(_values_eg(gpt0), _values_eg(gpt1) if two else 0)
    i8 = scale is not None
    plan = plan or _values_plan(Bp, K, bn, bm, Dv, Wa, two, kb, kbs, kbg, has_kg, egmax, i8)
    if n_seg:
        plan = plan._replace(n_seg=n_seg)
    lay = _values_layout(K, plan.bmb, kb, kbs, kbg, has_kg, egmax, plan.S, i8, plan.qres)
    lay = (ctypes.c_int * len(lay))(*lay)
    work = (torch.empty(plan.n_seg * Bp * out_w, dtype=f32, device=q_cat.device)
            if plan.n_seg > 1 else None)
    held = [None if t is None else t.contiguous() for t in (
        q_cat, k_cat, values, scale, mask_neg, idx, g0, vw0, g1, vw1)]  # referenced until queued
    ptr = [None if t is None else t.data_ptr() for t in held]
    _launch("hier_parts_sm90", "hier_parts_sm90_launch", *ptr, out.data_ptr(),
            None if work is None else work.data_ptr(), ctypes.addressof(lay), Bp, qw, cat_d,
            sem_d, Dv, bm, bn, K, N, int(merged), int(two), int(geo0), int(lr), int(sel),
            int(dedup), gpt0, G0, gw0, W0, gpt1, G1, gw1, W1, plan.n_seg, _stream(q_cat))
    return out


_hier_parts_family_call.launches = 0
_hier_parts_family_call.rrlr_launches = 0
_hier_parts_family_call.rr_launches = 0
_hier_parts_family_call.lr_launches = 0
_hier_parts_family_call.plain_launches = 0
_hier_parts_family_call.sel_launches = 0
_hier_parts_family_call.dedup_launches = 0
_hier_parts_family_call.sel_rr_launches = 0
_hier_parts_family_call.dedup_rr_launches = 0
_hier_parts_family_call.f32_launches = 0


def _rows_shapes(name: str, k_cat, mask_neg, idx, x, *, bn: int, scale=None) -> None:
    """Raise unless a row pass's operands are ones the CUDA-core body takes:
    keys and x one row a bank row, whole tiles of bn rows, the mask [1, N],
    int8 codes with their [1, N] scales.  The list's tiles are not read
    (no sync): `select_tiles` gives real ones."""
    N = k_cat.shape[0]
    if (bn < 1 or N % bn or N == 0 or mask_neg.shape != (1, N) or x.shape[0] != N
            or (x.dtype == torch.int8) != (scale is not None)
            or (scale is not None and scale.shape != (1, N))):
        raise ValueError(
            f"{name} kernel (CUDA cores): unsupported shapes k {tuple(k_cat.shape)}, "
            f"mask {tuple(mask_neg.shape)}, values {tuple(x.shape)} {x.dtype}, idx "
            f"{tuple(idx.shape)}, bn={bn}")


def _parts_family_cores(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, *, sem_d: int,
                        bm: int, bn: int, gpt: int, geo: bool, lrr: int, lr: bool,
                        values, scale, sel: bool, dedup_pad: bool,
                        geo_cols: Optional[int] = None):
    """`_hier_parts_family_call`'s shapes on the CUDA-core body, the layout
    of `_hier_parts_family_plain`: the row pass (d and the value product,
    or with ``z`` az and the segment sums of the rounded p), then the group
    pass (the approximation into alr or subtracted, or with ``z`` the
    rounded e - ps / cnt into alr, or ps / cnt - e into [acc | d]); the geo
    family's logits over the columns holding its ``geo_cols`` real ones."""
    x = values if z is None else z
    ops = dict(q_cat=q_cat, k_cat=k_cat, mask_neg=mask_neg, idx=idx, g_cat=g_cat,
               g_vw=g_vw, values=x, scale=scale if z is None else None)
    _cores_check("hier_parts_family", ops)
    Bp, qw = q_cat.shape
    cat_d = k_cat.shape[1]
    W, gw = g_vw.shape[1], g_cat.shape[1]
    cols, qcols = _family_cols(geo, sem_d, cat_d, gw, qw, sel)
    if geo and geo_cols:
        cut = _round_up(geo_cols, 16)
        cols = slice(cols.start, min(cols.stop, cols.start + cut))
        qcols = slice(qcols.start, min(qcols.stop, qcols.start + cut))
    _list_shapes("hier_parts_family", q_cat, idx, bm=bm, fams=[(g_cat, g_vw, gpt)])
    _rows_shapes("hier_parts_family", k_cat, mask_neg, idx, x, bn=bn,
                 scale=None if z is not None else scale)
    if (qw != (cat_d + gw if sel else cat_d) or (sel and geo) or not 0 < sem_d < cat_d
            or bn % gpt or not 0 <= lrr < W or (z is not None and x.dtype == torch.int8)
            or (not lr and (lrr != x.shape[1] if z is None else lrr + 1 > W))):
        raise ValueError(
            f"hier_parts_family kernel (CUDA cores): unsupported shapes q "
            f"{tuple(q_cat.shape)}, k {tuple(k_cat.shape)}, g {tuple(g_cat.shape)}, vw "
            f"{tuple(g_vw.shape)}, x {tuple(x.shape)}, sem_d={sem_d}, lrr={lrr}, lr={lr}, "
            f"sel={sel}, geo={geo}")
    dev = q_cat.device
    f32 = torch.float32
    if z is not None:
        rrp = z.shape[1]
        Dv = lrr
        out = torch.zeros((Bp, rrp + 128 + W if lr else Dv + 128 + rrp), dtype=f32,
                          device=dev)
    else:
        Dv = x.shape[1]
        out = torch.zeros((Bp, Dv + 128 + (W if lr else 0)), dtype=f32, device=dev)
    if not (Bp and idx.shape[1]):
        return out
    rows = dict(kf=cols.stop - cols.start, qc0=cols.start, kc0=cols.start, bm=bm, bn=bn,
                dedup=dedup_pad)
    grp = dict(wk=qcols.stop - qcols.start, qc0=qcols.start, gpt=gpt, idx=idx, bm=bm,
               vw=g_vw, out=out, dedup=dedup_pad)
    if z is not None:
        ps = torch.zeros((Bp, idx.shape[1] * gpt), dtype=f32, device=dev)
        _cores_rows(q_cat, k_cat, mask_neg, idx, z, out, oc0=0 if lr else Dv + 128,
                    rr=True, ps=ps, gsz=bn // gpt, **rows)
        if lr:
            _cores_groups(q_cat, g_cat, nvc=W, oc0=rrp + 128, ps=ps, mode=1, lrr=lrr, **grp)
        else:
            _cores_groups(q_cat, g_cat, nvc=Dv, cntc=Dv, dcol=Dv, ps=ps, mode=2, lrr=lrr,
                          **grp)
        return out
    _cores_rows(q_cat, k_cat, mask_neg, idx, x, out, scale=scale, dcol=Dv, **rows)
    if lr:
        _cores_groups(q_cat, g_cat, nvc=W, oc0=Dv + 128, **grp)
    else:
        _cores_groups(q_cat, g_cat, nvc=Dv, cntc=Dv, dcol=Dv, sign=-1.0, accumulate=True,
                      **grp)
    return out


def _hier_parts_plain(q_cat, k_cat, values, scale, mask_neg, idx, g_sem_cat,
                      g_geo_cat, g_sem_vw, g_geo_vw, *, sem_d: int, bm: int,
                      bn: int, gpt_s: int, gpt_g: int, geo: bool = True,
                      lr: bool = True, magnitude: bool = False):
    """Plain version of the merged parts kernel (`_hier_parts_kernel`,
    `retrieval_hier.py:2515-2613`).  Per query block and selected tile:
    p_s, p_g = exp2(min(q . k + mask, 86)) over each family's columns; d_s,
    d_g their sums; acc += bf16(p * s) @ v per family (s the int8 row
    scale; without ``scale`` p is cast to the value dtype); [acc_g | d_g]
    -= bf16(exp2(min(q_geo . g_geo, 86))) @ g_geo_vw (the geo
    approximation, count in column Dv).  The sem approximation bf16(exp2(
    min(q_sem . g_sem, 86))) @ g_sem_vw: with ``lr`` (low-rank
    coefficients) kept apart in alr, out [Bp, 2 Dv + 128 + Ws] = acc_s |
    acc_g | d_s | d_g | 0 | alr; without it (full-width sums, count in
    column Dv) subtracted from [acc_s | d_s] as the geo one, out [Bp, 2 Dv
    + 128].  ``geo=False`` leaves the geo columns zero (what RANGE mode
    discards).  The group logits take q[:, :gs_w] for sem and the last
    gg_w columns of q for geo.

    ``magnitude=True`` sums the terms' magnitudes instead (|v|, |vw|, the
    approximations added): the per-element scale that a bf16 rounding
    point landing the other way is measured against."""
    f32 = torch.float32
    Bp, cat_d = q_cat.shape
    nB, K = idx.shape
    Dv, Ws = values.shape[1], g_sem_vw.shape[1]
    gs_w, gg_w = g_sem_cat.shape[1], g_geo_cat.shape[1]
    wdt = torch.bfloat16 if scale is not None else values.dtype
    dev = q_cat.device
    out = torch.zeros((Bp, 2 * Dv + 128 + (Ws if lr else 0)), dtype=f32,
                      device=dev)
    ar_rows = torch.arange(bn, device=dev)
    for i in range(nB):
        tiles = idx[i].long()
        rows = (tiles[:, None] * bn + ar_rows).reshape(-1)
        q = q_cat[i * bm:(i + 1) * bm].to(f32)
        k = k_cat[rows].to(f32)
        v = values[rows].to(f32)
        m = mask_neg[0, rows]
        o = out[i * bm:(i + 1) * bm]

        def family(cols):
            p = torch.exp2(torch.clamp_max(q[:, cols] @ k[:, cols].T + m,
                                           CLAMP2))
            w = p * scale[0, rows].to(f32) if scale is not None else p
            vv = v.abs() if magnitude else v
            return p.sum(dim=1), w.to(wdt).to(f32) @ vv

        def approx(qcols, g_cat, vw, gpt):
            grps = (tiles[:, None] * gpt
                    + torch.arange(gpt, device=dev)).reshape(-1)
            e = torch.exp2(torch.clamp_max(q[:, qcols] @ g_cat[grps].to(f32).T,
                                           CLAMP2))
            w = vw[grps].to(f32)
            return e.to(vw.dtype).to(f32) @ (w.abs() if magnitude else w)

        sign = 1.0 if magnitude else -1.0
        d_s, acc_s = family(slice(0, sem_d))
        appr = approx(slice(0, gs_w), g_sem_cat, g_sem_vw, gpt_s)
        if lr:
            o[:, 2 * Dv], o[:, :Dv] = d_s, acc_s
            o[:, 2 * Dv + 128:] = appr
        else:
            o[:, :Dv] = acc_s + sign * appr[:, :Dv]
            o[:, 2 * Dv] = d_s + sign * appr[:, Dv]
        if geo:
            d_g, acc_g = family(slice(sem_d, cat_d))
            appr = approx(slice(cat_d - gg_w, cat_d), g_geo_cat, g_geo_vw,
                          gpt_g)
            o[:, Dv:2 * Dv] = acc_g + sign * appr[:, :Dv]
            o[:, 2 * Dv + 1] = d_g + sign * appr[:, Dv]
    return out


def _hier_parts_call(q_cat, k_cat, values, scale, mask_neg, idx, g_sem_cat,
                     g_geo_cat, g_sem_vw, g_geo_vw, *, sem_d: int, bm: int,
                     bn: int, gpt_s: int, gpt_g: int, lr: bool = True,
                     geo: bool = True):
    """Exact minus group approximation of both families over each query
    block's selected tiles, the merged shape: [Bp, 2 Dv + 128 (+ Ws with
    ``lr``)] f32, the layout of `_hier_parts_plain`.  ``scale`` [1, N] f32
    with int8 ``values``, else None; ``geo=False`` skips the geo family
    (its columns come back zero); ``lr=False`` takes the full-width sem
    group sums ``g_sem_vw`` (count in column Dv) and subtracts the sem
    approximation in the kernel, as the geo one.

    CPU tensors: `_hier_parts_plain`.  CUDA tensors: the Hopper values
    kernel `csrc/hier_parts_sm90.cu` over `_values_plan`'s segments, which
    replaces `_hier_parts_kernel` (`range_tpu/ops/retrieval_hier.py:
    2515`), on bf16 operands of up to DEEP_MAX logit columns (over 256 in
    passes of 256, the query columns past what a block holds beside the
    ring streamed with passes of 128); f32 operands on the CUDA-core body (`_parts_cores`,
    counted in ``.f32_launches`` besides ``.launches``).  A shape it does
    not take raises ValueError before any launch, a launch failure raises.
    The ``lr=False`` launches of the Hopper body also count in
    ``.plain_launches``."""
    if q_cat.device.type == "cpu":
        return _hier_parts_plain(q_cat, k_cat, values, scale, mask_neg, idx,
                                 g_sem_cat, g_geo_cat, g_sem_vw, g_geo_vw,
                                 sem_d=sem_d, bm=bm, bn=bn, gpt_s=gpt_s,
                                 gpt_g=gpt_g, geo=geo, lr=lr)
    geo_ops = (g_geo_cat, g_geo_vw) if geo else ()
    if any(t is not None and t.dtype == torch.float32
           for t in (q_cat, k_cat, values, g_sem_cat, g_sem_vw, *geo_ops)):
        out = _parts_cores(q_cat, k_cat, values, scale, mask_neg, idx, g_sem_cat, g_geo_cat,
                           g_sem_vw, g_geo_vw, sem_d=sem_d, bm=bm, bn=bn, gpt_s=gpt_s,
                           gpt_g=gpt_g, lr=lr, geo=geo)
        if q_cat.shape[0] and idx.shape[1]:
            _count_cores(_hier_parts_call, "f32")
        return out
    out = _values_sm90("hier_parts", q_cat, k_cat, values, scale, mask_neg, idx,
                       (g_sem_cat, g_sem_vw, gpt_s),
                       (g_geo_cat, g_geo_vw, gpt_g) if geo else None, sem_d=sem_d,
                       bm=bm, bn=bn, merged=True, lr=lr)
    if q_cat.shape[0] and idx.shape[1]:
        _hier_parts_call.launches += 1
        if not lr:
            _hier_parts_call.plain_launches += 1
    return out


_hier_parts_call.launches = 0
_hier_parts_call.plain_launches = 0
_hier_parts_call.f32_launches = 0


def _parts_cores(q_cat, k_cat, values, scale, mask_neg, idx, g_sem_cat, g_geo_cat, g_sem_vw,
                 g_geo_vw, *, sem_d: int, bm: int, bn: int, gpt_s: int, gpt_g: int,
                 lr: bool, geo: bool):
    """`_hier_parts_call` on the CUDA-core body, the layout of
    `_hier_parts_plain`: per family a row pass (acc, d) and a group pass
    (the sem approximation into alr with ``lr``, else each approximation
    subtracted from its family's acc and d)."""
    ops = dict(q_cat=q_cat, k_cat=k_cat, values=values, scale=scale, mask_neg=mask_neg,
               idx=idx, g_sem_cat=g_sem_cat, g_sem_vw=g_sem_vw)
    if geo:
        ops.update(g_geo_cat=g_geo_cat, g_geo_vw=g_geo_vw)
    _cores_check("hier_parts", ops)
    Bp, cat_d = q_cat.shape
    N, Dv = values.shape
    Ws = g_sem_vw.shape[1]
    fams = [(g_sem_cat, g_sem_vw, gpt_s)] + ([(g_geo_cat, g_geo_vw, gpt_g)] if geo else [])
    _list_shapes("hier_parts", q_cat, idx, bm=bm, fams=fams)
    _rows_shapes("hier_parts", k_cat, mask_neg, idx, values, bn=bn, scale=scale)
    if (k_cat.shape[1] != cat_d or not 0 < sem_d < cat_d or g_sem_cat.shape[1] > sem_d
            or bn % gpt_s or (not lr and Ws < Dv + 1)
            or (geo and (bn % gpt_g or g_geo_vw.shape[1] < Dv + 1))):
        raise ValueError(
            f"hier_parts kernel (CUDA cores): unsupported shapes q {tuple(q_cat.shape)}, k "
            f"{tuple(k_cat.shape)}, values {tuple(values.shape)}, vw {tuple(g_sem_vw.shape)}"
            f", sem_d={sem_d}, bn={bn}, gpt {gpt_s} / {gpt_g}, lr={lr}")
    out = torch.zeros((Bp, 2 * Dv + 128 + (Ws if lr else 0)), dtype=torch.float32,
                      device=q_cat.device)
    if not (Bp and idx.shape[1]):
        return out
    grp = dict(idx=idx, bm=bm, out=out)
    _cores_rows(q_cat, k_cat, mask_neg, idx, values, out, kf=sem_d, bm=bm, bn=bn,
                scale=scale, dcol=2 * Dv)
    if lr:
        _cores_groups(q_cat, g_sem_cat, wk=g_sem_cat.shape[1], gpt=gpt_s, vw=g_sem_vw, nvc=Ws,
                      oc0=2 * Dv + 128, **grp)
    else:
        _cores_groups(q_cat, g_sem_cat, wk=g_sem_cat.shape[1], gpt=gpt_s, vw=g_sem_vw, nvc=Dv,
                      cntc=Dv, dcol=2 * Dv, sign=-1.0, accumulate=True, **grp)
    if geo:
        gg = g_geo_cat.shape[1]
        _cores_rows(q_cat, k_cat, mask_neg, idx, values, out, kf=cat_d - sem_d, qc0=sem_d,
                    kc0=sem_d, bm=bm, bn=bn, scale=scale, oc0=Dv, dcol=2 * Dv + 1)
        _cores_groups(q_cat, g_geo_cat, wk=gg, qc0=cat_d - gg, gpt=gpt_g, vw=g_geo_vw,
                      nvc=Dv, oc0=Dv, cntc=Dv, dcol=2 * Dv + 1, sign=-1.0, accumulate=True,
                      **grp)
    return out


def _stacked_bases(w_sem, u_sem, w_geo, u_geo):
    """[w; u] per family, f32 (`_combine_cat_call`, `:3150-3151`); the geo
    family without a low-rank tail (``u_geo`` None) takes w_geo alone."""
    geo = w_geo if u_geo is None else torch.cat([w_geo, u_geo], 0)
    return (torch.cat([w_sem, u_sem], 0).to(torch.float32).contiguous(),
            geo.to(torch.float32).contiguous())


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 x rounded to TF32 (10 stored mantissa bits), to nearest with ties
    away from zero, as `cvt.rna.tf32.f32`: the low 13 bits of the sign-
    magnitude pattern, rounded on the magnitude, cleared."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_split(x: torch.Tensor):
    """(hi, lo), both TF32 values: hi = rna(x), lo = rna(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x.to(torch.float32) - hi)


@torch.no_grad()
def _combine_images(w_sem, u_sem, w_geo, u_geo) -> torch.Tensor:
    """The split bases of `csrc/combine_cat_sm90.cu`, once per bank: B =
    [w_sem; u_sem; w_geo (; u_geo)] [K, Dv] f32 in TF32 halves, as [Dv / nb]
    column blocks x [K / 32] chunks x [hi | lo] x [nb rows][32] K-major
    tiles in the 128-byte swizzle (row n, 32 consecutive K; a block's chunk
    is one contiguous copy), nb = 128."""
    B = torch.cat(_stacked_bases(w_sem, u_sem, w_geo, u_geo), 0)
    K, Dv = B.shape
    t = torch.stack(_tf32_split(B)).reshape(2, K // 32, 32, Dv // 128, 128)
    return swizzle128(t.permute(3, 1, 0, 4, 2).contiguous())


def _combine_plan(Bp: int, Dv: int, K: int) -> dict:
    """`csrc/combine_cat_sm90.cu`'s launch: blocks of 128 rows x 128
    columns, threads, dynamic shared memory (its `Layout::TOTAL`, checked
    against `combine_cat_sm90_smem` on the card), the stages of its two
    rings (the split bases', the A sources') and their bytes, 32-deep
    chunks of K."""
    ns, stage, src, a_tile = 2, 2 * 128 * 128, 2 * 128 * 128, 64 * 128
    return dict(grid=((Bp + 127) // 128, Dv // 128), threads=384,
                smem=ns * (stage + src) + 8 * a_tile + 32 * ns + 1024, stages=ns,
                stage_bytes=(stage, src), chunks=K // 32)


def _combine_coefs(ps, pg, tails, *, Ws, r, rrp, Dv, beta, rg, Wg):
    """(A, geo0): the combine's coefficient rows scaled by beta / max(d_s,
    1e-30) and (1 - beta) / max(d_g, 1e-30), [Bp, 2 rrp + r + rg], and at
    rg = 0 the scaled additive geo terms (1 - beta) (pg[:, :Dv] +
    tails_g[:, :Dv]) / max(d_g, 1e-30) (else None); f32, rounded as the
    kernel rounds them."""
    corr = tails[:, :Ws] - ps[:, rrp + 128:]
    ss = beta / torch.clamp_min(ps[:, rrp:rrp + 1] + corr[:, r:r + 1], 1e-30)
    a_s = torch.cat([ps[:, :rrp], corr[:, :r]], 1) * ss
    geo0 = None
    if rg:
        corr_g = tails[:, Ws:Ws + Wg] - pg[:, rrp + 128:]
        sg = (1.0 - beta) / torch.clamp_min(pg[:, rrp:rrp + 1] + corr_g[:, rg:rg + 1], 1e-30)
        a_g = torch.cat([pg[:, :rrp], corr_g[:, :rg]], 1) * sg
    else:
        sg = (1.0 - beta) / torch.clamp_min(pg[:, Dv:Dv + 1] + tails[:, Ws + Dv:Ws + Dv + 1],
                                            1e-30)
        a_g = pg[:, Dv + 128:] * sg
        geo0 = sg * (pg[:, :Dv] + tails[:, Ws:Ws + Dv])
    return torch.cat([a_s, a_g], 1), geo0


def _rz_add(acc: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """f32 acc + f64 inc, rounded toward zero."""
    exact = acc.double() + inc
    near = exact.to(torch.float32)
    over = near.double().abs() > exact.abs()
    return torch.where(over, torch.nextafter(near, torch.zeros_like(near)), near)


def _combine_cat_tf32x3(ps, pg, tails, q_srt, img, *, Ws: int, r: int, rrp: int,
                        Dv: int, beta: float, rg: int, Wg: int, chain: str = "chunks"):
    """Plain version of `csrc/combine_cat_sm90.cu`'s arithmetic, from its
    split bases ``img`` (`_combine_images`, unswizzled here): A =
    `_combine_coefs`, split into TF32 halves like the bases, and the three
    products lo hi + hi lo + hi hi a k8 step (lo lo dropped).  How the
    products sum: ``"exact"`` in f64 (the split's error alone); ``"chunks"``
    as the kernel sums them, each 32-deep chunk's twelve products in a
    fresh f32 fragment truncated toward zero after each (a pessimistic
    model of the tensor cores' accumulator), the fragments into the running
    sum rounded to nearest; ``"rz"`` all of them in one such truncated
    chain (one accumulator, the design the kernel does not use)."""
    A, geo0 = _combine_coefs(ps, pg, tails, Ws=Ws, r=r, rrp=rrp, Dv=Dv, beta=beta, rg=rg,
                             Wg=Wg)
    K = A.shape[1]
    t = swizzle128(img).permute(2, 1, 4, 0, 3).reshape(2, K, Dv).double()
    bh, bl = t[0], t[1]
    ah, al = (x.double() for x in _tf32_split(A))
    if chain == "exact":
        acc = (ah @ bh + ah @ bl + al @ bh).to(torch.float32)
    else:
        acc = torch.zeros(A.shape[0], Dv, dtype=torch.float32, device=A.device)
        frag = acc
        for k0 in range(0, K, 8):
            if chain == "chunks" and k0 % 32 == 0:
                frag = torch.zeros_like(acc)
            ks = slice(k0, k0 + 8)
            for a, b in ((al, bh), (ah, bl), (ah, bh)):
                frag = _rz_add(frag, a[:, ks] @ b[ks])
            if chain == "chunks" and k0 % 32 == 24:
                acc = acc + frag
        if chain == "rz":
            acc = frag
    if geo0 is not None:
        acc = acc + geo0
    return torch.cat([acc, q_srt.to(torch.float32)], 1)


def _combine_cat_plain(ps, pg, tails, q_srt, w_sem, u_sem, w_geo, u_geo, *,
                       Ws: int, r: int, rrp: int, Dv: int, beta: float,
                       rg: int, Wg: int):
    """Plain version of the combine kernel (`_combine_cat_kernel`,
    `retrieval_hier.py:3102-3139`): corr = tails - approx; [rr
    coefficients | corr] @ [w; u] per family; d = d_parts + corr[:, r];
    each family over max(d, 1e-30), beta blend, then the queries.  ``rg =
    0`` (no lr_geo; ``pg`` = acc | d | pad | az, the full-width geo tail):
    acc_g = pg[:, :Dv] + tails_g[:, :Dv] + az @ w_geo, d_g = pg[:, Dv] +
    tails_g[:, Dv]."""
    wsem, wgeo = _stacked_bases(w_sem, u_sem, w_geo, u_geo)
    corr = tails[:, :Ws] - ps[:, rrp + 128:]
    acc_s = torch.cat([ps[:, :rrp], corr[:, :r]], 1) @ wsem
    d_s = ps[:, rrp:rrp + 1] + corr[:, r:r + 1]
    if rg:
        corr_g = tails[:, Ws:Ws + Wg] - pg[:, rrp + 128:]
        acc_g = torch.cat([pg[:, :rrp], corr_g[:, :rg]], 1) @ wgeo
        d_g = pg[:, rrp:rrp + 1] + corr_g[:, rg:rg + 1]
    else:
        acc_g = pg[:, :Dv] + tails[:, Ws:Ws + Dv] + pg[:, Dv + 128:] @ wgeo
        d_g = pg[:, Dv:Dv + 1] + tails[:, Ws + Dv:Ws + Dv + 1]
    sem = acc_s / torch.clamp_min(d_s, 1e-30)
    geo = acc_g / torch.clamp_min(d_g, 1e-30)
    return torch.cat([beta * sem + (1.0 - beta) * geo,
                      q_srt.to(torch.float32)], 1)


def _combine_cat_call(ps, pg, tails, q_srt, w_sem, u_sem, w_geo, u_geo, *,
                      Ws: int, r: int, rrp: int, Dv: int, beta: float,
                      rg: int, Wg: int, tier: str = "fast"):
    """Combine + concat epilogue: [Bp, Dv + Dq] f32 (``q_srt`` may have 0
    columns).  ``rg = 0``: the geo family without a low-rank tail
    (``u_geo`` None, ``Wg`` the full-width tail's columns).

    CPU tensors: `_combine_cat_plain`.  CUDA tensors, each replacing
    `_combine_cat_kernel` (`range_tpu/ops/retrieval_hier.py:3102`): at the
    ``fast`` and ``high`` tiers `csrc/combine_cat_sm90.cu` (the products as
    three TF32 products on the tensor cores, over the bank's split bases,
    `_combine_images`, built once per bank); at ``tier="exact"`` (the
    bank's tier, from `retrieve_hier`) `csrc/combine_cat.cu` (f32 FMAs),
    counted in ``.exact_launches`` too.  The new body's rg = 0 launches
    also count in ``.rg0_launches``."""
    if ps.device.type == "cpu":
        return _combine_cat_plain(ps, pg, tails, q_srt, w_sem, u_sem, w_geo,
                                  u_geo, Ws=Ws, r=r, rrp=rrp, Dv=Dv,
                                  beta=beta, rg=rg, Wg=Wg)
    f32 = torch.float32
    ops = dict(ps=ps, pg=pg, tails=tails, q_srt=q_srt)
    _check_cuda("combine_cat", ops, dict.fromkeys(ops, f32))
    u_geo = u_geo if rg else None
    sources = [w_sem, u_sem, w_geo] + ([u_geo] if rg else [])
    Bp, Dq = q_srt.shape
    pg_w = rrp + 128 + Wg if rg else Dv + 128 + rrp
    if (ps.shape != (Bp, rrp + 128 + Ws) or pg.shape != (Bp, pg_w)
            or tails.shape != (Bp, Ws + Wg) or w_sem.shape[0] + u_sem.shape[0] != rrp + r
            or w_geo.shape[0] + (u_geo.shape[0] if rg else 0) != rrp + rg
            or w_sem.shape[1] != Dv or Dv % 128 or Dq % 4
            or r >= Ws or (rg >= Wg if rg else Wg < Dv + 1)
            or (tier != "exact" and (rrp % 32 or r % 32 or rg % 32 or Ws % 4 or Wg % 4))):
        raise ValueError(
            f"combine_cat kernel: unsupported shapes ps {tuple(ps.shape)}, "
            f"pg {tuple(pg.shape)}, tails {tuple(tails.shape)}, q "
            f"{tuple(q_srt.shape)}, r={r}, rg={rg}, rrp={rrp}, Dv={Dv}")
    ops = [t.contiguous() for t in ops.values()]
    out = torch.empty((Bp, Dv + Dq), dtype=f32, device=ps.device)
    if not Bp:
        return out
    if tier == "exact":
        wsem, wgeo = prepared("combine_cat", sources,
                              lambda: _stacked_bases(w_sem, u_sem, w_geo, u_geo), (rg > 0,))
        _launch("combine_cat", "combine_cat_launch",
                *[t.data_ptr() for t in ops + [wsem, wgeo, out]],
                Bp, Dq, Ws, r, rrp, Dv, rg, Wg, ctypes.c_float(beta),
                _stream(ps))
        _combine_cat_call.exact_launches += 1
    else:
        img = prepared("combine_cat_sm90", sources,
                       lambda: _combine_images(w_sem, u_sem, w_geo, u_geo), (rg > 0,))
        _launch("combine_cat_sm90", "combine_cat_sm90_launch",
                *[t.data_ptr() for t in ops + [img, out]],
                Bp, Dq, Ws, r, rrp, Dv, rg, Wg, ctypes.c_float(beta), _stream(ps))
        if not rg:
            _combine_cat_call.rg0_launches += 1
    _combine_cat_call.launches += 1
    return out


_combine_cat_call.launches = 0
_combine_cat_call.rg0_launches = 0
_combine_cat_call.exact_launches = 0


def _hier_klist_plain(q2, ql, khl, mask_neg, idx, *, Dk: int, k: int,
                      bm: int, bn: int):
    """The k-carry of `_hier_topk_kernel` (`retrieval_hier.py:1700-1722`;
    k = 1 is `_hier_argmax_kernel`, `:1660-1673`), written out: per query
    block, over its selected tiles in idx order, the logits
    (q2 . khl + ql . kh) + mask in f32; the tile's k best in extraction
    order (value descending, the lower in-tile index first: the kernel's k
    masked maxes); each replaces the running list's first minimum when
    strictly greater.  Returns the unsorted list (scores [Bp, k] f32, rows
    [Bp, k] int32), NEG / row 0 where nothing entered."""
    f32 = torch.float32
    nB, K = idx.shape
    dev = q2.device
    q2f = q2.to(f32).reshape(nB, bm, -1)
    qlf = ql.to(f32).reshape(nB, bm, -1)
    best = torch.full((nB, bm, k), NEG, dtype=f32, device=dev)
    rows = torch.zeros((nB, bm, k), dtype=torch.int32, device=dev)
    in_tile = torch.arange(bn, device=dev)
    kpos = torch.arange(k, device=dev)
    for j in range(K):
        row0 = idx[:, j].long() * bn                 # [nB]
        tile_rows = row0[:, None] + in_tile          # [nB, bn]
        kt = khl[tile_rows].to(f32)                  # [nB, bn, 2 Dk]
        logit = (q2f @ kt.transpose(1, 2)
                 + qlf @ kt[:, :, :Dk].transpose(1, 2))
        logit = (logit + mask_neg[0, tile_rows][:, None, :]).reshape(-1, bn)
        if k == 1:
            tv = logit.amax(dim=1, keepdim=True)
            ti = first_argmax(logit)[:, None]
        else:
            tv, ti = topk_stable(logit, k)
        tv, ti = tv.reshape(nB, bm, k), ti.reshape(nB, bm, k)
        for r in range(k):
            m = tv[..., r:r + 1]
            cmin = best.amin(dim=2, keepdim=True)
            cpos = torch.where(best <= cmin, kpos, k).amin(dim=2, keepdim=True)
            put = (m > cmin) & (kpos == cpos)
            best = torch.where(put, m, best)
            rows = torch.where(put, (ti[..., r:r + 1] + row0[:, None, None]).to(
                torch.int32), rows)
    return best.reshape(-1, k), rows.reshape(-1, k)


def _hier_argmax_plain(q2, ql, khl, mask_neg, idx, *, Dk: int, bm: int,
                       bn: int):
    """Plain version of the hi/lo argmax kernel: (score [Bp] f32, row [Bp]
    int32) of each query's best row over its block's selected tiles."""
    s, r = _hier_klist_plain(q2, ql, khl, mask_neg, idx, Dk=Dk, k=1, bm=bm,
                             bn=bn)
    return s[:, 0], r[:, 0]


def _sort_klist(scores, rows):
    """The wrapper's final sort (`retrieval_hier.py:1779-1782`): descending,
    ties keeping list order (`lax.top_k`)."""
    s, sel = topk_stable(scores, scores.shape[1])
    return s, torch.gather(rows, 1, sel)


def _hier_topk_plain(q2, ql, khl, mask_neg, idx, *, Dk: int, k: int,
                     bm: int, bn: int):
    """Plain version of the k-carry top-k kernel plus its wrapper's sort:
    (scores [Bp, k] f32, rows [Bp, k] int32), descending."""
    return _sort_klist(*_hier_klist_plain(q2, ql, khl, mask_neg, idx, Dk=Dk,
                                          k=k, bm=bm, bn=bn))


KLIST_BN = 64  # bank rows a step of the top-k kernel: one wgmma N
# the top-k kernel's cost of a block's start-up (its queries, the ring's
# first stages, its share of the fold), in steps of KLIST_BN rows
KLIST_STARTUP_STEPS = 8


class KlistPlan(NamedTuple):
    """The top-k kernel's plan: ``bmb`` queries a block (128: both halves
    of a selection block on one ring; 64), ``n_seg`` segments of each list
    (segment s a block's entries [s K / n_seg, (s + 1) K / n_seg)), ``S``
    ring stages."""
    bmb: int
    n_seg: int
    S: int


KLIST_PASS_BOXES = 4  # key boxes (64 columns) the top-k kernel's chain takes in one pass
KLIST_DEEP_BOXES = 2  # past them, key boxes of a pass: 128 columns
KLIST_DK_MAX = 512    # key columns it takes: four passes


def _klist_pass_boxes(Dk: int) -> int:
    """Key boxes of one pass (a ring stage's) of the top-k kernel's chain."""
    kb = -(-Dk // 64)
    return kb if kb <= KLIST_PASS_BOXES else KLIST_DEEP_BOXES


def _klist_passes(Dk: int) -> int:
    """Passes a step of the top-k kernel takes: 1 up to 256 columns, else
    one per 128."""
    return -(-(-(-Dk // 64)) // _klist_pass_boxes(Dk))


def _klist_smem(bmb: int, Dk: int, S: int) -> int:
    """Shared memory of a top-k block (`layout` in csrc/hier_argmax_sm90.cu):
    each query half's ql boxes (every one of the key width's), S stages of
    one pass's kh and kl boxes (64 rows of 64 columns, 8 KB each:
    `_klist_pass_boxes` of each), their masks, each consumer warp's 2 KB
    scratch, the barriers, the alignment slack."""
    box = KLIST_BN * 128
    kb = -(-Dk // 64)
    kbs = _klist_pass_boxes(Dk)
    return (bmb // 64 * (kb * box + 4 * 2048) + S * (2 * kbs * box + KLIST_BN * 4)
            + 8 * (1 + 2 * S) + 1024)


@functools.lru_cache(maxsize=256)
def _klist_plan(Bp: int, bm: int, K: int, bn: int, Dk: int, k: int) -> KlistPlan:
    """The top-k kernel's plan, a function of the shape alone: 128 queries
    a block where bm allows it and a ring of 2 stages fits beside them
    (every width up to 512 columns), else 64; the deepest ring of 4, 3,
    2 stages that fits; the segment count of least modelled time, ties to
    the fewest: waves of blocks on the card's 132 SMs (one block an SM)
    times a block's steps (each its `_klist_passes` ring items) plus its
    start-up (KLIST_STARTUP_STEPS).  k does not change it.  lru-cached:
    serving asks for the same few shapes."""
    for bmb in ((128, 64) if bm % 128 == 0 else (64,)):
        S = next((S for S in (4, 3, 2) if _klist_smem(bmb, Dk, S) <= _SM90_MAX_SMEM), None)
        if S is not None:
            break
    else:
        raise ValueError(f"hier_argmax kernel: no block holds {Dk}-column keys")
    n_qb, spt = Bp // bmb, -(-bn // KLIST_BN) * _klist_passes(Dk)

    def cost(n):
        return -(-n_qb * n // SM90_SMS) * (-(-K // n) * spt + KLIST_STARTUP_STEPS)

    return KlistPlan(bmb, min(range(1, K + 1), key=lambda n: (cost(n), n)), S)


def _klist_kernel(entry: str, q2, ql, khl, mask_neg, idx, *, Dk: int, k: int,
                  bm: int, bn: int, plan: Optional[KlistPlan] = None):
    """Launch `csrc/hier_argmax_sm90.cu`'s entry point ``entry`` over
    `_klist_plan`'s segments (``plan`` overrides it) and its fold: the
    unsorted running list (scores [Bp, k] f32, rows [Bp, k] int32).  A
    shape the kernel does not take raises ValueError before any launch."""
    bf = torch.bfloat16
    ops = dict(q2=q2, ql=ql, khl=khl, mask_neg=mask_neg, idx=idx)
    _check_cuda("hier_argmax", ops, dict(q2=bf, ql=bf, khl=bf,
                                         mask_neg=torch.float32,
                                         idx=torch.int32))
    Bp, N = q2.shape[0], khl.shape[0]
    nB, K = idx.shape
    if (q2.shape != (Bp, 2 * Dk) or ql.shape != (Bp, Dk)
            or khl.shape != (N, 2 * Dk) or mask_neg.shape != (1, N)
            or Bp != nB * bm or bm % 64 or bn < 32 or bn % 32 or N % bn or N == 0
            or Dk % 8 or not 8 <= Dk <= KLIST_DK_MAX or K < 1 or not 1 <= k <= 8):
        raise ValueError(
            f"hier_argmax kernel: unsupported shapes q2 {tuple(q2.shape)}, "
            f"ql {tuple(ql.shape)}, khl {tuple(khl.shape)}, idx "
            f"{tuple(idx.shape)}, Dk={Dk}, k={k}, bm={bm}, bn={bn}")
    ops = [t.contiguous() for t in ops.values()]
    scores = torch.empty((Bp, k), dtype=torch.float32, device=q2.device)
    rows = torch.empty((Bp, k), dtype=torch.int32, device=q2.device)
    if Bp:
        plan = plan or _klist_plan(Bp, bm, K, bn, Dk, k)
        # each (query, tile)'s k best: (score, the row's int32 bits)
        work = torch.empty((Bp, K, k, 2), dtype=torch.float32, device=q2.device)
        ks = [k] if entry == "hier_topk_sm90_launch" else []
        _launch("hier_argmax_sm90", entry,
                *[t.data_ptr() for t in ops + [scores, rows, work]], Bp, N, Dk, bm,
                bn, K, *ks, *plan, _stream(q2))
    return scores, rows


def _hier_argmax_call(q2, ql, khl, mask_neg, idx, *, Dk: int, bm: int,
                      bn: int):
    """Exact hi/lo semantic argmax over each block's selected tiles: (score
    [Bp] f32, row [Bp] int32).  q2 = [qh | qh] [Bp, 2 Dk], ql [Bp, Dk],
    khl = [kh | kl] [N, 2 Dk], mask_neg [1, N], idx [Bp / bm, K] (tiles
    < N / bn, as `select_tiles` gives them).

    CPU tensors: `_hier_argmax_plain`.  CUDA tensors: the Hopper kernel
    `csrc/hier_argmax_sm90.cu` (hier_argmax_sm90_launch and its fold, one
    count), which replaces `_hier_argmax_kernel`
    (`range_tpu/ops/retrieval_hier.py:1645`); bf16 operands, a launch
    failure raises.  Rows travel as int32, not as the TPU's f32 lanes."""
    if q2.device.type == "cpu":
        return _hier_argmax_plain(q2, ql, khl, mask_neg, idx, Dk=Dk, bm=bm,
                                  bn=bn)
    s, r = _klist_kernel("hier_argmax_sm90_launch", q2, ql, khl, mask_neg, idx,
                         Dk=Dk, k=1, bm=bm, bn=bn)
    if q2.shape[0]:
        _hier_argmax_call.launches += 1
    return s[:, 0], r[:, 0]


_hier_argmax_call.launches = 0


def _hier_topk_call(q2, ql, khl, mask_neg, idx, *, Dk: int, k: int, bm: int,
                    bn: int):
    """The k-carry top-k (1 <= k <= 8) over each block's selected tiles,
    operands as `_hier_argmax_call`: (scores [Bp, k] f32, rows [Bp, k]
    int32) sorted descending, ties keeping the running list's order.

    CPU tensors: `_hier_topk_plain`.  CUDA tensors: the Hopper kernel
    `csrc/hier_argmax_sm90.cu` (hier_topk_sm90_launch and its fold, one
    count), which replaces `_hier_topk_kernel`
    (`range_tpu/ops/retrieval_hier.py:1682`), then the same sort."""
    if q2.device.type == "cpu":
        return _hier_topk_plain(q2, ql, khl, mask_neg, idx, Dk=Dk, k=k,
                                bm=bm, bn=bn)
    lists = _klist_kernel("hier_topk_sm90_launch", q2, ql, khl, mask_neg, idx,
                          Dk=Dk, k=k, bm=bm, bn=bn)
    if q2.shape[0]:
        _hier_topk_call.launches += 1
    return _sort_klist(*lists)


_hier_topk_call.launches = 0


# ---------------------------------------------------------------------------
# the serving pipeline


def _bank_uses(hb: HierBank):
    """(use_lr, use_rr, use_lrg): which of the bank's low-rank sem tail,
    residual-rank parts and low-rank geo tail serving can use
    (`retrieval_hier.py:2775-2781,3287-3288`)."""
    return (hb.g_sem_vw_lr is not None and hb.lr_rank > 0,
            bool(hb.res_rank) and hb.z_sem is not None,
            hb.g_geo_vw_lr is not None and hb.lr_geo > 0)


def _dedup_union(idx: torch.Tensor, f: int, k_union: int) -> torch.Tensor:
    """Merge each f adjacent query blocks' tile lists into one list
    [nB / f, k_union] without repeats (`retrieval_hier.py:2025-2068`).

    The columns interleave rank-major (rank 0 of blocks 0..f-1, then rank
    1, ...), so a truncation to k_union drops the lowest ranks first; a
    stable sort by tile marks every copy after the first as a duplicate;
    the distinct entries keep their column order and the slots past them
    repeat the last distinct tile (the parts kernels' ``dedup_pad`` skips
    such repeats)."""
    nB, K = idx.shape
    nS = nB // f
    if nS * f != nB:
        raise ValueError(f"_dedup_union: {nB} blocks do not merge in {f}s")
    k_union = min(k_union, f * K)
    m = idx.reshape(nS, f, K).transpose(1, 2).reshape(nS, f * K)
    pos = torch.argsort(m, dim=1, stable=True)
    srt = torch.gather(m, 1, pos)
    dup_srt = torch.cat([torch.zeros((nS, 1), dtype=torch.bool, device=m.device),
                         srt[:, 1:] == srt[:, :-1]], 1)
    dup = torch.zeros_like(dup_srt).scatter_(1, pos, dup_srt)
    cols = torch.arange(f * K, device=m.device)[None, :]
    prio = torch.where(dup, f * K + cols, cols)
    order = torch.argsort(prio, dim=1, stable=True)[:, :k_union]
    out = torch.gather(m, 1, order)
    n_distinct = (~dup).sum(dim=1, keepdim=True)
    last = torch.gather(out, 1, torch.clamp_max(n_distinct - 1, k_union - 1))
    return torch.where(cols[:, :k_union] < n_distinct, out, last).to(torch.int32)


def _rescue_queries(s_s, sel_s, s_g, sel_g, *, bm: int, n_valid: int,
                    R: int) -> torch.Tensor:
    """The adaptive rescue's R queries (`retrieval_hier.py:2902-2916`): each
    query's coverage, the share of its exp-mass (the scan stats) that its
    block's selected tiles hold, the smaller of the two families'; padded
    queries never count.  The R lowest (ties: the lower index, as
    `lax.top_k`), in ascending query order so the rescue blocks stay
    geographically coherent.  Returns [R] int64 sorted positions."""
    Bp = s_s.shape[0]

    def cov(s, selm):
        tot = torch.clamp_min(s.sum(dim=1), 1e-30)
        selq = torch.bmm(s.reshape(Bp // bm, bm, -1), selm[:, :, None])
        return selq.reshape(Bp) / tot

    c = torch.minimum(cov(s_s, sel_s), cov(s_g, sel_g))
    c = torch.where(torch.arange(Bp, device=c.device) < n_valid, c,
                    float("inf"))
    return torch.sort(topk_stable(-c[None, :], R)[1][0]).values


def _hier_partials(q_cat: torch.Tensor, hb: HierBank, *, k_tiles: int,
                   bm: int, j_sem: int, j_geo: int, n_valid: int,
                   k_geo: int, m_corr: int = 0, raw: bool = False,
                   adaptive_frac: float = 0.0, adaptive_mult: int = 3,
                   dedup: int = 0, k_union: Optional[int] = None):
    """Scan, per-family selection and the two family parts kernels on
    sorted, packed queries: the family-split (k_geo > 0) branch of
    `_hier_partials` (`retrieval_hier.py:2753-3003`), RANGE+ only.
    ``raw=True`` (the fused combine's shape, lr + rr) returns the
    pre-combine pieces (parts_s, parts_g, tails); otherwise the
    unnormalized (acc_s, acc_g, d_s, d_g) f32 of JAX's combine branches
    for lr + rr, lr, rr or neither on the sem family and lr_geo (with or
    without rr) or the full-width tail on the geo family, as plain torch
    ops (XLA glue in JAX).

    tail_super banks: the scan contracts the supergroup operand
    g_sem_ts_vw (`_hier_scan_call(sup_r=)`), ONE selection keeps k_tiles +
    ``m_corr`` sem tiles, the first k_tiles of them take the exact parts,
    and the correction kernel adds exp2(q . g_fine) @ (vw - ts_vw) over
    all of them to the sem tail, so that the selected tiles' tail is the
    fine-group one the parts kernel subtracts.

    sel_lr banks (`:2795-2824`): the queries project once onto p_sel (f32,
    rounded to the packed dtype); the scan reads [q_sel | geo columns]
    against g_sem_sel and the sem parts kernel [q_cat | q_sel] (its sel
    form), so both sides of the telescope see the same sketched logits.

    ``dedup`` > 1 (`:2863-2886`): f = dedup adjacent blocks' lists merge by
    `_dedup_union` into one list of k_union (default k_tiles + (f - 1)
    k_tiles // 2) sem tiles and a proportional geo count, served as one
    block of f bm queries by the parts kernels' dedup_pad form; skipped on
    tail_super banks and when the padded batch is no multiple of f bm.

    ``adaptive_frac`` > 0, the rescue (`:2891-2950`): the R = frac Bp
    (down to a multiple of 128) queries whose selected tiles cover the
    least exp-mass (`_rescue_queries`) re-select adaptive_mult times the
    budgets (j + 4) in blocks of 128 and re-run both parts kernels (and,
    on tail_super banks, the correction); their rows replace theirs in the
    partials before the combine."""
    f32 = torch.float32
    gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
    use_lr, use_rr, use_lrg = _bank_uses(hb)
    sem_vw = hb.g_sem_vw_lr if use_lr else hb.g_sem_vw
    geo_vw = hb.g_geo_vw_lr if use_lrg else hb.g_geo_vw
    use_ts = bool(hb.tail_super) and hb.g_sem_ts_vw is not None
    use_sel = bool(hb.sel_lr) and hb.g_sem_sel is not None
    if use_sel:
        q_sel = (q_cat[:, :hb.sem_d].to(f32) @ hb.p_sel.T).to(q_cat.dtype)
        q_scan = torch.cat([q_sel, q_cat[:, hb.sem_d:]], 1)
        q_sem_parts = torch.cat([q_cat, q_sel], 1)
        sem_gcat = hb.g_sem_sel
    else:
        q_scan = q_sem_parts = q_cat
        sem_gcat = hb.g_sem_cat
    m_s, s_s, m_g, s_g, tails = _hier_scan_call(
        q_scan, sem_gcat, hb.g_geo_cat,
        hb.g_sem_ts_vw if use_ts else sem_vw, geo_vw,
        gpt_s=gpt_s, gpt_g=gpt_g,
        sup_r=hb.tail_super // hb.gsz_sem if use_ts else 0)
    idx_sm, sel_s = select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real,
                                 k_tiles=k_tiles + (m_corr if use_ts else 0),
                                 bm=bm, n_valid=n_valid, j_sem=j_sem,
                                 j_geo=j_geo, mode="range")
    # top_k's columns come score-descending: the first k_tiles are the
    # exact tiles, and every listed tile is corrected
    idx_s = idx_sm[:, :min(k_tiles, idx_sm.shape[1])] if use_ts else idx_sm
    idx_g, sel_g = select_tiles(m_g, s_g, m_s, s_s, t_real=hb.t_real,
                                k_tiles=k_geo, bm=bm, n_valid=n_valid,
                                j_sem=j_geo, j_geo=j_sem, mode="range")
    Bp = q_cat.shape[0]
    idx_ps, idx_pg, bm_p = idx_s, idx_g, bm
    if dedup > 1 and not use_ts and Bp % (dedup * bm) == 0:
        ku_s = min(k_union or (k_tiles + (dedup - 1) * k_tiles // 2),
                   dedup * idx_s.shape[1])
        ku_g = min(max(1, ku_s * max(k_geo, 1) // max(k_tiles, 1)),
                   dedup * max(idx_g.shape[1], 1))
        idx_ps = _dedup_union(idx_s, dedup, ku_s)
        idx_pg = _dedup_union(idx_g, dedup, ku_g)
        bm_p = bm * dedup
    common = dict(sem_d=hb.sem_d, bn=hb.bn, values=hb.values,
                  scale=hb.value_scale)

    def parts(q_sem_ops, q_geo_ops, i_s, i_g, bm_x, pad):
        ps = _hier_parts_family_call(
            q_sem_ops, hb.k_cat, hb.mask_neg, i_s, sem_gcat, sem_vw,
            hb.z_sem if use_rr else None, bm=bm_x, gpt=gpt_s, geo=False,
            lrr=hb.lr_rank if use_lr else hb.value_dim, lr=use_lr,
            sel=use_sel, dedup_pad=pad, **common)
        pg = _hier_parts_family_call(
            q_geo_ops, hb.k_cat, hb.mask_neg, i_g, hb.g_geo_cat, geo_vw,
            hb.z_geo if use_rr else None, bm=bm_x, gpt=gpt_g, geo=True,
            lrr=hb.lr_geo if use_lrg else hb.value_dim, lr=use_lrg,
            dedup_pad=pad, geo_cols=geo_real_cols(hb.tier), **common)
        return ps, pg

    parts_s, parts_g = parts(q_sem_parts, q_cat, idx_ps, idx_pg, bm_p,
                             bm_p != bm)
    corr_ts = (_hier_corr_call(q_cat, idx_sm, hb.g_sem_cat, hb.g_sem_ts_dvw,
                               bm=bm, gpt=gpt_s) if use_ts else None)
    bm_r = 128  # rescue blocks are small: the gathered queries span sphere
    R = int(adaptive_frac * Bp) // bm_r * bm_r
    if R and R < Bp:
        w = _rescue_queries(s_s, sel_s, s_g, sel_g, bm=bm, n_valid=n_valid,
                            R=R)
        st_s, st_g = (m_s[w], s_s[w]), (m_g[w], s_g[w])
        k2 = min(adaptive_mult * k_tiles, hb.t_real)
        kg2 = min(adaptive_mult * k_geo, hb.t_real)
        idx_s2, _ = select_tiles(
            *st_s, *st_g, t_real=hb.t_real,
            k_tiles=k2 + (adaptive_mult * m_corr if use_ts else 0), bm=bm_r,
            n_valid=R, j_sem=j_sem + 4, j_geo=j_geo, mode="range")
        if use_ts:
            # the wider exact list needs its own fine-tail correction cover
            corr_ts[w] = _hier_corr_call(q_cat[w], idx_s2, hb.g_sem_cat,
                                         hb.g_sem_ts_dvw, bm=bm_r, gpt=gpt_s)
            idx_s2 = idx_s2[:, :min(k2, idx_s2.shape[1])]
        idx_g2, _ = select_tiles(*st_g, *st_s, t_real=hb.t_real, k_tiles=kg2,
                                 bm=bm_r, n_valid=R, j_sem=j_geo + 4,
                                 j_geo=j_sem, mode="range")
        parts_s[w], parts_g[w] = parts(q_sem_parts[w], q_cat[w], idx_s2,
                                       idx_g2, bm_r, False)
    Ws = sem_vw.shape[1]
    if use_ts:
        tails[:, :Ws] += corr_ts
    if raw:
        return parts_s, parts_g, tails
    Dv = hb.value_dim
    if use_lr:
        r = hb.lr_rank
        a0 = hb.z_sem.shape[1] if use_rr else Dv  # the d column
        corr = tails[:, :Ws] - parts_s[:, a0 + 128:]
        lr_part = corr[:, :r] @ hb.u_sem.to(f32)
        acc_s = (parts_s[:, :a0] @ hb.w_sem.to(f32) + lr_part if use_rr
                 else parts_s[:, :Dv] + lr_part)
        d_s = parts_s[:, a0:a0 + 1] + corr[:, r:r + 1]
    else:
        acc_s = parts_s[:, :Dv] + tails[:, :Dv]
        if use_rr:
            acc_s = acc_s + parts_s[:, Dv + 128:] @ hb.w_sem.to(f32)
        d_s = parts_s[:, Dv:Dv + 1] + tails[:, Dv:Dv + 1]
    Wg = geo_vw.shape[1]
    if use_lrg:
        rg = hb.lr_geo
        a0 = hb.z_geo.shape[1] if use_rr else Dv
        corr_g = tails[:, Ws:Ws + Wg] - parts_g[:, a0 + 128:]
        lr_part = corr_g[:, :rg] @ hb.u_geo.to(f32)
        acc_g = (parts_g[:, :a0] @ hb.w_geo.to(f32) + lr_part if use_rr
                 else parts_g[:, :Dv] + lr_part)
        d_g = parts_g[:, a0:a0 + 1] + corr_g[:, rg:rg + 1]
    else:
        acc_g = parts_g[:, :Dv] + tails[:, Ws:Ws + Dv]
        if use_rr:
            acc_g = acc_g + parts_g[:, Dv + 128:] @ hb.w_geo.to(f32)
        d_g = parts_g[:, Dv:Dv + 1] + tails[:, Ws + Dv:Ws + Dv + 1]
    return acc_s, acc_g, d_s, d_g


def _hier_partials_merged(q_cat: torch.Tensor, hb: HierBank, *,
                          k_tiles: int, bm: int, j_sem: int, j_geo: int,
                          n_valid: int, mode: str):
    """The merged (k_geo = 0) branch of `_hier_partials` (`retrieval_hier.py:
    2832-2835,3004-3027`) on sorted, packed queries: the scan (RANGE: its
    sem family only; RANGE+ both, the geo tail over the full-width group
    sums), one selection, the merged parts kernel (lr variant on lr_rank
    banks, else the plain one; RANGE skips the geo family it discards) and
    the combine in torch.  Returns the unnormalized (acc_s, acc_g, d_s,
    d_g) f32 (acc_g and d_g None in RANGE mode).

    With lr, corr = tails - alr replaces the selected tiles' group
    approximation with their exact sums: acc_s = parts_s + corr[:, :r] @
    u_sem, d_s = parts_d + corr[:, r] (the count column); without it the
    kernel subtracted the approximation and the tail adds in full.  The
    unprojection is a plain f32 matmul, as the JAX package leaves it to
    XLA."""
    gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
    use_lr = _bank_uses(hb)[0]
    sem_vw = hb.g_sem_vw_lr if use_lr else hb.g_sem_vw
    geo = mode == "range+"
    m_s, s_s, m_g, s_g, tails = _hier_scan_call(
        q_cat, hb.g_sem_cat, hb.g_geo_cat, sem_vw, hb.g_geo_vw,
        gpt_s=gpt_s, gpt_g=gpt_g, has_geo=geo)
    idx, _ = select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real,
                          k_tiles=k_tiles, bm=bm, n_valid=n_valid,
                          j_sem=j_sem, j_geo=j_geo, mode=mode)
    parts = _hier_parts_call(
        q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx,
        hb.g_sem_cat, hb.g_geo_cat, sem_vw, hb.g_geo_vw, sem_d=hb.sem_d,
        bm=bm, bn=hb.bn, gpt_s=gpt_s, gpt_g=gpt_g, lr=use_lr, geo=geo)
    Dv, Ws = hb.value_dim, sem_vw.shape[1]
    if use_lr:
        r = hb.lr_rank
        corr = tails[:, :Ws] - parts[:, 2 * Dv + 128:]
        acc_s = parts[:, :Dv] + corr[:, :r] @ hb.u_sem.to(torch.float32)
        d_s = parts[:, 2 * Dv:2 * Dv + 1] + corr[:, r:r + 1]
    else:
        acc_s = parts[:, :Dv] + tails[:, :Dv]
        d_s = parts[:, 2 * Dv:2 * Dv + 1] + tails[:, Dv:Dv + 1]
    if not geo:
        return acc_s, None, d_s, None
    acc_g = parts[:, Dv:2 * Dv] + tails[:, Ws:Ws + Dv]
    d_g = parts[:, 2 * Dv + 1:2 * Dv + 2] + tails[:, Ws + Dv:Ws + Dv + 1]
    return acc_s, acc_g, d_s, d_g


def _hier_partials2(q_cat: torch.Tensor, hb: HierBank, *, k_tiles: int,
                    m_tiles: int, bm: int, j_sem: int, j_geo: int,
                    mode: str, n_valid: int):
    """The two-level feature path (`retrieval_hier.py:3039-3094`) on
    sorted, packed queries, for banks with supergroup operands and no
    lr_rank: the scan over the supergroup centroids and value sums
    (g_sup_cat / g_sup_vw, its geo family in RANGE+), M coarse tiles per
    block, the refine kernel's has_parts form over them (the fine stats
    and sum over the M tiles of fine minus supergroup tail), the second
    selection of K tiles among the M on the fine stats (and the coarse geo
    stats at the M columns), the merged parts kernel's plain variant over
    the K, and the telescope coarse tail + (fine - super) over M + (exact -
    fine) over K.  Returns the unnormalized (acc_s, acc_g, d_s, d_g) f32
    (acc_g and d_g None in RANGE mode, which skips the geo family)."""
    gpt_sup, gpt_f = hb.bn // hb.gsz_super, hb.bn // hb.gsz_sem
    gpt_g = hb.bn // hb.gsz_geo
    m_tiles = min(m_tiles, hb.t_real)
    k_tiles = min(k_tiles, m_tiles)
    geo = mode == "range+"
    m_s, s_s, m_g, s_g, tails = _hier_scan_call(
        q_cat, hb.g_sup_cat, hb.g_geo_cat, hb.g_sup_vw, hb.g_geo_vw,
        gpt_s=gpt_sup, gpt_g=gpt_g, has_geo=geo)
    sel = dict(bm=bm, n_valid=n_valid, j_sem=j_sem, j_geo=j_geo, mode=mode)
    idx_m, _ = select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real,
                            k_tiles=m_tiles, **sel)
    m_f, s_f, rparts = _hier_refine_call(
        q_cat, idx_m, hb.g_sem_cat, hb.g_sup_cat, hb.g_sem_vw, hb.g_sup_vw,
        bm=bm, gpt_f=gpt_f, gpt_sup=gpt_sup)
    at = [None if s is None else _gather_cols(s, idx_m, bm) for s in (m_g, s_g)]
    idx_loc, _ = select_tiles(m_f, s_f, *at, t_real=m_tiles, k_tiles=k_tiles,
                              **sel)
    idx_k = torch.gather(idx_m, 1, idx_loc.long()).to(torch.int32)
    parts = _hier_parts_call(
        q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx_k,
        hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw, hb.g_geo_vw, sem_d=hb.sem_d,
        bm=bm, bn=hb.bn, gpt_s=gpt_f, gpt_g=gpt_g, lr=False, geo=geo)
    Dv, Dvp = hb.value_dim, hb.g_sem_vw.shape[1]
    acc_s = parts[:, :Dv] + rparts[:, :Dv] + tails[:, :Dv]
    d_s = (parts[:, 2 * Dv:2 * Dv + 1] + rparts[:, Dv:Dv + 1]
           + tails[:, Dv:Dv + 1])
    if not geo:
        return acc_s, None, d_s, None
    acc_g = parts[:, Dv:2 * Dv] + tails[:, Dvp:Dvp + Dv]
    d_g = parts[:, 2 * Dv + 1:2 * Dv + 2] + tails[:, Dvp + Dv:Dvp + Dv + 1]
    return acc_s, acc_g, d_s, d_g


def _check_sort(sort: str) -> None:
    if sort not in ("geo", "hybrid"):
        raise ValueError(f"sort must be 'geo' or 'hybrid', got {sort!r}")


def retrieve_hier(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor],
                  hb: HierBank, *, sem_temp: float = 12.0,
                  geo_temp: float = 40.0, beta: float = 0.5,
                  mode: str = "range+", k_tiles: int = 16,
                  m_tiles: Optional[int] = None, k_geo: int = 0,
                  bm: int = 256, j_sem: int = 2, j_geo: int = 2,
                  sort_queries: bool = True, sort: str = "geo",
                  concat_query: Optional[torch.Tensor] = None,
                  adaptive_frac: float = 0.0, adaptive_mult: int = 3,
                  m_corr: int = 0, dedup: int = 0,
                  k_union: Optional[int] = None) -> torch.Tensor:
    """Two-stage retrieval over a HierBank (`retrieval_hier.py:3181-3341`):
    [B, Dv] f32, or [B, Dv + Dq] with ``concat_query`` [B, Dq] appended.
    ``k_tiles``/``j_sem`` and ``k_geo``/``j_geo`` are each family's exact
    budget, ``bm`` the selection block of sorted queries.  ``sort='geo'``
    orders the queries by location before the scan; ``sort='hybrid'`` by
    coarse cell, then home tile from a stats-only pre-scan
    (`_hier_scan_stats_call`; over the supergroup centroids on two-level
    banks); without locations (RANGE mode) by home tile alone;
    ``sort_queries=False`` keeps the caller's order.  The TPU's scan knobs
    (tc, scan_bm) set speed only and have no counterpart.

    Routes as the JAX function does.  Banks with supergroup operands and
    no lr_rank take the two-level feature path (`_hier_partials2`, M =
    ``m_tiles`` or max(32, 3 k_tiles) coarse tiles), in RANGE and RANGE+
    alike, ignoring k_geo and the family-split knobs.  Otherwise banks with
    res_rank get k_geo = max(8, k_tiles // 2) when the caller passes none.
    RANGE+ with k_geo > 0 takes the family-split kernels (`_hier_partials`:
    sel_lr sketches, ``dedup`` tile unions, the ``adaptive_frac`` rescue,
    tail_super corrections): with ``concat_query``, lr + rr and 128-aligned
    Dv / lr_rank / lr_geo / Dq, the fused combine + concat kernel;
    otherwise the combine in torch.  RANGE mode (beta 1, no locations) and
    RANGE+ with k_geo = 0 take the merged branch (`_hier_partials_merged`:
    the merged parts kernel, lr or plain); tail_super and sel_lr banks
    raise there, as in JAX.  The batch pads to a multiple of bm * dedup."""
    if mode not in ("range", "range+"):
        raise ValueError(f"mode must be 'range' or 'range+', got {mode!r}")
    if mode == "range":
        beta, q_xyz = 1.0, None
    if mode == "range+" and q_xyz is None:
        raise ValueError("mode='range+' requires q_xyz")
    _check_sort(sort)
    use_lr, use_rr, use_lrg = _bank_uses(hb)
    use2 = bool(hb.gsz_super) and hb.g_sup_cat is not None and not use_lr
    if use_rr and not k_geo:
        # residual-rank parts live in the family-split kernels only: the
        # geo family gets its own exact budget (`retrieval_hier.py:3262`)
        k_geo = max(8, k_tiles // 2)
    split = bool(k_geo) and mode == "range+"
    if not use2 and not split:
        for knob, op in (("tail_super", hb.g_sem_ts_vw),
                         ("sel_lr", hb.g_sem_sel)):
            if getattr(hb, knob) and op is not None:
                raise ValueError(
                    f"{knob} banks serve via the family-split path only: pass "
                    "k_geo > 0 with mode='range+' (the merged parts kernel "
                    "has no supergroup-tail correction or sketched-group "
                    "slice)")
    B = q_sem.shape[0]
    q_s, q_x = _pad_queries(q_sem, q_xyz, bm * max(dedup, 1))
    q_cat = pack_queries(q_s, q_x, sem_temp, geo_temp, tier=hb.tier)
    Bp = q_cat.shape[0]
    order = None
    if sort_queries:
        home = None
        if sort == "hybrid" or q_x is None:  # the home tiles: a stats scan
            g_s, gsz = ((hb.g_sup_cat, hb.gsz_super) if use2
                        else (hb.g_sem_cat, hb.gsz_sem))
            m_s0 = _hier_scan_stats_call(q_cat, g_s, hb.g_geo_cat,
                                         gpt_s=hb.bn // gsz,
                                         gpt_g=hb.bn // hb.gsz_geo)[0]
            home = _home_tile(m_s0, hb.t_real)
        # sort BEFORE the scan, so its stats come out sorted
        order = _hybrid_order(q_x, B, home, hb.t_pad, sort=sort)
        q_cat = q_cat[order]
    # the fused combine + concat (`retrieval_hier.py:3291-3295`)
    Dv = hb.value_dim
    fused = (concat_query is not None and not use2 and split and use_lr
             and use_rr and Dv % 128 == 0 and hb.lr_rank % 128 == 0
             and (not use_lrg or hb.lr_geo % 128 == 0)
             and concat_query.shape[1] % 128 == 0)
    unsort = (lambda x: x[torch.argsort(order)[:B]]) if order is not None \
        else (lambda x: x[:B])
    kw = dict(k_tiles=k_tiles, bm=bm, j_sem=j_sem, j_geo=j_geo, n_valid=B)
    split_kw = dict(k_geo=k_geo, m_corr=m_corr, adaptive_frac=adaptive_frac,
                    adaptive_mult=adaptive_mult, dedup=dedup, k_union=k_union)
    if fused:
        ps, pg, tails = _hier_partials(q_cat, hb, raw=True, **kw, **split_kw)
        q_srt = torch.nn.functional.pad(concat_query.to(torch.float32),
                                        (0, 0, 0, Bp - B))
        q_srt = q_srt[order] if order is not None else q_srt
        out = _combine_cat_call(
            ps, pg, tails, q_srt, hb.w_sem, hb.u_sem, hb.w_geo,
            hb.u_geo if use_lrg else None, Ws=hb.g_sem_vw_lr.shape[1],
            r=hb.lr_rank, rrp=hb.z_sem.shape[1], Dv=Dv, beta=beta,
            rg=hb.lr_geo if use_lrg else 0,
            Wg=(hb.g_geo_vw_lr if use_lrg else hb.g_geo_vw).shape[1], tier=hb.tier)
        return unsort(out)
    if use2:
        acc_s, acc_g, d_s, d_g = _hier_partials2(
            q_cat, hb, m_tiles=m_tiles or max(32, 3 * k_tiles), mode=mode,
            **kw)
    elif split:
        acc_s, acc_g, d_s, d_g = _hier_partials(q_cat, hb, **kw, **split_kw)
    else:
        acc_s, acc_g, d_s, d_g = _hier_partials_merged(q_cat, hb, mode=mode,
                                                       **kw)
    out = acc_s / torch.clamp_min(d_s, 1e-30)
    if mode == "range+":
        out = beta * out + (1.0 - beta) * (acc_g / torch.clamp_min(d_g, 1e-30))
    out = unsort(out)
    if concat_query is not None:
        out = torch.cat([out, concat_query.to(torch.float32)], 1)
    return out


# ---------------------------------------------------------------------------
# the top-k endpoint and the reachable-argmax harness


def hier_topk(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor],
              hb: HierBank, *, k: int = 1, k_tiles: int = 56,
              m_tiles: Optional[int] = None, bm: int = 256,
              j_sem: int = 6, j_geo: int = 2, mode: str = "range",
              auto_widen: bool = True) -> torch.Tensor:
    """Serving top-k retrieval (`retrieval_hier.py:1850-1963`): [B] int32
    bank rows for k = 1, [B, k] rows by descending serving-tier logit for
    2 <= k <= 8.  Rows outside the selected tiles can never appear.

    The stats-only scan (over the rank-topk_lr sketch `g_topk_lr` of the
    projected queries on topk_lr banks, else the fine `g_topk_cat` operand
    when the bank has one, else `g_sem_cat`), big-K `select_tiles`, then
    the exact hi/lo
    semantic argmax (`_hier_argmax_call`) or k-carry top-k
    (`_hier_topk_call`) over the selected tiles at ~f32 logit accuracy
    (`khl_sem`).  `mode='range'` spends every tile on the semantic family;
    q_xyz, when given, drives the geographic query sort, and without it
    the queries group by home tile.  `auto_widen` applies `_topk_budget`'s
    small-batch budget.  Held to recall@1 >= 0.999 against `exact_nn` at
    B = 10,000, K = 48 on the 100k flagship bank (chip_smoke.py).

    Two-level banks (gsz_super, `retrieval_hier.py:1892-1951`): the stats
    scan runs over the supergroup centroids `g_sup_cat`, `select_tiles`
    keeps M = min(m_tiles or 2 k_tiles, t_real) tiles, the refine kernel
    (`_hier_refine_call`) computes their fine stats over `g_sem_cat`, and
    a second selection over those and the coarse geo stats at the M
    columns keeps K of the M.  The JAX function's tc and interpret (TPU
    knobs) and sort (which no branch of it reads: locations always sort
    geographically, and without them the home tile alone is the key) have
    no counterpart."""
    if not 1 <= k <= 8:
        raise ValueError(f"hier_topk serves 1 <= k <= 8, got k={k}")
    use2 = bool(hb.gsz_super) and hb.g_sup_cat is not None
    B = q_sem.shape[0]
    if auto_widen:
        k_tiles, bm, j_sem = _topk_budget(B, k_tiles, bm, j_sem)
    q_s, q_x = _pad_queries(q_sem, q_xyz, bm)
    q_cat = pack_queries(q_s, None if mode == "range" else q_x, 12.0, 40.0,
                         tier=hb.tier)
    qh, ql = _split_hilo(q_s)
    q2 = torch.cat([qh, qh], 1)  # [Bp, 2 Dk]
    order = None
    if q_x is not None:
        order = _hybrid_order(q_x, B)
        q_cat, q2, ql = q_cat[order], q2[order], ql[order]
    gpt_g = hb.bn // hb.gsz_geo
    if use2:  # coarse stats: the supergroup centroids
        stats = _hier_scan_stats_call(q_cat, hb.g_sup_cat, hb.g_geo_cat,
                                      gpt_s=hb.bn // hb.gsz_super, gpt_g=gpt_g)
    elif hb.g_topk_lr is not None and hb.topk_lr:
        # the low-rank selection signal: the packed queries project once
        # onto the fine centroids' PCA basis (f32, rounded to the packed
        # dtype) and the stats contract topk_lr columns instead of sem_d
        q_sel = (q_cat[:, :hb.sem_d].to(torch.float32) @ hb.p_topk.T).to(
            q_cat.dtype)
        stats = _hier_scan_stats_call(
            torch.cat([q_sel, q_cat[:, hb.sem_d:]], 1), hb.g_topk_lr,
            hb.g_geo_cat, gpt_s=hb.bn // hb.topk_gsz, gpt_g=gpt_g)
    elif hb.g_topk_cat is not None and hb.topk_gsz:
        # fine stats-only centroids: the selection signal of gsz 8 groups
        stats = _hier_scan_stats_call(q_cat, hb.g_topk_cat, hb.g_geo_cat,
                                      gpt_s=hb.bn // hb.topk_gsz, gpt_g=gpt_g)
    else:
        stats = _hier_scan_stats_call(q_cat, hb.g_sem_cat, hb.g_geo_cat,
                                      gpt_s=hb.bn // hb.gsz_sem, gpt_g=gpt_g)
    if q_x is None:
        order = _hybrid_order(None, B, _home_tile(stats[0], hb.t_real))
        q_cat, q2, ql = q_cat[order], q2[order], ql[order]
        stats = [s[order] for s in stats]
    sel = dict(bm=bm, n_valid=B, j_sem=j_sem, j_geo=j_geo, mode=mode)
    if use2:
        # M coarse tiles, their fine stats, then K of the M: the selection
        # signal of the one-level fine scan over M tiles only
        mt = min(m_tiles or 2 * k_tiles, hb.t_real)
        idx_m, _ = select_tiles(*stats, t_real=hb.t_real, k_tiles=mt, **sel)
        m_f, s_f, _ = _hier_refine_call(
            q_cat, idx_m, hb.g_sem_cat, hb.g_sup_cat, None, None, bm=bm,
            gpt_f=hb.bn // hb.gsz_sem, gpt_sup=hb.bn // hb.gsz_super,
            stats_only=True)
        idx_loc, _ = select_tiles(m_f, s_f, _gather_cols(stats[2], idx_m, bm),
                                  _gather_cols(stats[3], idx_m, bm), t_real=mt,
                                  k_tiles=min(k_tiles, mt), **sel)
        idx = torch.gather(idx_m, 1, idx_loc.long())
    else:
        idx, _ = select_tiles(*stats, t_real=hb.t_real, k_tiles=k_tiles, **sel)
    Dk = hb.bank.key_dim
    if k == 1:
        _, rows = _hier_argmax_call(q2, ql, hb.khl_sem, hb.mask_neg, idx,
                                    Dk=Dk, bm=bm, bn=hb.bn)
    else:
        _, rows = _hier_topk_call(q2, ql, hb.khl_sem, hb.mask_neg, idx,
                                  Dk=Dk, k=k, bm=bm, bn=hb.bn)
    return rows[torch.argsort(order)[:B]]


def hier_nn(q_sem: torch.Tensor, q_xyz: Optional[torch.Tensor],
            hb: HierBank, *, sem_temp: float = 12.0, geo_temp: float = 40.0,
            k_tiles: int = 16, bm: int = 256, j_sem: int = 2, j_geo: int = 2,
            sort: str = "geo", mode: str = "range+") -> torch.Tensor:
    """Fidelity harness (`retrieval_hier.py:3344-3394`): [B] int32, the
    semantic argmax row the feature path can see, i.e. the serving-tier
    packed logits restricted to the selected tiles; recall@1 of this
    against `exact_nn` measures the feature path's retrieval fidelity.
    Materializes [1024, N] masked logits per chunk of queries; not a
    serving path.

    The JAX harness takes its stats from the fused scan over the
    full-width `g_sem_vw`; it reads only the four stats.  The port computes
    them with the stats-only scan over the same `g_sem_cat` / `g_geo_cat`,
    which streams no tail: by construction the fused scan's stats (held
    equal in the tests)."""
    B = q_sem.shape[0]
    _check_sort(sort)
    if mode == "range":
        q_xyz = None
    q_s, q_x = _pad_queries(q_sem, q_xyz, bm)
    q_cat = pack_queries(q_s, q_x, sem_temp, geo_temp, tier=hb.tier)
    stats = _hier_scan_stats_call(q_cat, hb.g_sem_cat, hb.g_geo_cat,
                                  gpt_s=hb.bn // hb.gsz_sem,
                                  gpt_g=hb.bn // hb.gsz_geo)
    home = (_home_tile(stats[0], hb.t_real)
            if sort == "hybrid" or q_x is None else None)
    order = _hybrid_order(q_x, B, home, hb.t_pad, sort=sort)
    q_cat = q_cat[order]
    stats = [s[order] for s in stats]
    _, sel = select_tiles(*stats, t_real=hb.t_real, k_tiles=k_tiles, bm=bm,
                          n_valid=B, j_sem=j_sem, j_geo=j_geo,
                          mode="range+" if q_x is not None else "range")
    # chunked masked argmax: the [B, N] logits would not fit at serving B
    keys = hb.k_cat[:, :hb.sem_d].to(torch.float32)
    row_ok = hb.mask_neg[0] >= 0
    keep_t = sel[:, :hb.t_real].repeat_interleave(hb.bn, dim=1) > 0  # [nB, N]
    best = []
    for lo in range(0, B, 1024):
        hi = min(lo + 1024, B)
        logits = q_cat[lo:hi, :hb.sem_d].to(torch.float32) @ keys.T
        keep = keep_t[torch.arange(lo, hi, device=keep_t.device) // bm] & row_ok
        best.append(first_argmax(torch.where(keep, logits, float("-inf"))))
    best = torch.cat(best).to(torch.int32)
    return best[torch.argsort(order)[:B]]
