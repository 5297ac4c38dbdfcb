"""RANGE / RANGE+ retrieval-augmented location encoders (dense path).

Counterpart of `range_tpu/models/range_encoder.py:44-274` (reference
`range/range.py:76-114` init, `:208-242` forward):

  1. query = SatCLIP location tower (SH L=40 -> SIREN), L2-normalized
  2. semantic path: softmax(temp * q @ bank_satclipT) @ bank_image
  3. (RANGE+) angular path: softmax(geo_temp * xyz @ bank_xyzT) @ bank_image,
     blended ``beta * semantic + (1-beta) * angular``
  4. output = concat([retrieved_Dv, query_256])

With a `HierBank` and ``retrieval='hier'`` the retrieval is the
hierarchical path (`ops/retrieval_hier.retrieve_hier`, routed as the JAX
package routes: the family-split or the merged parts kernels), with the
JAX package's batch-size heuristics (`range_encoder.py:147-223`).  Banks
with int8 values take the int8 kernels on either path.  With a ``mesh``
(`parallel/mesh.make_mesh`) the dense path runs bank-sharded over its
bank axis (`parallel/sharded.py`, `range_encoder.py:225-245`); the
hierarchical path on a mesh is not ported yet (ROADMAP.md, Queue 1
"Multi-GPU").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from ..bank.bank import GeoBank
from ..geometry import lonlat_deg_to_xyz
from ..ops import retrieval
from ..ops.retrieval_fused import retrieve_pallas
from ..ops.retrieval_hier import HierBank, retrieve_hier
from .satclip import SatClipLocationEncoder

RANGE_TEMP = 15.0
RANGE_PLUS_SEM_TEMP = 12.0
RANGE_PLUS_GEO_TEMP = 40.0


@dataclasses.dataclass(frozen=True)
class RangeConfig:
    mode: str = "range+"  # 'range' | 'range+'
    beta: float = 0.5
    sem_temp: Optional[float] = None  # None => reference defaults per mode
    geo_temp: float = RANGE_PLUS_GEO_TEMP
    chunk: int = 4096
    compute_dtype: Any = torch.float32
    # None => the fused kernel iff the coordinates lie on a CUDA device
    use_pallas: Optional[bool] = None
    # fused-kernel logit precision: 'fast' (default), 'high', 'exact'
    tier: str = "fast"
    # 'dense' (exact, every bank row) or 'hier' (two-stage approximate
    # over a HierBank, `ops/retrieval_hier.py`)
    retrieval: str = "dense"
    k_tiles: int = 16      # hier: exact sem tiles per query block
    k_geo: int = 0         # hier: exact geo tiles per query block
    j_sem: int = 2         # hier: per-query top sem tiles kept
    j_geo: int = 2         # hier: per-query top geo tiles kept
    hier_bm: int = 256     # hier: largest query block of the selection
    # hier, tail_super banks: sem tiles past k_tiles that get the fine-tail
    # correction (passed as given at every batch size, as the JAX package)
    m_corr: int = 0
    # hier, two-level banks (gsz_super without lr_rank): coarse tiles the
    # refine stage keeps (None: max(32, 3 k_tiles))
    m_tiles: Optional[int] = None
    # hier: the share of queries whose selected tiles cover the least
    # exp-mass that re-run the parts kernels at adaptive_mult x the budget
    adaptive_frac: float = 0.0
    adaptive_mult: int = 3
    # hier: merge the tile lists of this many adjacent query blocks into
    # one parts dispatch of k_union tiles (None: the JAX default), at
    # batches of 8,192 and more
    dedup: int = 0
    k_union: Optional[int] = None
    # hier: batches below this take the dense exact kernel over hb.bank
    hier_min_batch: int = 0
    # multi-device serving: a DeviceMesh (`parallel/mesh.make_mesh`) whose
    # `bank_axis` shards the bank rows (the API keeps this rank's slab,
    # `parallel/sharded.shard_bank`); `data_axis` optionally splits the
    # batch.  shard_bn: the bank tile every shard's rows must hold whole
    # (the JAX divisibility rule); shard_bm: the TPU kernel's query tile,
    # kept for the JAX signature (the CUDA parts kernel tiles itself)
    mesh: Any = None
    bank_axis: str = "bank"
    data_axis: Optional[str] = None
    shard_bm: int = 512
    shard_bn: int = 1024

    def __post_init__(self):
        if self.retrieval not in ("dense", "hier"):
            raise ValueError(
                f"retrieval must be 'dense' or 'hier', got {self.retrieval!r}")
        if self.mesh is not None and self.retrieval == "hier":
            raise NotImplementedError(
                "the hierarchical path on a mesh is not ported yet (ROADMAP.md: "
                "Queue 1, 'Multi-GPU')")

    def hier_plan(self, batch: int):
        """(bm, k_tiles, k_geo, j_sem) for a batch of ``batch`` queries
        (`range_tpu/models/range_encoder.py:157-175`): bm shrinks with the
        batch (>= 128) so query blocks stay spatially tight, and batches
        under 2,048 (8,192) widen the budgets 3x (1.5x)."""
        bm = min(self.hier_bm, max(128, batch // 40 // 128 * 128))
        k_tiles, k_geo, j_sem = self.k_tiles, self.k_geo, self.j_sem
        if batch < 2048:
            k_tiles, k_geo, j_sem = 3 * k_tiles, 3 * k_geo, j_sem + 2
        elif batch < 8192:
            k_tiles = k_tiles + k_tiles // 2
            k_geo = k_geo + k_geo // 2
            j_sem = j_sem + 1
        return bm, k_tiles, k_geo, j_sem

    def resolved_sem_temp(self) -> float:
        if self.sem_temp is not None:
            return self.sem_temp
        return RANGE_PLUS_SEM_TEMP if self.mode == "range+" else RANGE_TEMP


class RangeEncoder(nn.Module):
    """Query tower + bank retrieval.  The bank (a GeoBank, or a HierBank
    for ``retrieval='hier'``) is not a module buffer: move it with its
    ``to`` (the API places it at load)."""

    def __init__(self, query_encoder: SatClipLocationEncoder, bank,
                 config: RangeConfig):
        super().__init__()
        if not isinstance(bank, (GeoBank, HierBank)):
            raise TypeError(f"bank must be a GeoBank or a HierBank, got "
                            f"{type(bank).__name__}")
        self.query_encoder = query_encoder
        self.bank = bank
        self.config = config
        self.embedding_dim = bank.value_dim + query_encoder.embedding_dim

    def query_embedding(self, lonlat_deg: torch.Tensor) -> torch.Tensor:
        q = self.query_encoder(lonlat_deg)
        return q / torch.linalg.norm(q, dim=-1, keepdim=True)

    def forward(self, lonlat_deg: torch.Tensor, bank=None) -> torch.Tensor:
        cfg = self.config
        bank = self.bank if bank is None else bank
        q_sem = self.query_embedding(lonlat_deg).to(torch.float32)
        q_xyz = None
        if cfg.mode == "range+":
            q_xyz = lonlat_deg_to_xyz(lonlat_deg.to(torch.float32))
        B = lonlat_deg.shape[0]
        if isinstance(bank, HierBank) and (cfg.retrieval != "hier"
                                           or B < cfg.hier_min_batch):
            bank = bank.bank  # the dense exact path over the same rows
        if isinstance(bank, HierBank):
            bm, k_tiles, k_geo, j_sem = cfg.hier_plan(B)
            # concat_query: the [retrieved | query] concat, inside the
            # combine kernel's epilogue where the fused combine runs
            return retrieve_hier(
                q_sem, q_xyz, bank, sem_temp=cfg.resolved_sem_temp(),
                geo_temp=cfg.geo_temp, beta=cfg.beta, mode=cfg.mode,
                k_tiles=k_tiles, m_tiles=cfg.m_tiles, k_geo=k_geo, bm=bm,
                j_sem=j_sem, j_geo=cfg.j_geo, concat_query=q_sem,
                adaptive_frac=cfg.adaptive_frac,
                adaptive_mult=cfg.adaptive_mult, m_corr=cfg.m_corr,
                # small widened batches dispatch few blocks already; dedup
                # would merge across unrelated regions there
                dedup=cfg.dedup if B >= 8192 else 0, k_union=cfg.k_union)
        use_pallas = cfg.use_pallas
        if use_pallas is None:
            use_pallas = lonlat_deg.device.type == "cuda"
        if cfg.mesh is not None:
            from ..parallel.sharded import (sharded_retrieve,
                                            sharded_retrieve_pallas)

            # JAX's route with "tpu" read as "cuda": the card always takes
            # the parts kernel
            if use_pallas or lonlat_deg.device.type == "cuda":
                retrieved = sharded_retrieve_pallas(
                    q_sem, q_xyz, bank, cfg.mesh,
                    sem_temp=cfg.resolved_sem_temp(), geo_temp=cfg.geo_temp,
                    beta=cfg.beta, mode=cfg.mode, tier=cfg.tier,
                    bank_axis=cfg.bank_axis, data_axis=cfg.data_axis)
            else:
                retrieved = sharded_retrieve(
                    q_sem, q_xyz, bank, cfg.mesh,
                    sem_temp=cfg.resolved_sem_temp(), geo_temp=cfg.geo_temp,
                    beta=cfg.beta, mode=cfg.mode, chunk=cfg.chunk,
                    bank_axis=cfg.bank_axis, data_axis=cfg.data_axis,
                    compute_dtype=cfg.compute_dtype)
            return torch.cat([retrieved, q_sem], dim=-1)
        if use_pallas:
            retrieved = retrieve_pallas(
                q_sem, q_xyz, bank, sem_temp=cfg.resolved_sem_temp(),
                geo_temp=cfg.geo_temp, beta=cfg.beta, mode=cfg.mode,
                tier=cfg.tier)
        else:
            retrieved = retrieval.retrieve(
                q_sem, q_xyz, bank, sem_temp=cfg.resolved_sem_temp(),
                geo_temp=cfg.geo_temp, beta=cfg.beta, mode=cfg.mode,
                chunk=cfg.chunk, compute_dtype=cfg.compute_dtype)
        return torch.cat([retrieved, q_sem], dim=-1)
