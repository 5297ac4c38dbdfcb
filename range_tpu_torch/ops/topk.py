"""Top-k retrieval and the recall harness.

Counterpart of `range_tpu/ops/topk.py`: recall@k of a (possibly
approximate or reduced-precision) retrieval against exact nearest neighbours
over the bank's semantic keys.  `ops.retrieval.exact_nn` is the f32-exact
ground truth; `topk_sem` and `topk_packed` rank candidates.

Ties follow `lax.top_k`: the lower index first.  The port takes the first k
of a stable descending sort, never bare `torch.topk`, whose tie order is
not fixed on CUDA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..bank.bank import GeoBank
from .retrieval import _NEG, _pick_chunk
from .retrieval_fused import pack_bank, pack_queries, packed_dims


def topk_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) [B, k] of each row's k largest, the lower index
    first among equal values (`lax.top_k`'s order)."""
    values, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def _streaming_topk(q: torch.Tensor, keys: torch.Tensor, mask_neg, k: int,
                    chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Running top-k merge over bank chunks: each chunk's top k, then the
    top k of [running | chunk], so the running entries win ties."""
    B = q.shape[0]
    best_v = torch.full((B, k), _NEG, dtype=torch.float32, device=q.device)
    best_i = torch.zeros((B, k), dtype=torch.int32, device=q.device)
    for lo in range(0, keys.shape[0], chunk):
        sims = q @ keys[lo:lo + chunk].to(torch.float32).T \
            + mask_neg[None, lo:lo + chunk]
        v, i = topk_stable(sims, k)
        merged_v = torch.cat([best_v, v], 1)
        merged_i = torch.cat([best_i, (i + lo).to(torch.int32)], 1)
        best_v, sel = topk_stable(merged_v, k)
        best_i = torch.gather(merged_i, 1, sel)
    return best_v, best_i


def topk_sem(q_sem: torch.Tensor, bank: GeoBank, k: int = 10,
             chunk: int = 8192) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k bank rows by semantic cosine similarity (`topk.py:21-55`),
    streaming over chunks: (values [B, k], indices [B, k] int32).  The
    products are f32 (on CUDA, TF32 only if the caller enabled it)."""
    chunk = _pick_chunk(bank.num_rows, chunk)
    mask_neg = _NEG * (1.0 - bank.row_mask().to(torch.float32))
    return _streaming_topk(q_sem.to(torch.float32), bank.keys_sem, mask_neg,
                           k, chunk)


def topk_packed(q_sem: torch.Tensor, bank: GeoBank, k: int = 10,
                chunk: int = 8192, tier: str = "fast"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k bank rows by the SERVING-TIER semantic logits (`topk.py:58-107`):
    the packed operands the kernels read (`pack_queries` / `pack_bank`),
    bf16 products summed in f32, so recall@k of this ranking against
    `exact_nn` measures the tier actually served.  The temperature and
    log2(e) folded into the packed queries are positive and keep the order.
    The dense fallback of the top-k endpoint.  Returns (packed-logit values
    [B, k], indices [B, k] int32)."""
    q_cat = pack_queries(q_sem, None, 12.0, 40.0, tier=tier)
    k_cat = pack_bank(bank.keys_sem, bank.xyz, tier=tier)
    sem_d, _ = packed_dims(bank.key_dim, tier)
    chunk = _pick_chunk(bank.num_rows, chunk)
    mask_neg = _NEG * (1.0 - bank.row_mask().to(torch.float32))
    return _streaming_topk(q_cat[:, :sem_d].to(torch.float32),
                           k_cat[:, :sem_d], mask_neg, k, chunk)


def recall_at_k(candidate_idx: torch.Tensor, true_idx: torch.Tensor) -> float:
    """Fraction of queries whose true NN appears in their candidate list.
    candidate_idx [B, k], true_idx [B]."""
    hit = (candidate_idx == true_idx[:, None]).any(dim=1)
    return float(hit.to(torch.float32).mean())
