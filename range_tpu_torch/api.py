"""Public API: `load_model` factory + encoder registry.

Counterpart of `range_tpu/api.py:31-79,121-266,433-491` (reference
`range/load_model.py:16-51`) for the models this port serves: RANGE and
RANGE+ (dense retrieval, the "exact" serving profile; hierarchical,
``retrieval="hier"`` at every single-device knob of the JAX package:
lr_rank / res_rank / lr_geo, topk_gsz / topk_lr, sel_lr, tail_super,
gsz_super (the two-level feature path without lr_rank), dedup and the
adaptive rescue, the "flagship" and "turbo" profiles among them;
``value_quant="int8"`` stores the bank's values as per-row int8 codes for
either; ``mesh=`` serves the dense path bank-sharded over a
`parallel.mesh.make_mesh` mesh) and the SatCLIP tower.
Each registered constructor returns a `GeoEncoder`: an `nn.Module` plus
its static ``embedding_dim`` and device.  Coordinates go in as [B, 2] (lon, lat)
degrees and a [B, D] tensor on the model's device comes out.

``device`` defaults to "cuda"; CPU use is explicit (``device="cpu"``).
Weights are seeded random (a `torch.Generator` seeded with ``seed``; the
numbers differ from the JAX package's), or carried across from the JAX
package by `convert/from_jax.py`.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional, Union

import torch
from torch import nn

from .bank.bank import GeoBank, quantize_values
from .models.range_encoder import RangeConfig, RangeEncoder
from .ops.retrieval_hier import HierBank, prepare_hier_bank
from .models.satclip import SatClipLocationConfig, SatClipLocationEncoder
from .parallel.mesh import axis_size
from .parallel.sharded import shard_bank


class GeoEncoder:
    """name + model + static embedding_dim + device + weight dtype.

    Coordinates are cast to the weight dtype on the way in (float32 by
    default), as the JAX package's serving entry ends up with f32 under its
    default (x64 off): numpy's float64 coordinates reach the tower kernel.
    """

    def __init__(self, name: str, model: nn.Module, embedding_dim: int,
                 device: torch.device, dtype: torch.dtype = torch.float32):
        self.name = name
        self.model = model
        self.embedding_dim = embedding_dim
        self.device = device
        self.dtype = dtype

    def __call__(self, coords) -> torch.Tensor:
        coords = torch.as_tensor(coords, dtype=self.dtype, device=self.device)
        if coords.ndim != 2 or coords.shape[-1] != 2:
            raise ValueError(
                f"expected [B, 2] (lon, lat) degrees, got {tuple(coords.shape)}")
        with torch.inference_mode():
            return self.model(coords)

    # reference parity alias (`LocationEncoder.location_feature_dim`)
    @property
    def location_feature_dim(self) -> int:
        return self.embedding_dim


_REGISTRY: Dict[str, Callable[..., GeoEncoder]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def list_models():
    return sorted(_REGISTRY)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md: {item})")


def _as_bank(db: Union[str, GeoBank, HierBank, None], chunk: int,
             device: torch.device):
    if db is None:
        raise ValueError("db_path is required for RANGE models (a path to a "
                         "range_db npz, a GeoBank, a HierBank, 'synthetic:N' "
                         "or 'informative:N')")
    if isinstance(db, (GeoBank, HierBank)):
        return db.to(device)
    if isinstance(db, str) and db.startswith("synthetic:"):
        return GeoBank.synthetic_device(0, int(db.split(":")[1]), pad_to=chunk,
                                        device=device)
    if isinstance(db, str) and db.startswith("informative:"):
        # spatially autocorrelated synthetic bank whose keys are the seed-0
        # tower's embeddings of the bank locations
        return GeoBank.synthetic_informative(0, int(db.split(":")[1]),
                                             pad_to=chunk, device=device)
    return GeoBank.from_npz(db, pad_to=chunk, device=device)


def _hier_bank(bank, cache: Optional[str], build: Dict[str, Any]) -> HierBank:
    """The serving HierBank: ``bank`` itself when it is one (its build
    knobs must be the requested ones), else `prepare_hier_bank` with the
    signature-checked disk cache ``cache``."""
    if not isinstance(bank, HierBank):
        return prepare_hier_bank(bank, cache_path=cache, **build)
    Dv = bank.value_dim
    want = {k: build[k] for k in ("bn", "gsz_sem", "gsz_geo", "gsz_super",
                                  "topk_gsz", "tail_super", "tier")}
    for k in ("lr_rank", "lr_geo", "res_rank"):
        want[k] = min(build[k], Dv) if build[k] else 0
    want["topk_lr"] = min(build["topk_lr"], bank.bank.key_dim)
    want["sel_lr"] = min(build["sel_lr"], bank.sem_d)
    got = {k: getattr(bank, k) for k in want}
    if got != want:
        raise ValueError(f"the HierBank was built with {got}, the request "
                         f"asks for {want}")
    return bank


def _satclip_tower(pretrained_path: Optional[str], dtype, seed: int,
                   tower_matmul: Optional[str], device: torch.device):
    if tower_matmul not in (None, "bf16"):
        raise ValueError(
            f"tower_matmul must be None or 'bf16', got {tower_matmul!r}")
    if pretrained_path:
        raise _not_ported("checkpoint loading (pretrained_path)",
                          "Queue 1, 'Checkpoint loading'")
    generator = torch.Generator(device=device).manual_seed(seed)
    return SatClipLocationEncoder(
        SatClipLocationConfig(fused_matmul_dtype=tower_matmul), device=device,
        dtype=dtype, generator=generator)


def _build_range(name: str, mode: str, pretrained_path, db_path, beta, *,
                 device: torch.device, dtype=torch.float32, seed: int = 0,
                 chunk: int = 4096, compute_dtype=torch.float32,
                 tier: str = "fast", use_pallas: Optional[bool] = None,
                 value_quant: Optional[str] = None, retrieval: str = "dense",
                 k_tiles: int = 16, m_tiles: Optional[int] = None,
                 k_geo: int = 0, hier_min_batch: int = 0,
                 j_sem: int = 2, j_geo: int = 2, hier_bm: int = 256,
                 adaptive_frac: float = 0.0, adaptive_mult: int = 3,
                 hier_bn: int = 512, gsz_sem: int = 8, gsz_geo: int = 64,
                 gsz_super: int = 0, group_by: str = "key_value",
                 group_value_weight: float = 1.0,
                 lr_rank: Optional[int] = None, lr_geo: Optional[int] = None,
                 res_rank: Optional[int] = None, topk_gsz: int = 0,
                 topk_lr: int = 0, tail_super: int = 0, sel_lr: int = 0,
                 m_corr: int = 0, dedup: int = 0,
                 k_union: Optional[int] = None,
                 hier_cache: Optional[str] = None,
                 tower_matmul: Optional[str] = None, mesh=None,
                 bank_axis: Optional[str] = None,
                 data_axis: Optional[str] = None, shard_bm: int = 512,
                 shard_bn: int = 1024, **kw) -> GeoEncoder:
    if kw:
        raise TypeError(
            f"load_model({name!r}): unknown keyword argument(s) "
            f"{sorted(kw)}; valid knobs: {_RANGE_KWARGS} (the TPU kernels' "
            "speed knobs, hier_scan_bm among them, have no counterpart)")
    if mesh is not None:
        from torch.distributed.device_mesh import DeviceMesh

        if retrieval == "hier":  # never served on one device instead
            raise _not_ported("the hierarchical path on a mesh (mesh= with "
                              "retrieval='hier')", "Queue 1, 'Multi-GPU'")
        if not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh must be a torch DeviceMesh "
                            f"(parallel.mesh.make_mesh), got {type(mesh).__name__}")
    if value_quant not in (None, "int8"):
        raise ValueError(f"value_quant must be None or 'int8', got {value_quant!r}")
    if retrieval not in ("dense", "hier"):
        raise ValueError(f"retrieval must be 'dense' or 'hier', got {retrieval!r}")
    if retrieval == "hier":
        # every knob that raises is checked before the (slow) bank build
        for knob, val in (("tail_super", tail_super), ("sel_lr", sel_lr)):
            if val and mode == "range":
                raise ValueError(f"{knob} banks serve RANGE+ only (the family-"
                                 "split path; the merged parts kernel has no "
                                 "supergroup-tail correction or sketched-"
                                 "group slice)")
        if gsz_super and topk_gsz:
            raise ValueError("gsz_super and topk_gsz are mutually exclusive: "
                             "both feed hier_topk's selection")
        if topk_lr and not topk_gsz:
            raise ValueError("topk_lr factors the topk_gsz stats operand: "
                             "build with topk_gsz set")
    tower = _satclip_tower(pretrained_path, dtype, seed, tower_matmul, device)
    bank = _as_bank(db_path, chunk, device)
    if value_quant == "int8":
        # per-row int8 codes + scales, before any hier build (as JAX): half
        # the value bank's bytes on the card
        if isinstance(bank, HierBank) and bank.value_scale is None:
            raise ValueError("value_quant='int8' with a HierBank of bf16 "
                             "values: build it from a quantized bank "
                             "(bank.quantize_values)")
        if not isinstance(bank, HierBank):
            bank = quantize_values(bank)
    if retrieval == "hier":
        bank = _hier_bank(bank, hier_cache, dict(
            bn=hier_bn, gsz_sem=gsz_sem, gsz_geo=gsz_geo, gsz_super=gsz_super,
            group_by=group_by, group_value_weight=group_value_weight,
            lr_rank=lr_rank, lr_geo=lr_geo, res_rank=res_rank,
            topk_gsz=topk_gsz, topk_lr=topk_lr, tail_super=tail_super,
            sel_lr=sel_lr, tier=tier, seed=seed))
    elif isinstance(bank, HierBank):
        bank = bank.bank
    if mesh is not None:
        # rows spread over the mesh's bank axis; this rank keeps its slab
        # (`range_tpu/api.py:197-208`)
        bank_axis = bank_axis or mesh.mesh_dim_names[-1]
        n_shards = axis_size(mesh, bank_axis)
        if n_shards > 1 and bank.num_rows % (n_shards * shard_bn):
            raise ValueError(
                f"bank rows {bank.num_rows} must divide evenly into "
                f"{n_shards} shards of {shard_bn}-row tiles; re-pad with "
                f"chunk/pad_to accordingly")
        bank = shard_bank(bank, mesh, axis=bank_axis)
    cfg = RangeConfig(mode=mode, beta=beta, chunk=chunk,
                      compute_dtype=compute_dtype, tier=tier,
                      use_pallas=use_pallas, retrieval=retrieval,
                      k_tiles=k_tiles, k_geo=k_geo, j_sem=j_sem, j_geo=j_geo,
                      hier_bm=hier_bm, hier_min_batch=hier_min_batch,
                      m_corr=m_corr, m_tiles=m_tiles,
                      adaptive_frac=adaptive_frac,
                      adaptive_mult=adaptive_mult, dedup=dedup,
                      k_union=k_union, mesh=mesh, bank_axis=bank_axis or "bank",
                      data_axis=data_axis, shard_bm=shard_bm,
                      shard_bn=shard_bn)
    enc = RangeEncoder(tower, bank, cfg)
    return GeoEncoder(name, enc, enc.embedding_dim, device, dtype)


# the validated knob set for RANGE/RANGE+: _build_range's named kwargs plus
# the entries handled around it
_RANGE_KWARGS = sorted(
    [p.name for p in inspect.signature(_build_range).parameters.values()
     if p.kind == p.KEYWORD_ONLY and p.name != "device"]
    + ["db_path", "beta"])


@register("RANGE")
def _range(pretrained_path=None, db_path=None, beta=0.5, **kw):
    return _build_range("RANGE", "range", pretrained_path, db_path, beta, **kw)


@register("RANGE+")
def _range_plus(pretrained_path=None, db_path=None, beta=0.5, **kw):
    return _build_range("RANGE+", "range+", pretrained_path, db_path, beta, **kw)


@register("SatCLIP")
def _satclip(pretrained_path=None, *, device: torch.device,
             dtype=torch.float32, seed: int = 0, tower_matmul=None, **kw):
    if kw:
        raise TypeError(
            f"load_model('SatCLIP'): unknown keyword argument(s) {sorted(kw)}; "
            "this model accepts: ['dtype', 'pretrained_path', 'seed', "
            "'tower_matmul']")
    tower = _satclip_tower(pretrained_path, dtype, seed, tower_matmul, device)
    return GeoEncoder("SatCLIP", tower, tower.embedding_dim, device, dtype)


# Named serving profiles, as `range_tpu/api.py:433-456` defines them.
# Explicit kwargs override a profile's entries.
SERVING_PROFILES: Dict[str, Dict[str, Any]] = {
    # exact dense retrieval: the reference semantics
    "exact": {"retrieval": "dense"},
    # the flagship hierarchical path: joint key+value groups, low-rank sem
    # and geo tails, residual-rank parts, gsz_sem 16 scan, topk_gsz 8
    # stats operand, budgets K32/j3/k_geo 16, bf16 tower operands (the JAX
    # profile's hier_scan_bm sets the TPU scan's block, a speed knob the
    # CUDA scan has no use for)
    "flagship": {
        "retrieval": "hier", "lr_rank": 256, "lr_geo": 384, "res_rank": 128,
        "gsz_sem": 16, "topk_gsz": 8, "k_tiles": 32, "j_sem": 3,
        "k_geo": 16, "tower_matmul": "bf16",
    },
    # the same kernels at smaller exact budgets
    "turbo": {
        "retrieval": "hier", "lr_rank": 256, "lr_geo": 384, "res_rank": 128,
        "gsz_sem": 16, "topk_gsz": 8, "k_tiles": 8, "j_sem": 2,
        "k_geo": 4, "tower_matmul": "bf16",
    },
}


def load_model(model_name: str = "RANGE+",
               pretrained_path: Optional[str] = None, device="cuda",
               profile: Optional[str] = None, **kwargs) -> GeoEncoder:
    """Load a location encoder by reference name.

    kwargs: ``db_path`` (required for RANGE/RANGE+; npz path, GeoBank,
    HierBank, 'synthetic:N' or 'informative:N'), ``beta`` (default 0.5),
    plus dtype, seed, chunk, compute_dtype, tier, use_pallas, tower_matmul
    and the hierarchical knobs (``retrieval='hier'``, ``hier_cache=`` a
    path for the signature-checked HierBank archive).  ``profile`` selects
    a named serving bundle (SERVING_PROFILES); explicit kwargs override it.
    ``device`` is where the weights, the bank and the computation live.
    """
    if model_name not in _REGISTRY:
        raise NotImplementedError(
            f"{model_name} not implemented; available: {list_models()}")
    if profile is not None:
        try:
            base = SERVING_PROFILES[profile]
        except KeyError:
            raise ValueError(
                f"unknown profile {profile!r}; available: "
                f"{sorted(SERVING_PROFILES)}") from None
        kwargs = {**base, **kwargs}
    if "RANGE" in model_name and "db_path" not in kwargs:
        raise AssertionError("db_path is required for RANGE model.")
    return _REGISTRY[model_name](pretrained_path=pretrained_path,
                                 device=torch.device(device), **kwargs)
