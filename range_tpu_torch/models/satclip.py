"""SatCLIP location tower: SH positional encoding -> SIREN, as an nn.Module.

Counterpart of `range_tpu/models/satclip.py:29-156` (reference
`location_encoder.py:267-275`).  In eval, float32 coordinates go through the
fused tower (`ops.sh.siren_tower`: the CUDA kernel on the card, its plain
version on the CPU), as `satclip.py:83-99` routes them through the Pallas
kernel.  In training, float32 coordinates take the fused first layer
(`ops.sh.spherical_harmonics_times_fused`, the SH-times kernel on the card)
plus b0, then the SIREN layers with dropout (`satclip.py:100-156`).
Float64 coordinates on the CPU take the unfused basis -> net compose, as in
the JAX package.  On the card the kernels are f32-only, so other dtypes
raise there instead of leaving the kernels for the compose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from ..ops.nets import SirenNet, get_neural_network
from ..ops.posenc import get_positional_encoding
from ..ops.sh import siren_tower, spherical_harmonics_times_fused


@dataclasses.dataclass(frozen=True)
class SatClipLocationConfig:
    """Location-tower hyperparameters, named as in the Lightning checkpoint
    ``hyper_parameters`` dict (`satclip/load.py:4-10`)."""

    embed_dim: int = 256
    le_type: str = "sphericalharmonics"
    pe_type: str = "siren"
    frequency_num: int = 16
    max_radius: float = 260
    min_radius: float = 1
    legendre_polys: int = 40
    harmonics_calculation: str = "analytic"
    num_hidden_layers: int = 2
    capacity: int = 256
    # serving knob: "bf16" rounds the tower's matmul operands to bf16
    # (accumulation stays f32); None keeps full f32
    fused_matmul_dtype: Optional[str] = None


class SatClipLocationEncoder(nn.Module):
    """posenc -> nnet compose with a static ``embedding_dim``."""

    def __init__(self, config: SatClipLocationConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.posenc = get_positional_encoding(
            name=config.le_type,
            harmonics_calculation=config.harmonics_calculation,
            legendre_polys=config.legendre_polys,
            min_radius=config.min_radius, max_radius=config.max_radius,
            frequency_num=config.frequency_num)
        self.nnet = get_neural_network(
            config.pe_type, input_dim=self.posenc.embedding_dim,
            num_classes=config.embed_dim, dim_hidden=config.capacity,
            num_layers=config.num_hidden_layers, device=device, dtype=dtype,
            generator=generator)
        self.embedding_dim = config.embed_dim

    def _matmul_dtype(self):
        return torch.bfloat16 if self.config.fused_matmul_dtype == "bf16" else None

    def forward(self, lonlat_deg: torch.Tensor, training: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if lonlat_deg.is_cuda and lonlat_deg.dtype != torch.float32:
            raise TypeError(
                f"the tower kernels take float32 coordinates, got "
                f"{lonlat_deg.dtype} on {lonlat_deg.device}; the unfused "
                "compose serves other dtypes on the CPU only")
        if lonlat_deg.dtype != torch.float32:
            return self.nnet(self.posenc(lonlat_deg), training=training,
                             generator=generator)
        if not training:
            return siren_tower(
                lonlat_deg, int(self.posenc.legendre_polys),
                self.nnet.tower_params(), self.posenc.convention,
                matmul_dtype=self._matmul_dtype(),
                w0_initial=self.nnet.w0_initial, w0=self.nnet.w0)
        return self.nnet(None, training=True, generator=generator,
                         first_preact=self._fused_first_preact(lonlat_deg))

    def _fused_first_preact(self, lonlat_deg: torch.Tensor) -> torch.Tensor:
        """basis @ W0 + b0 through the SH-times kernel, without the
        [B, L*L] basis (`range_tpu/models/satclip.py:116-156`)."""
        if not isinstance(self.nnet, SirenNet):
            raise NotImplementedError(
                f"the fused first layer of a {type(self.nnet).__name__} head "
                "is not ported yet (ROADMAP.md, Queue 1: rest of the encoder "
                "zoo, the MLP head)")
        layer0 = self.nnet.layers[0]
        pre = spherical_harmonics_times_fused(
            lonlat_deg, int(self.posenc.legendre_polys), layer0.weight.T,
            self.posenc.convention, matmul_dtype=self._matmul_dtype())
        return pre if layer0.bias is None else pre + layer0.bias
