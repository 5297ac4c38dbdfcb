"""Spherical geometry primitives on torch tensors.

Counterpart of `range_tpu/geometry.py:23-48` (the reference helpers in
`range/utils/utils.py:11-16`).  Conventions match the JAX package:
coordinates are `(lon, lat)` pairs in degrees, shape `[..., 2]`, and the
unit sphere uses `x = cos(lat)cos(lon), y = cos(lat)sin(lon), z = sin(lat)`.
"""

from __future__ import annotations

import math

import torch


def deg2rad(x: torch.Tensor) -> torch.Tensor:
    return x * (math.pi / 180.0)


def lonlat_rad_to_xyz(lonlat_rad: torch.Tensor) -> torch.Tensor:
    """Radian (lon, lat) [..., 2] -> unit xyz [..., 3]."""
    lon = lonlat_rad[..., 0]
    lat = lonlat_rad[..., 1]
    clat = torch.cos(lat)
    return torch.stack([clat * torch.cos(lon), clat * torch.sin(lon),
                        torch.sin(lat)], dim=-1)


def lonlat_deg_to_xyz(lonlat_deg: torch.Tensor) -> torch.Tensor:
    """Degree (lon, lat) [..., 2] -> unit xyz [..., 3]."""
    return lonlat_rad_to_xyz(deg2rad(lonlat_deg))


def geo_sort_order(xyz: torch.Tensor, n_bands: int = 12) -> torch.Tensor:
    """Spatial sort of unit vectors [N, 3]: latitude bands, then longitude
    within a band (`range_tpu/geometry.py:115-124`).  Returns the stable
    argsort permutation [N]."""
    lat = torch.arcsin(torch.clamp(xyz[:, 2], -1, 1))
    lon = torch.atan2(xyz[:, 1], xyz[:, 0])
    band = torch.floor((lat + math.pi / 2) / (math.pi / n_bands))
    return torch.argsort(band * 10.0 + lon / math.pi, stable=True)
