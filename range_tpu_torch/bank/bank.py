"""The RANGE retrieval bank as a dataclass of tensors.

Counterpart of `range_tpu/bank/bank.py:37-279` (reference db handling,
`range/range.py:77-100`): an npz with ``locs [N,2] (lon,lat)``,
``satclip_embeddings [N,256]`` and ``image_embeddings [N,1024]``.  Keys are
L2-normalized at load and bank locations become unit-sphere xyz.  Rows are
padded to a multiple of ``pad_to``; `row_mask` marks the real ones.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..geometry import lonlat_deg_to_xyz


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass
class GeoBank:
    """locs/keys/values, row-padded to the same length Np.

    Fields:
      locs_lonlat: [Np, 2] degrees
      xyz:         [Np, 3] unit vectors of the bank locations
      keys_sem:    [Np, Dk] L2-normalized SatCLIP image embeddings
      values:      [Np, Dv] high-res image embeddings
      n_valid:     number of real rows
      valid_mask:  optional [Np] {0,1} mask; None means the prefix
                   [0, n_valid) is valid
      value_scale: optional [1, Np] f32 per-row dequantization scales, set
                   by `quantize_values` (values are then int8 codes and row
                   r is values[r] * value_scale[0, r])
    """

    locs_lonlat: torch.Tensor
    xyz: torch.Tensor
    keys_sem: torch.Tensor
    values: torch.Tensor
    n_valid: int
    valid_mask: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    @property
    def num_rows(self) -> int:
        return self.keys_sem.shape[0]

    @property
    def key_dim(self) -> int:
        return self.keys_sem.shape[1]

    @property
    def value_dim(self) -> int:
        return self.values.shape[1]

    @property
    def device(self) -> torch.device:
        return self.keys_sem.device

    def to(self, device) -> "GeoBank":
        def move(t):
            return None if t is None else t.to(device)

        return dataclasses.replace(
            self, locs_lonlat=move(self.locs_lonlat), xyz=move(self.xyz),
            keys_sem=move(self.keys_sem), values=move(self.values),
            valid_mask=move(self.valid_mask),
            value_scale=move(self.value_scale))

    @classmethod
    def from_arrays(cls, locs_lonlat: np.ndarray,
                    satclip_embeddings: np.ndarray,
                    image_embeddings: np.ndarray, *, pad_to: int = 1024,
                    key_dtype=torch.float32, value_dtype=torch.float32,
                    normalized: bool = False, device="cuda") -> "GeoBank":
        """Pad, normalize keys (numpy f32, as the JAX package) and compute
        xyz (`range_tpu/bank/bank.py:75-107`), then place the bank on
        ``device`` (the card unless the caller asks for the CPU, as the
        JAX constructors land on the default accelerator)."""
        n = locs_lonlat.shape[0]
        np_rows = _round_up(n, pad_to)
        locs = np.zeros((np_rows, 2), np.float32)
        locs[:n] = locs_lonlat
        keys = np.zeros((np_rows, satclip_embeddings.shape[1]), np.float32)
        k = np.asarray(satclip_embeddings, np.float32)
        if not normalized:
            k = k / np.linalg.norm(k, ord=2, axis=1, keepdims=True)
        keys[:n] = k
        vals = np.zeros((np_rows, image_embeddings.shape[1]), np.float32)
        vals[:n] = image_embeddings
        locs_t = torch.from_numpy(locs)
        xyz = torch.zeros((np_rows, 3), dtype=torch.float32)
        xyz[:n] = lonlat_deg_to_xyz(locs_t[:n])
        return cls(locs_lonlat=locs_t.to(device), xyz=xyz.to(device),
                   keys_sem=torch.from_numpy(keys).to(device, key_dtype),
                   values=torch.from_numpy(vals).to(device, value_dtype),
                   n_valid=int(n))

    @classmethod
    def from_npz(cls, path: str, **kw) -> "GeoBank":
        """Load a reference-format npz (`range.py:78-90` key names)."""
        with np.load(path, allow_pickle=False) as db:
            return cls.from_arrays(
                db["locs"].astype(np.float32),
                db["satclip_embeddings"].astype(np.float32),
                db["image_embeddings"].astype(np.float32), **kw)

    @classmethod
    def synthetic(cls, rng, n: int, key_dim: int = 256,
                  value_dim: int = 1024, **kw) -> "GeoBank":
        """Random bank drawn with numpy exactly as the JAX package draws it
        (`range_tpu/bank/bank.py:151-161`), so the same seed gives the same
        locations, keys and values."""
        if isinstance(rng, int):
            rng = np.random.default_rng(rng)
        lons = rng.uniform(-180, 180, size=n)
        lats = np.degrees(np.arcsin(rng.uniform(-1, 1, size=n)))
        locs = np.stack([lons, lats], 1).astype(np.float32)
        keys = rng.standard_normal((n, key_dim)).astype(np.float32)
        vals = rng.standard_normal((n, value_dim)).astype(np.float32)
        return cls.from_arrays(locs, keys, vals, **kw)

    @classmethod
    def synthetic_device(cls, seed: int, n: int, key_dim: int = 256,
                         value_dim: int = 1024, pad_to: int = 4096,
                         key_dtype=torch.float32, value_dtype=torch.float32,
                         *, device) -> "GeoBank":
        """Random bank generated on ``device`` from a seeded
        `torch.Generator`, with the recipe of the JAX package's
        `synthetic_device` (`range_tpu/bank/bank.py:164-189`): area-uniform
        locations, unit gaussian keys, gaussian values, padding rows zero.
        The numbers differ from the JAX package's (another generator)."""
        n_rows = _round_up(n, pad_to)
        g = torch.Generator(device=device).manual_seed(seed)
        f32 = torch.float32

        def uniform(lo, hi, *shape):
            return torch.empty(shape, dtype=f32, device=device).uniform_(
                lo, hi, generator=g)

        def normal(*shape):
            return torch.empty(shape, dtype=f32, device=device).normal_(
                generator=g)

        lons = uniform(-180.0, 180.0, n_rows)
        lats = torch.rad2deg(torch.arcsin(uniform(-1.0, 1.0, n_rows)))
        locs = torch.stack([lons, lats], 1)
        row_ok = (torch.arange(n_rows, device=device) < n)[:, None]
        keys = normal(n_rows, key_dim)
        keys = keys / torch.linalg.norm(keys, dim=1, keepdim=True)
        keys = torch.where(row_ok, keys, 0.0).to(key_dtype)
        vals = torch.where(row_ok, normal(n_rows, value_dim), 0.0)
        locs = torch.where(row_ok, locs, 0.0)
        return cls(locs_lonlat=locs,
                   xyz=torch.where(row_ok, lonlat_deg_to_xyz(locs), 0.0),
                   keys_sem=keys, values=vals.to(value_dtype),
                   n_valid=int(n))

    @classmethod
    def synthetic_informative(cls, seed: int, n: int, key_dim: int = 256,
                              value_dim: int = 1024, pad_to: int = 4096,
                              key_dtype=torch.float32,
                              value_dtype=torch.float32,
                              key_noise: float = 0.25, tower_seed: int = 0,
                              *, device) -> "GeoBank":
        """Spatially autocorrelated synthetic bank generated on ``device``,
        with the recipe of the JAX package's `synthetic_informative`
        (`range_tpu/bank/bank.py:191-271`): keys are the seeded SatCLIP
        tower's embeddings of the bank locations plus ``key_noise``
        gaussian noise, re-normalized; values are ``tanh`` of a fixed random
        projection of the tower features plus 0.1 gaussian noise.

        The tower is the one `load_model(..., seed=tower_seed,
        device=device)` builds (a `torch.Generator` seeded with
        ``tower_seed`` on the same device: a CUDA generator draws other
        numbers than a CPU one), so bank keys and served queries are
        aligned.  Its features come from the plain basis -> net compose, as
        the JAX package pins them.  Locations, noise and projection come
        from a generator seeded with ``seed + 7919``; all numbers differ
        from the JAX package's (another generator)."""
        from ..models.satclip import (SatClipLocationConfig,
                                      SatClipLocationEncoder)

        n_rows = _round_up(n, pad_to)
        g = torch.Generator(device=device).manual_seed(seed + 7919)
        f32 = torch.float32

        def uniform(lo, hi, *shape):
            return torch.empty(shape, dtype=f32, device=device).uniform_(
                lo, hi, generator=g)

        def normal(*shape):
            return torch.empty(shape, dtype=f32, device=device).normal_(
                generator=g)

        lons = uniform(-180.0, 180.0, n_rows)
        lats = torch.rad2deg(torch.arcsin(uniform(-1.0, 1.0, n_rows)))
        locs = torch.stack([lons, lats], 1)
        row_ok = (torch.arange(n_rows, device=device) < n)[:, None]
        tower = SatClipLocationEncoder(
            SatClipLocationConfig(embed_dim=key_dim), device=device,
            generator=torch.Generator(device=device).manual_seed(tower_seed))
        CH = 131_072  # bounds the [rows, L*L] f32 basis of one chunk
        with torch.no_grad():
            f = torch.cat([tower.nnet(tower.posenc(locs[lo:lo + CH]))
                           for lo in range(0, n_rows, CH)])
        keys = f / torch.clamp_min(torch.linalg.norm(f, dim=1, keepdim=True),
                                   1e-12)
        keys = keys + key_noise * normal(n_rows, key_dim) / key_dim ** 0.5
        keys = keys / torch.clamp_min(
            torch.linalg.norm(keys, dim=1, keepdim=True), 1e-12)
        keys = torch.where(row_ok, keys, 0.0).to(key_dtype)
        w = normal(key_dim, value_dim) / key_dim ** 0.5
        vals = torch.tanh(f @ w) + 0.1 * normal(n_rows, value_dim)
        vals = torch.where(row_ok, vals, 0.0).to(value_dtype)
        locs = torch.where(row_ok, locs, 0.0)
        return cls(locs_lonlat=locs,
                   xyz=torch.where(row_ok, lonlat_deg_to_xyz(locs), 0.0),
                   keys_sem=keys, values=vals, n_valid=int(n))

    def row_mask(self) -> torch.Tensor:
        """[Np] float32 {0,1} validity mask."""
        if self.valid_mask is not None:
            return self.valid_mask.to(torch.float32)
        return (torch.arange(self.num_rows, device=self.device)
                < self.n_valid).to(torch.float32)


_INV127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_values(bank: GeoBank) -> GeoBank:
    """Per-row symmetric int8 codes of the values (`range_tpu/bank/bank.py:
    282-301`): scale = max(max |row|, 1e-12) / 127, codes = clip(round(v /
    scale), -127, 127).  `torch.round` rounds half to even, as `jnp.round`,
    and the scale is taken as XLA computes it, so the codes and scales are
    the JAX package's bit for bit.  A bank that
    already has a scale is returned as it is."""
    if bank.value_scale is not None:
        return bank
    v = bank.values.to(torch.float32)
    # XLA compiles JAX's `/ 127.0` into a product with the f32 reciprocal
    scale = torch.clamp_min(v.abs().amax(dim=1), 1e-12) * _INV127
    codes = torch.clamp(torch.round(v / scale[:, None]), -127, 127)
    return dataclasses.replace(bank, values=codes.to(torch.int8),
                               value_scale=scale[None, :])


def dequantize_values(bank: GeoBank) -> torch.Tensor:
    """[Np, Dv] f32 values: the reconstruction of int8 codes, else the
    stored values (`range_tpu/bank/bank.py:304-308`)."""
    if bank.value_scale is None:
        return bank.values.to(torch.float32)
    return bank.values.to(torch.float32) * bank.value_scale.T
