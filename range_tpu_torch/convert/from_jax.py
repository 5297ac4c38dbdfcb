"""Carry weights and bank state across from the JAX package, as numpy.

The port never imports jax: callers hand over numpy arrays (or anything
`np.asarray` accepts, such as JAX arrays in a test that imports both).
A HierBank the JAX package saved (its `save_hier_bank`, or `python -m
range_tpu.build_hier`) needs no converter: both packages share the archive
format, so `ops.retrieval_hier.load_hier_bank(path, device=...)` reads it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bank.bank import GeoBank


def _tensor(x) -> torch.Tensor:
    a = np.array(x, order="C")  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: carry the bit pattern
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def siren_params_from_jax(tree) -> dict:
    """JAX SirenNet params (``{"layers": [{"w", "b"}, ...], "last": {...}}``,
    w stored [in, out]) -> the port's `SirenNet.state_dict()` (nn.Linear
    stores [out, in], so every w is transposed; `range_tpu/ops/nets.py:5-9`)."""
    sd = {}
    for name, layer in ([(f"layers.{i}", l) for i, l in enumerate(tree["layers"])]
                        + [("last", tree["last"])]):
        sd[f"{name}.weight"] = _tensor(np.asarray(layer["w"]).T)
        if "b" in layer:
            sd[f"{name}.bias"] = _tensor(layer["b"])
    return sd


def geobank_from_arrays(locs_lonlat, xyz, keys_sem, values, n_valid,
                        valid_mask=None, value_scale=None, *,
                        device="cpu") -> GeoBank:
    """A JAX `GeoBank`'s fields, taken unchanged (no re-normalization, no
    recomputed xyz; int8 values with their ``value_scale`` [1, Np]), as a
    port GeoBank on ``device``."""
    def opt(x):
        return None if x is None else _tensor(x).to(device)

    return GeoBank(
        locs_lonlat=_tensor(locs_lonlat).to(device),
        xyz=_tensor(xyz).to(device), keys_sem=_tensor(keys_sem).to(device),
        values=_tensor(values).to(device), n_valid=int(n_valid),
        valid_mask=opt(valid_mask), value_scale=opt(value_scale))
