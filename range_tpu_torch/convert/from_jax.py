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


def std_resnet_params_from_jax(tree) -> dict:
    """JAX standard-ResNet params (`range_tpu/models/resnet_std.py`) -> the
    port's `StdResNet.state_dict()`: the same names (``conv1.w``,
    ``stages.0.0.bn1.mean``, ...), conv weights as they are (both OIHW),
    the ``fc`` weight [in, out] transposed for `nn.Linear`."""
    sd = {}

    def put(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                put(f"{prefix}{k}.", v)
            else:
                sd[prefix + k] = _tensor(v)

    put("", {k: v for k, v in tree.items() if k not in ("stages", "fc")})
    for i, stage in enumerate(tree["stages"]):
        for j, block in enumerate(stage):
            put(f"stages.{i}.{j}.", block)
    sd["fc.weight"] = _tensor(np.asarray(tree["fc"]["w"]).T)
    sd["fc.bias"] = _tensor(tree["fc"]["b"])
    return sd


def satclip_params_from_jax(tree) -> dict:
    """JAX SatCLIP params (``{"visual", "location", "logit_scale"}``, a
    standard-ResNet vision tower) -> the port's `SatClipModel.state_dict()`,
    so that both packages train from the same start."""
    sd = {f"visual.{k}": v for k, v in std_resnet_params_from_jax(
        tree["visual"]).items()}
    sd.update({f"location.nnet.{k}": v for k, v in siren_params_from_jax(
        tree["location"]).items()})
    sd["logit_scale"] = _tensor(tree["logit_scale"])
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
