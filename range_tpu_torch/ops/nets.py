"""SIREN head as an `nn.Module`.

Counterpart of `range_tpu/ops/nets.py:52-124` (reference
`location_encoder.py:73-151`): ``num_layers`` sine layers (w0=30 on the
first, w0=1 after), each with p=0.5 dropout on its pre-activation in
training, and a final linear layer (identity activation).  The
initialisation draws the same uniform bounds as the JAX `SirenNet.init`
(`ops/nets.py:76-95`) from a `torch.Generator`, so the numbers differ from
the JAX package's; `convert/from_jax.py` carries JAX weights across.

Weights are stored in `nn.Linear`'s [out, in] layout; `tower_params` hands
the JAX [in, out] layout to the fused tower kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _uniform_linear(d_in: int, d_out: int, bound: float, use_bias: bool,
                    device, dtype, generator) -> nn.Linear:
    lin = nn.Linear(d_in, d_out, bias=use_bias, device=device, dtype=dtype)
    with torch.no_grad():
        lin.weight.uniform_(-bound, bound, generator=generator)
        if use_bias:
            lin.bias.uniform_(-bound, bound, generator=generator)
    return lin


class SirenNet(nn.Module):
    """Sinusoidal representation network, final activation identity."""

    def __init__(self, dim_in: int, dim_hidden: int, dim_out: int,
                 num_layers: int, *, w0: float = 1.0, w0_initial: float = 30.0,
                 use_bias: bool = True, c: float = 6.0,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w0 = w0
        self.w0_initial = w0_initial
        self.dropout = True  # pre-activation dropout in training
        self.layers = nn.ModuleList()
        for ind in range(num_layers):
            is_first = ind == 0
            d_in = dim_in if is_first else dim_hidden
            layer_w0 = w0_initial if is_first else w0
            w_std = (1.0 / d_in) if is_first else (math.sqrt(c / d_in) / layer_w0)
            self.layers.append(_uniform_linear(d_in, dim_hidden, w_std,
                                               use_bias, device, dtype,
                                               generator))
        self.last = _uniform_linear(dim_hidden, dim_out,
                                    math.sqrt(c / dim_hidden) / w0, use_bias,
                                    device, dtype, generator)

    def forward(self, x: Optional[torch.Tensor], training: bool = False,
                generator: Optional[torch.Generator] = None,
                first_preact: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``first_preact``: the precomputed layer-0 pre-activation
        (x @ W0 + b0), so that a caller can fuse the positional encoding
        into the first product (`ops.sh.spherical_harmonics_times_fused`);
        ``x`` is then not read.  In training each hidden pre-activation h
        keeps an element with probability 0.5, drawn from ``generator``,
        and scales it by 2 (`range_tpu/ops/nets.py:106-114`)."""
        if training and self.dropout and generator is None:
            raise ValueError("training=True with dropout requires a generator")

        def linear(lin, x):
            b = None if lin.bias is None else lin.bias.to(x.dtype)
            return F.linear(x, lin.weight.to(x.dtype), b)

        for ind, lin in enumerate(self.layers):
            h = first_preact if (ind == 0 and first_preact is not None) \
                else linear(lin, x)
            if training and self.dropout:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < 0.5
                h = torch.where(keep, h / 0.5, 0.0)
            x = torch.sin((self.w0_initial if ind == 0 else self.w0) * h)
        return linear(self.last, x)

    def tower_params(self) -> dict:
        """The JAX package's param layout ([in, out] weights), as views."""
        def entry(lin):
            p = {"w": lin.weight.T}
            if lin.bias is not None:
                p["b"] = lin.bias
            return p

        return {"layers": [entry(lin) for lin in self.layers],
                "last": entry(self.last)}


def get_neural_network(name: str, input_dim: int, num_classes: int = 256,
                       dim_hidden: int = 256, num_layers: int = 2, *,
                       device="cuda", dtype=torch.float32, generator=None):
    """Name dispatch (`range_tpu/ops/nets.py:228`); only "siren" is ported."""
    if name == "siren":
        return SirenNet(input_dim, dim_hidden, num_classes, num_layers,
                        device=device, dtype=dtype, generator=generator)
    raise NotImplementedError(
        f"neural network {name!r} is not ported yet (ROADMAP.md, Queue 1: "
        "rest of the encoder zoo)")
