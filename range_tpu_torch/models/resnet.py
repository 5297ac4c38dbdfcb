"""Convolution and batch-norm helpers of the ResNet vision towers.

Counterpart of the helpers of `range_tpu/models/resnet.py:26-44`: NCHW
activations and OIHW weights (the torch layout, as the JAX package's `_DN`
keeps it, so converted weights copy as they are), and batch norm from the
parameters ``g, b, mean, var``.  The CLIP-style `ModifiedResNet` of that
module is not ported yet (ROADMAP.md, Queue 1: image towers).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, w, stride=stride, padding=padding)


def _bn(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    """Inference batch norm with the stored statistics; ``p`` maps "g",
    "b", "mean", "var" to [C] tensors.  All four are ordinary parameters:
    a training step differentiates and updates the statistics too, as
    `jax.value_and_grad` does over the JAX param tree."""
    inv = torch.rsqrt(p["var"] + eps)
    scale = (p["g"] * inv)[None, :, None, None]
    bias = (p["b"] - p["mean"] * p["g"] * inv)[None, :, None, None]
    return x * scale + bias
