"""Standard (torchvision/timm-layout) ResNet-18/50 — the moco vision towers.

Counterpart of `range_tpu/models/resnet_std.py` (reference
`model_old.py:286-303`: `timm.create_model("resnet{18,50}", in_chans,
num_classes=embed_dim)`): a 7x7/2 stem, a 3x3/2 max pool, basic or
bottleneck stages, global average pool, a linear head.  The parameters
keep the JAX package's tree as module names (``conv1.w``, ``bn1.g``,
``stages.0.0.conv1.w``, ``stages.1.0.downsample.bn.mean``, ...), and batch
norm reads its statistics as trainable parameters, as the JAX step does
(`resnet.py:39-44`; upstream freezes the backbone instead, `trainable_mask`).
Weights are seeded random from a `torch.Generator` (numbers differ from
JAX's); `convert/from_jax.std_resnet_params_from_jax` carries JAX weights
across.  Loading the timm/torchgeo state dict waits for checkpoint loading
(ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import _bn, _conv


@dataclasses.dataclass(frozen=True)
class StdResNetConfig:
    layers: Tuple[int, ...] = (2, 2, 2, 2)  # resnet18
    block: str = "basic"  # 'basic' (18/34) | 'bottleneck' (50/101)
    output_dim: int = 256
    width: int = 64
    in_channels: int = 13

    @property
    def expansion(self) -> int:
        return 1 if self.block == "basic" else 4


RESNET18 = StdResNetConfig()
RESNET50 = StdResNetConfig(layers=(3, 4, 6, 3), block="bottleneck")


def _max_pool_3x3s2(x: torch.Tensor) -> torch.Tensor:
    # max_pool2d pads with -inf, as the JAX reduce_window does
    return F.max_pool2d(x, 3, 2, padding=1)


def _basic_block(p, x, stride):
    out = torch.relu(_bn(_conv(x, p["conv1"]["w"], stride=stride, padding=1),
                         p["bn1"]))
    out = _bn(_conv(out, p["conv2"]["w"], padding=1), p["bn2"])
    if "downsample" in p:
        x = _bn(_conv(x, p["downsample"]["conv"]["w"], stride=stride),
                p["downsample"]["bn"])
    return torch.relu(out + x)


def _bottleneck_block(p, x, stride):
    # torchvision/timm put the stride on conv2
    out = torch.relu(_bn(_conv(x, p["conv1"]["w"]), p["bn1"]))
    out = torch.relu(_bn(_conv(out, p["conv2"]["w"], stride=stride, padding=1),
                         p["bn2"]))
    out = _bn(_conv(out, p["conv3"]["w"]), p["bn3"])
    if "downsample" in p:
        x = _bn(_conv(x, p["downsample"]["conv"]["w"], stride=stride),
                p["downsample"]["bn"])
    return torch.relu(out + x)


class StdResNet(nn.Module):
    """[B, C, H, W] -> [B, output_dim]; see `init_std_resnet`."""

    def __init__(self, cfg: StdResNetConfig, *, device="cuda",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        if cfg.block not in ("basic", "bottleneck"):
            raise ValueError(f"unknown block {cfg.block!r}")

        def conv(cin, cout, k):
            # torch kaiming_normal_(fan_out, relu): std = sqrt(2 / (k*k*cout))
            w = torch.empty((cout, cin, k, k), device=device, dtype=dtype)
            w.normal_(0.0, math.sqrt(2.0 / (k * k * cout)), generator=generator)
            return nn.ParameterDict({"w": w})

        def bn(c):
            def full(v):
                return torch.full((c,), v, device=device, dtype=dtype)
            return nn.ParameterDict({"g": full(1.0), "b": full(0.0),
                                     "mean": full(0.0), "var": full(1.0)})

        self.conv1 = conv(cfg.in_channels, cfg.width, 7)
        self.bn1 = bn(cfg.width)
        self.stages = nn.ModuleList()
        inplanes, exp = cfg.width, cfg.expansion
        for stage_idx, blocks in enumerate(cfg.layers):
            planes = cfg.width * (2 ** stage_idx)
            stage = nn.ModuleList()
            for block_idx in range(blocks):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                if cfg.block == "basic":
                    p = {"conv1": conv(inplanes, planes, 3), "bn1": bn(planes),
                         "conv2": conv(planes, planes, 3), "bn2": bn(planes)}
                else:
                    p = {"conv1": conv(inplanes, planes, 1), "bn1": bn(planes),
                         "conv2": conv(planes, planes, 3), "bn2": bn(planes),
                         "conv3": conv(planes, planes * exp, 1),
                         "bn3": bn(planes * exp)}
                if stride > 1 or inplanes != planes * exp:
                    p["downsample"] = nn.ModuleDict({
                        "conv": conv(inplanes, planes * exp, 1),
                        "bn": bn(planes * exp)})
                stage.append(nn.ModuleDict(p))
                inplanes = planes * exp
            self.stages.append(stage)
        feat = cfg.width * 8 * exp
        bound = 1.0 / math.sqrt(feat)
        self.fc = nn.Linear(feat, cfg.output_dim, device=device, dtype=dtype)
        with torch.no_grad():
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(_bn(_conv(x, self.conv1["w"], stride=2, padding=3),
                           self.bn1))
        h = _max_pool_3x3s2(h)
        block = _basic_block if self.cfg.block == "basic" else _bottleneck_block
        for stage_idx, stage in enumerate(self.stages):
            for block_idx, p in enumerate(stage):
                stride = 2 if (stage_idx > 0 and block_idx == 0) else 1
                h = block(p, h, stride)
        return self.fc(h.mean(dim=(2, 3)))  # global average pool, head


def init_std_resnet(cfg: StdResNetConfig, *, generator: Optional[torch.Generator] = None,
                    device="cuda", dtype: torch.dtype = torch.float32) -> StdResNet:
    """`range_tpu/models/resnet_std.py:94`: conv weights kaiming-normal
    (fan_out, relu), batch norm g=1, b=0, mean=0, var=1, the head
    U(-1/sqrt(feat), 1/sqrt(feat)), drawn in module order from
    ``generator``."""
    return StdResNet(cfg, device=device, dtype=dtype, generator=generator)


def trainable_mask(model: StdResNet) -> Dict[str, bool]:
    """True only on ``fc``: the upstream moco recipe freezes the backbone
    and fine-tunes the head (model_old.py:292-293).  Keyed by parameter
    name; set ``requires_grad_(False)`` on the others to use it."""
    return {name: name.startswith("fc.") for name, _ in model.named_parameters()}
