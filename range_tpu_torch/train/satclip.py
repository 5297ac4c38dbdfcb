"""SatCLIP pretraining: the dual-tower contrastive step, in PyTorch.

Counterpart of `range_tpu/train/satclip.py` (reference
`satclip/main_old.py:15-108`, `model_old.py:248-377`, `loss_old.py:5-47`):

  * `SatClipModel`: a vision tower (the standard ResNet, `StdResNetConfig`)
    and the SH + SIREN location tower, with a learned ``logit_scale``;
  * `clip_loss`: the symmetric in-batch cross-entropy;
  * AdamW with the reference's weight-decay exclusion (no decay for
    ndim < 2: biases, batch-norm parameters, logit_scale), after a
    global-norm clip written as optax computes it;
  * gradient accumulation over microbatches, as the JAX step's scan does
    (the reference's Lightning `accumulate_grad_batches: 16`).

In training the location tower's first layer runs through the SH-times
kernel (`ops.sh.spherical_harmonics_times_fused`) and autograd does the
rest.  The ViT and CLIP-ResNet vision towers and the sharded step are not
ported yet (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..models.resnet_std import RESNET18, StdResNetConfig, init_std_resnet
from ..models.satclip import SatClipLocationConfig, SatClipLocationEncoder


@dataclasses.dataclass(frozen=True)
class SatClipConfig:
    # the JAX package defaults to a ViT; the port has the standard ResNet
    # only, so its default is the published SatCLIP-ResNet18-L40 pair
    vision: Any = RESNET18
    location: SatClipLocationConfig = SatClipLocationConfig()
    init_logit_scale: float = math.log(1 / 0.07)  # model_old.py:332


def _logits(img: torch.Tensor, loc: torch.Tensor, logit_scale: torch.Tensor):
    """(logits_per_image, logits_per_location) of the two towers' outputs,
    as `model_old.py:363-377`: both unit-normalised, scaled by the
    unclamped exp(logit_scale)."""
    img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
    loc = loc / torch.linalg.norm(loc, dim=-1, keepdim=True)
    logits_per_image = torch.exp(logit_scale) * img @ loc.T
    return logits_per_image, logits_per_image.T


class SatClipModel(nn.Module):
    """Dual tower: the standard ResNet image encoder and the (SH -> SIREN)
    location encoder.  Parameters are drawn in that order from
    ``generator``."""

    def __init__(self, config: SatClipConfig = SatClipConfig(), *,
                 device="cuda", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not isinstance(config.vision, StdResNetConfig):
            raise NotImplementedError(
                f"the {type(config.vision).__name__} vision tower is not ported "
                "yet (ROADMAP.md, Queue 1: image towers); use StdResNetConfig")
        self.config = config
        self.visual = init_std_resnet(config.vision, generator=generator,
                                      device=device, dtype=dtype)
        self.location = SatClipLocationEncoder(config.location, device=device,
                                               dtype=dtype, generator=generator)
        self.logit_scale = nn.Parameter(torch.tensor(
            config.init_logit_scale, device=device, dtype=dtype))

    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return self.visual(images)

    def encode_location(self, coords: torch.Tensor, training: bool = False,
                        generator: Optional[torch.Generator] = None):
        return self.location(coords, training=training, generator=generator)

    def forward(self, images: torch.Tensor, coords: torch.Tensor,
                training: bool = False,
                generator: Optional[torch.Generator] = None):
        """Returns (logits_per_image, logits_per_location)."""
        return _logits(self.encode_image(images),
                       self.encode_location(coords, training, generator),
                       self.logit_scale)


def clip_loss(logits_per_image: torch.Tensor,
              logits_per_coord: torch.Tensor) -> torch.Tensor:
    """Symmetric cross-entropy on the in-batch diagonal (`loss_old.py:37-47`)."""
    labels = torch.arange(logits_per_image.shape[0],
                          device=logits_per_image.device)
    return (F.cross_entropy(logits_per_image, labels)
            + F.cross_entropy(logits_per_coord, labels)) / 2


def _decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True where weight decay applies, by parameter name.  Reference rule
    (`main_old.py:79-87`): exclude ndim < 2 (biases, batch-norm parameters,
    logit_scale)."""
    return {name: p.ndim >= 2 for name, p in model.named_parameters()}


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """What `make_optimizer` returns: AdamW (β 0.9, 0.999, eps 1e-8, as
    optax's defaults) with the decay mask, after a global-norm clip.
    ``learning_rate`` is a float or a schedule ``step -> lr`` (e.g.
    `train.fit.epoch_decay_schedule`), read before each update at the
    number of updates made so far, as optax reads its schedules."""

    learning_rate: Union[float, Callable[[int], float]] = 1e-4
    weight_decay: float = 0.01
    grad_clip: Optional[float] = 1.0

    def lr(self, step: int) -> float:
        lr = self.learning_rate
        return float(lr(step)) if callable(lr) else float(lr)

    def build(self, model: nn.Module) -> torch.optim.AdamW:
        """AdamW over the model's trainable parameters: one group with
        decay, one without."""
        mask = _decay_mask(model)
        groups = [[p for name, p in model.named_parameters()
                   if p.requires_grad and mask[name] == decay]
                  for decay in (True, False)]
        return torch.optim.AdamW(
            [{"params": groups[0], "weight_decay": self.weight_decay},
             {"params": groups[1], "weight_decay": 0.0}],
            lr=self.lr(0), betas=(0.9, 0.999), eps=1e-8)


def make_optimizer(learning_rate=1e-4, weight_decay: float = 0.01,
                   grad_clip: Optional[float] = 1.0) -> OptimizerConfig:
    """AdamW with the reference's weight-decay exclusion mask; ``grad_clip``
    is a global-norm bound (None disables clipping)."""
    return OptimizerConfig(learning_rate, weight_decay, grad_clip)


def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``,
    as `optax.clip_by_global_norm` computes it: unchanged when the norm is
    below the bound, else ``(g / norm) * max_norm`` (torch's
    `clip_grad_norm_` adds 1e-6 to the norm instead).  Returns the norm."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def make_train_step(model: SatClipModel, optimizer: OptimizerConfig,
                    accum_steps: int = 1):
    """Returns ``step(batch, generator) -> loss``, which updates ``model`` in
    place.  ``batch = {"image": [A*B, C, H, W], "point": [A*B, 2]}`` holds
    A = ``accum_steps`` microbatches along the batch axis; their gradients
    are summed, divided by A, then clipped, and the loss is their mean
    (`range_tpu/train/satclip.py:123-157`).  ``generator`` draws the
    location tower's dropout masks.  ``step.optimizer`` is the AdamW."""
    opt = optimizer.build(model)
    params = [p for group in opt.param_groups for p in group["params"]]

    def step(batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        images, points = batch["image"], batch["point"]
        B = images.shape[0] // accum_steps
        opt.zero_grad(set_to_none=True)
        loss = None
        for i in range(accum_steps):
            sl = slice(i * B, (i + 1) * B)
            li, lc = model(images[sl], points[sl], training=True,
                           generator=generator)
            micro = clip_loss(li, lc)
            micro.backward()
            loss = micro.detach() if loss is None else loss + micro.detach()
        grads = [p.grad for p in params]
        if accum_steps > 1:
            for g in grads:
                g.div_(accum_steps)
            loss = loss / accum_steps
        if optimizer.grad_clip is not None:
            clip_by_global_norm(grads, optimizer.grad_clip)
        for group in opt.param_groups:
            group["lr"] = optimizer.lr(step.updates)
        opt.step()
        step.updates += 1
        return loss

    step.optimizer = opt
    step.updates = 0
    return step


def cast_floating(tree, dtype: torch.dtype = torch.bfloat16):
    """Cast the floating tensors of a nested dict / list / tuple (a state
    dict, say) to ``dtype`` for low-precision serving
    (`range_tpu/train/satclip.py:238`, reference `convert_weights`,
    model_old.py:379-400); integer and bool tensors pass through."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, cast_floating(v, dtype)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    return tree
