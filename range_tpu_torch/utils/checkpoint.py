"""Checkpoint save/restore of a model's parameters.

Counterpart of `range_tpu/utils/checkpoint.py` (orbax / msgpack there):
one `torch.save` file of the model's state dict.
"""

from __future__ import annotations

import torch
from torch import nn


def save(path: str, model: nn.Module) -> None:
    torch.save(model.state_dict(), path)


def load(path: str, model: nn.Module) -> nn.Module:
    """Load the parameters saved at ``path`` into ``model`` (in place, onto
    the model's device) and return it."""
    device = next(model.parameters()).device
    model.load_state_dict(torch.load(path, map_location=device, weights_only=True))
    return model
