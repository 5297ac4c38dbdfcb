"""range_tpu_torch — the PyTorch + CUDA (Hopper) port of range_tpu.

Serves the dense RANGE / RANGE+ path, the hierarchical RANGE+ and RANGE
flagship paths (bf16 or int8 bank values) and the SatCLIP tower with
hand-written CUDA kernels (`csrc/`): the fused SH + SIREN tower, the fused
dense dual-softmax retrieval (bf16 and int8 values), and the hierarchical
scan, family parts, merged parts, combine and top-k kernels.  Imports
torch and numpy, never jax.
"""

from .api import GeoEncoder, list_models, load_model
from .bank.bank import GeoBank

__all__ = ["GeoBank", "GeoEncoder", "list_models", "load_model"]
