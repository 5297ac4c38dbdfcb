"""Build and bind the hand-written CUDA kernels of `range_tpu_torch/csrc/`.

Each `csrc/<name>.cu` is compiled by `nvcc` at first use into a shared
library with a plain C interface, under `range_tpu_torch/_build/`, and
loaded with `ctypes`.  The library's file name carries a hash of its source,
the shared headers (`csrc/*.cuh`) and the flags, so a changed source
rebuilds.  Nothing outside the checkout is written.  Pointers and the CUDA
stream go across as `c_void_p`; each C entry point returns
`cudaGetLastError()` and the wrappers raise on non-zero.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# sources of several heavy kernel instances (hier_parts: 16,
# fused_retrieval_sm90: 15, hier_parts_sm90: 2 of many inlined variants,
# hier_argmax_sm90: 32), whose kernels nvcc compiles in parallel threads
SPLIT_FLAGS = {name: ["-split-compile=0"]
               for name in ("hier_parts", "hier_parts_family_sm90", "fused_retrieval_sm90",
                            "hier_parts_sm90", "hier_argmax_sm90")}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points and their argument types, per kernel library
_SIGNATURES = {
    "siren_tower": {"siren_tower_launch":
                    [_P] * 8 + [_I] * 4 + [_F, _F, _I, _P]},
    "siren_tower_sm90": {"siren_tower_sm90_launch": [_P] * 6 + [_I] * 4 + [_F, _F, _P],
                         "siren_tower_sm90_smem": [_I, _I]},
    "sh_times": {"sh_times_plan": [_I] * 3 + [_P],
                 "sh_times_launch": [_P] * 6 + [_I] * 6 + [_P]},
    "fused_retrieval": {"fused_retrieval_launch":
                        [_P] * 5 + [_I] * 6 + [_F, _I, _P],
                        "fused_retrieval_i8_launch":
                        [_P] * 6 + [_I] * 6 + [_F, _I, _P],
                        "fused_parts_launch": [_P] * 6 + [_I] * 7 + [_P],
                        "family_pruned_launch": [_P] * 8 + [_I] * 9 + [_P],
                        "fused_hybrid_launch":
                        [_P] * 6 + [_I] * 6 + [_F] + [_I] * 3 + [_P]},
    "fused_retrieval_sm90": {"fused_sm90_launch":
                             [_P] * 7 + [_I] * 5 + [_F] + [_I] * 7 + [_P]},
    "hier_scan_sm90": {"hier_scan_sm90_launch": [_P] * 11 + [_I] * 24 + [_P]},
    "hier_refine": {"hier_refine_launch": [_P] * 5 + [_I] * 6 + [_P],
                    "hier_refine_parts_launch": [_P] * 9 + [_I] * 9 + [_P]},
    "hier_corr": {"hier_corr_launch": [_P] * 5 + [_I] * 7 + [_P]},
    "hier_cores": {"hier_groups_launch": [_P, _P, _F, _P],
                   "hier_rows_launch": [_P, _P, _P]},
    "hier_scan_stats": {"hier_scan_stats_launch": [_P] * 7 + [_I] * 9 + [_P]},
    "hier_parts": {"hier_parts_launch": [_P] * 11 + [_I] * 15 + [_P],
                   "hier_parts_family_values_launch":
                   [_P] * 9 + [_I] * 16 + [_P]},
    "hier_parts_sm90": {"hier_parts_sm90_launch": [_P] * 13 + [_I] * 24 + [_P]},
    "hier_parts_family": {"hier_parts_family_launch":
                          [_P] * 9 + [_I] * 17 + [_P]},
    "hier_parts_family_sm90": {"hier_parts_family_sm90_launch":
                               [_P] * 11 + [_I] * 22 + [_P]},
    "combine_cat": {"combine_cat_launch": [_P] * 7 + [_I] * 8 + [_F, _P]},
    "combine_cat_sm90": {"combine_cat_sm90_launch": [_P] * 6 + [_I] * 8 + [_F, _P],
                         "combine_cat_sm90_smem": []},
    "hier_argmax": {"hier_argmax_launch": [_P] * 7 + [_I] * 5 + [_P],
                    "hier_topk_launch": [_P] * 7 + [_I] * 6 + [_P]},
    "hier_argmax_sm90": {"hier_argmax_sm90_launch": [_P] * 8 + [_I] * 9 + [_P],
                         "hier_topk_sm90_launch": [_P] * 8 + [_I] * 10 + [_P]},
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): the "
                           "kernels are built with nvcc at first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_kernel(name: str):
    """Compile `csrc/<name>.cu` unless its hashed library exists.

    Returns (library path, build seconds, compiler output); seconds is 0.0
    and the output empty when the library was already built."""
    src = CSRC / f"{name}.cu"
    flags = NVCC_FLAGS + SPLIT_FLAGS.get(name, [])
    h = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *flags, "-o", str(tmp), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib, seconds, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_kernel_library(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name`` with its entry points typed."""
    path, _, _ = build_kernel(name)
    lib = ctypes.CDLL(str(path))
    for fn_name, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
