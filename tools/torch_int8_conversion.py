"""Kernel 3 (the dense dual softmax over int8 value codes) on the H100
with its conversion of the codes to bf16 varied, to find what paces it.

Builds copies of `range_tpu_torch/csrc/fused_retrieval_sm90.cu` with the
conversion (`convert_half`) replaced, under `range_tpu_torch/_build/`, and
times each at the dense path's shape (B = 10,000 queries over the
102,400-row bank, 1,024-d values, the fast tier, RANGE+) beside kernel 2
(bf16 values) on CUDA events:

  * as built: 32 codes a task (two 16-byte loads, four 16-byte stores);
  * 8 and 16 codes a task (one 8- or 16-byte load), the loads of 4 and 2
    tasks in flight;
  * no conversion (the converting warps wait and arrive only: the answer
    is wrong, the time is the pipeline's without the conversion);
  * the conversion done twice.

    python3 tools/torch_int8_conversion.py

Needs a CUDA card and nvcc; prints one line per variant.
"""

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from range_tpu_torch.kernels import _build  # noqa: E402

SRC = (_build.CSRC / "fused_retrieval_sm90.cu").read_text()
A = SRC.index("template <int BN, int DVS>\n__device__ __forceinline__ void convert_half(")
Z = SRC.index("// The block's output rows r0 and r0 + 8 of one warp")
CALL = "    convert_half<BN, DVS>(s8 + s * (BN / 2) * DVS, v, h * (BN / 2), ct);\n"

# `convert_half` with W codes a task (W = 8: one 8-byte load, W = 16: one
# 16-byte load) and CB tasks' loads in flight
NARROW = """template <int BN, int DVS>
__device__ __forceinline__ void convert_half(uint32_t src, uint32_t v, int r0, int ct) {
  constexpr int W = WIDTH, CH = DVS / W, TASKS = (BN / 2) * CH;
  constexpr int PER = (TASKS + CONVERTERS - 1) / CONVERTERS, CB = BATCH, NW = W / 4;
#pragma unroll 1
  for (int j0 = 0; j0 < PER; j0 += CB) {
    uint32_t w[CB][NW];
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int i = ct + (j0 + b) * CONVERTERS;
      if (j0 + b < PER && i < TASKS) {
        const uint32_t a = src + (i / CH) * DVS + (i % CH) * W;
        if constexpr (NW == 2) {
          asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(w[b][0]), "=r"(w[b][1]) : "r"(a));
        } else {
          asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                       : "=r"(w[b][0]), "=r"(w[b][1]), "=r"(w[b][2]), "=r"(w[b][3]) : "r"(a));
        }
      }
    }
#pragma unroll
    for (int b = 0; b < CB; ++b) {
      const int i = ct + (j0 + b) * CONVERTERS;
      if (j0 + b < PER && i < TASKS) {
        const int row = r0 + i / CH, col = (i % CH) * W;
#pragma unroll
        for (int q = 0; q < NW / 2; ++q) {
          uint32_t o0, o1, o2, o3;
          codes_bf16(w[b][2 * q], o0, o1);
          codes_bf16(w[b][2 * q + 1], o2, o3);
          const int c = col / 8 + q;  // 8-column chunk of the slice
          const uint32_t dst = v + (c >> 3) * (BN * 128) + row * 128 + (((c & 7) ^ (row & 7)) << 4);
          asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(dst), "r"(o0), "r"(o1),
                       "r"(o2), "r"(o3) : "memory");
        }
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

"""


def narrow(width: int, batch: int) -> str:
    body = NARROW.replace("WIDTH", str(width)).replace("BATCH", str(batch))
    return SRC[:A] + body + SRC[Z:]


VARIANTS = {
    "32 codes a task (as built)": SRC,
    "8 codes a task, 4 in flight": narrow(8, 4),
    "16 codes a task, 2 in flight": narrow(16, 2),
    "no conversion": SRC.replace(CALL, "    (void)ct; (void)v;\n"),
    "the conversion twice": SRC.replace(CALL, CALL + CALL),
}


def build(item):
    i, (name, text) = item
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / f"v{i}.cu", out_dir / f"libv{i}.so"
    src.write_text(text)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr[-3000:]}")
    return name, lib


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    assert SRC.count(CALL) == 1
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = list(pool.map(build, enumerate(VARIANTS.items())))
    from range_tpu_torch import GeoBank
    from range_tpu_torch.bank import quantize_values
    from range_tpu_torch.ops import retrieval_fused as rf

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bank = GeoBank.synthetic_device(0, 100_000, pad_to=4096, value_dtype=torch.bfloat16,
                                    device=dev)
    b8 = quantize_values(bank)
    q = torch.nn.functional.normalize(torch.randn(10_000, 256, generator=gen, device=dev), dim=1)
    x = torch.nn.functional.normalize(torch.randn(10_000, 3, generator=gen, device=dev), dim=1)
    q_cat = rf.pack_queries(q, x, 12.0, 40.0, "fast")
    k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, "fast")
    mask = (rf.NEG * (1 - bank.row_mask()))[None]
    ref = rf._retrieve_fused_plain(q_cat, k_cat, b8.values, mask, 0.5, b8.value_scale, sem_d=256)

    def ms(fn, n=5):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / n

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    real = _build.load_kernel_library
    try:
        for name, path in libs:
            lib = ctypes.CDLL(str(path))
            fn = lib.fused_sm90_launch
            fn.argtypes = _build._SIGNATURES["fused_retrieval_sm90"]["fused_sm90_launch"]
            fn.restype = ctypes.c_int
            _build.load_kernel_library = lambda _name, lib=lib: lib
            k3 = lambda: rf._launch_sm90(q_cat, k_cat, b8.values, mask, 0.5, 256,  # noqa: E731
                                         scale=b8.value_scale)
            k2 = lambda: rf._launch_sm90(q_cat, k_cat, bank.values, mask, 0.5, 256)  # noqa: E731
            err = (k3() - ref).abs().max().item()
            print(f"{name}: kernel 3 {ms(k3):.3f} ms, kernel 2 {ms(k2):.3f} ms (CUDA events, "
                  f"5 calls), kernel 3's largest error against its plain version {err:.3e}")
    finally:
        _build.load_kernel_library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
