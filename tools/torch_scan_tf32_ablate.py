"""Where `csrc/hier_scan_tf32_sm90.cu`'s time goes: variants of the source
with one part of its work taken out, timed on one card at the main paths'
shapes.  The variants are built from edited copies of the source under
archive_tree/ (listed in .gitignore) and give wrong answers by design; only
their times mean something.

Variants (each a text edit of the source, applied to every instance):
  * base: the source as it is;
  * no_stats: the stats (the octets' shuffles and the tiles' walk) skipped;
  * no_mma: the logits' products skipped (their fragments zeroed), the
    ring, its waits and the rest as they are;
  * no_copy: the ring's bulk copies skipped (the producer arrives on each
    stage's full barrier at once), the products on whatever the stage holds;
  * no_d: the scan's D writes skipped (its value pass as it is);
  * sync_only: no_mma and no_copy together.
Operands: seeded random ones of the flagship's and the top-k endpoint's
shapes at B = 10,000 (224 tiles: the sem family 7,168 or 14,336 groups of
256 columns, the geo family 1,792 of 128 with 3 real ones; tails of 384 and
512 columns), f32 and bf16 logits.  Prints the card's name and power limit,
then each case's ms (CUDA events, the mean of 3 turns of 5 calls; the scan
with its value pass) per variant.

    PYTHONPATH=. python3 tools/torch_scan_tf32_ablate.py

Needs a CUDA card and nvcc.
"""

import ctypes
import functools
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "range_tpu_torch" / "csrc"
OUT = ROOT / "archive_tree" / "scan_ablate"

EDITS = {
    "base": [],
    "no_stats": [("    if (oct) {\n#pragma unroll", "    if (false && oct) {\n#pragma unroll"),
                 ("    } else {\n      // each warp's 16 rows to the l tile",
                  "    } else if (false) {\n      // each warp's 16 rows to the l tile")],
    "no_mma": [("        if constexpr (LX3)\n          tf32::issue_chunk(ef, ah, al, tile, NG * 128, mma);"
                "\n        else\n          issue_hi(ef, ah, tile, mma);\n        wgmma_commit();"
                "\n        wgmma_wait0();",
                "        for (int j = 0; j < NE; ++j) ef[j] = 0.f;")],
    "no_copy": [("        mbar_expect_tx(gfull + 8 * ks, gbytes);\n        bulk_g2s(",
                 "        mbar_arrive(gfull + 8 * ks);\n        if (false) bulk_g2s(")],
    "no_d": [("    if (p.d == nullptr) continue;", "    continue;")],
}
EDITS["sync_only"] = EDITS["no_mma"] + EDITS["no_copy"]


def _build_variant(name: str) -> Path:
    from range_tpu_torch.kernels._build import NVCC_FLAGS, _nvcc

    src = (CSRC / "hier_scan_tf32_sm90.cu").read_text()
    for old, new in EDITS[name]:
        if old not in src:
            raise RuntimeError(f"{name}: edit target not found: {old[:50]!r}")
        src = src.replace(old, new)
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    for h in CSRC.glob("*.cuh"):
        (d / h.name).write_text(h.read_text())
    (d / "hier_scan_tf32_sm90.cu").write_text(src)
    lib = d / "lib.so"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(d / "hier_scan_tf32_sm90.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{proc.stderr}")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_tf32_ablate: no CUDA device", file=sys.stderr)
        return 1
    from range_tpu_torch.kernels import _build
    from range_tpu_torch.ops import retrieval_hier as rh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with ThreadPoolExecutor(len(EDITS)) as pool:
        libs = dict(zip(EDITS, pool.map(_build_variant, EDITS)))
    sig = _build._SIGNATURES["hier_scan_tf32_sm90"]

    def load(path):
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in sig.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        return lib

    loaded = {k: load(v) for k, v in libs.items()}
    real = _build.load_kernel_library
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    Bp, cat_d, T = 10_112, 384, 224

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    gg = torch.zeros(T * 8, 128, device=dev)
    gg[:, :3] = rnd(T * 8, 3)
    cases = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        q = rnd(Bp, cat_d, scale=0.5).to(dt)
        gt = rnd(T * 64, 256, scale=0.05).to(dt)
        cases[f"stats {tag} (14,336 + 1,792 groups)"] = (
            (q, gt, gg.to(dt), None, None), dict(gpt_s=64, gpt_g=8))
    q = rnd(Bp, cat_d, scale=0.5)
    cases["scan f32 (7,168 x 384 + 1,792 x 512)"] = (
        (q, rnd(T * 32, 256, scale=0.05), gg, rnd(T * 32, 384), rnd(T * 8, 512)),
        dict(gpt_s=32, gpt_g=8))
    for tag, (args, kw) in cases.items():
        ms = {}
        for turn in range(3):
            for name, lib in loaded.items():
                _build.load_kernel_library = functools.lru_cache(None)(
                    lambda n, lib=lib: lib if n == "hier_scan_tf32_sm90" else real(n))
                fn = functools.partial(rh._scan_tf32, *args, **kw)
                fn()
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(5):
                    fn()
                end.record()
                end.synchronize()
                ms.setdefault(name, []).append(start.elapsed_time(end) / 5)
        print(f"{tag}: " + ", ".join(f"{k} {statistics.mean(v):.4f} ms" for k, v in ms.items()))
    _build.load_kernel_library = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
