"""The two-level paths and the dense path at the `exact` and `high` tiers on
one card, traced: where the time goes, for comparing two checkouts.

Builds the informative 100,000-row bank (seed 0, padded to 4,096 rows, bf16
values) and, at each of `exact` and `high`, its two-level HierBank as
chip_smoke.py does (bn 512, gsz_sem 8, gsz_geo 64, gsz_super 64); then at
B = 10,000 (random coordinates from seed 0):
  * the two-level feature path, `load_model("RANGE+", retrieval="hier",
    gsz_super=64, tier=...)`, and the two-level top-k endpoint
    (`hier_topk`, K = 48 of M = 96 refined tiles, the feature path's query
    embeddings);
  * at `exact`, dense RANGE+ (`load_model("RANGE+", db_path=bank,
    tier="exact")`);
each: host ms (the median of 5 calls, each ending in a synchronize) and a
torch.profiler trace of 3 calls: device busy, idle share, the kernels with
the most device time.  Run it from each checkout's root in turns (A, B, B,
A) in one sitting on the card, each with its own package on the path:

    PYTHONPATH=. python3 tools/torch_two_level_trace.py LABEL

Needs a CUDA card and nvcc.  Prints the card's name and power limit first.
"""

import subprocess
import sys

import torch
from torch_exact_trace import _host_ms, _trace


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_two_level_trace: no CUDA device", file=sys.stderr)
        return 1
    from range_tpu_torch import GeoBank, load_model
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval_hier as rh

    label = sys.argv[1] if len(sys.argv) > 1 else ""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{label}] {smi.strip()}; range_tpu_torch from {rh.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    bank = GeoBank.synthetic_informative(0, 100_000, pad_to=4096, value_dtype=torch.bfloat16,
                                         device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    B = 10_000
    coords = torch.stack([torch.rand(B, generator=g, device=dev) * 360 - 180,
                          torch.rand(B, generator=g, device=dev) * 180 - 90], 1)
    x = lonlat_deg_to_xyz(coords)
    with torch.no_grad():
        for tier in ("exact", "high"):
            hb = rh.build_hier_bank(bank, bn=512, gsz_sem=8, gsz_geo=64, gsz_super=64,
                                    tier=tier)
            enc = load_model("RANGE+", db_path=hb, retrieval="hier", gsz_super=64, tier=tier)
            q = enc.model.query_embedding(coords).float()
            runs = {"two-level feature path": lambda: enc(coords),
                    "two-level hier_topk K=48 M=96": lambda: rh.hier_topk(
                        q, x, hb, k_tiles=48, m_tiles=96)}
            if tier == "exact":
                dense = load_model("RANGE+", db_path=bank, tier="exact")
                runs["dense RANGE+"] = lambda: dense(coords)
            for name, fn in runs.items():
                ms = _host_ms(fn)
                print(f"[{label}] {tier} {name} B={B}: {ms:.3f} ms end to end (host, median "
                      "of 5)")
                _trace(f"[{label}] {tier} {name}", fn)
            del hb, enc, runs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
