"""Kernels 8 and 9 on `csrc/hier_scan_tf32_sm90.cu`, checked and timed
beside their first bodies on one card.

Builds the informative 100,000-row bank (seed 0, padded to 4,096 rows, bf16
values) and its HierBanks as chip_smoke.py does: the flagship's knobs at
the `exact`, `fast` and `high` tiers, the tail_super flagship and the JAX
defaults (bn 512, gsz_sem 8, gsz_geo 64, no knobs) at `exact`.  Queries: the
flagship RANGE+ tower's embeddings of random coordinates (seed 0), packed
and sorted as the serving path does.  At each batch of ``--batches``, each
form:
  * the scan at `exact`: the flagship (sem + geo, and the sem family alone
    as RANGE runs it), the defaults' 1,152-column tails, the tail_super
    bank's supergroup tail (sup_r 4);
  * the stats scan: hier_topk's operand (g_topk_cat) at `exact`, `fast`
    and `high` (768 columns), and g_sem_cat at `exact`;
runs the new body (`_scan_tf32`) once and holds it against its plain
version (`_scan_tf32_plain`: the stats to 1e-5 of their magnitude, the tails
to 1e-4 x the sum of their terms' magnitudes + 1e-6) and against the
one-pass plain version (`_hier_scan_plain` / `_hier_scan_stats_plain`: the
same bars as chip_smoke.py's); then times it in turns (new, old, old, new;
CUDA events over 5 calls a turn) beside the first body of the form
(`_scan_cores` at f32, `_scan_stats_mma_sync` at bf16), and with ``--parts``
the scan's logits alone (its stats pass over the same operands).  Prints
the card's name and power limit first, and the new source's ptxas lines.

    PYTHONPATH=. python3 tools/torch_scan_tf32.py [--batches 1,37,1000,10000] [--parts]

Needs a CUDA card and nvcc.
"""

import argparse
import statistics
import subprocess
import sys
import time

import torch

HOLD_TAIL = 1e-4  # x the sum of the terms' magnitudes, + 1e-6 (chip_smoke's _hold_cores)


def _turns(fns: dict, order, calls: int = 5) -> dict:
    """Device ms a call of each named fn, timed in ``order`` on CUDA
    events (each turn `calls` calls back to back after a warm-up)."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    ms = {}
    for name in order:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(calls):
            fns[name]()
        end.record()
        end.synchronize()
        ms.setdefault(name, []).append(start.elapsed_time(end) / calls)
    return {k: statistics.mean(v) for k, v in ms.items()}


def _hold(tag: str, got, ref, mag=None, stats_rel: float = 1e-5) -> float:
    """Largest error over its bar: m and s within stats_rel of the larger
    of |ref| and 1; tails by the terms' bar."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        if a is None:
            continue
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"{tag} output {i}: shape {tuple(a.shape)} or non-finite")
        if mag is not None and i == len(got) - 1:
            r = ((a - b).abs() / (HOLD_TAIL * mag + 1e-6)).max().item()
        else:
            r = ((a - b).abs() / (stats_rel * b.abs().clamp_min(1.0))).max().item()
        worst = max(worst, r)
    return worst


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_scan_tf32: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", default="37,10000")
    ap.add_argument("--parts", action="store_true")
    args = ap.parse_args()
    from range_tpu_torch import GeoBank, load_model
    from range_tpu_torch.api import SERVING_PROFILES
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.kernels._build import build_kernel
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    _, secs, log = build_kernel("hier_scan_tf32_sm90")
    print(f"nvcc hier_scan_tf32_sm90: {secs:.1f} s")
    for line in log.splitlines():
        if any(k in line for k in ("spill", "registers", "C75", "arning", "rror")):
            print("  " + line.strip())
    for name in ("hier_cores", "hier_scan_stats"):
        build_kernel(name)
    print(f"builds: {time.perf_counter() - t0:.1f} s")

    dev = torch.device("cuda")
    prof = SERVING_PROFILES["flagship"]
    knobs = dict(lr_rank=prof["lr_rank"], lr_geo=prof["lr_geo"], res_rank=prof["res_rank"],
                 topk_gsz=prof["topk_gsz"])
    bank = GeoBank.synthetic_informative(0, 100_000, pad_to=4096, value_dtype=torch.bfloat16,
                                         device=dev)
    banks = {tier: rh.build_hier_bank(bank, bn=512, gsz_sem=prof["gsz_sem"], gsz_geo=64,
                                      tier=tier, **knobs)
             for tier in ("exact", "fast", "high")}
    banks["ts"] = rh.build_hier_bank(bank, bn=512, gsz_sem=prof["gsz_sem"], gsz_geo=64,
                                     tail_super=64, tier="exact", **knobs)
    banks["defaults"] = rh.build_hier_bank(bank, bn=512, gsz_sem=8, gsz_geo=64, tier="exact")
    enc = load_model("RANGE+", db_path=banks["fast"], profile="flagship")
    gen = torch.Generator(device=dev).manual_seed(0)
    n = max(int(b) for b in args.batches.split(","))
    lon = torch.rand(n, generator=gen, device=dev) * 360 - 180
    lat = torch.rad2deg(torch.asin(torch.rand(n, generator=gen, device=dev) * 2 - 1))
    coords = torch.stack([lon, lat], 1)
    with torch.no_grad():
        q_all = enc.model.query_embedding(coords).float()
    x_all = lonlat_deg_to_xyz(coords)

    for b in (int(v) for v in args.batches.split(",")):
        bm = enc.model.config.hier_plan(b)[0]
        q_s, q_x = rh._pad_queries(q_all[:b], x_all[:b], bm)
        order = rh._hybrid_order(q_x, b)

        def packed(h):
            return rf.pack_queries(q_s, q_x, 12.0, 40.0, h.tier)[order].contiguous()

        cases = []
        for key in ("exact", "defaults", "ts"):
            h = banks[key]
            qc = packed(h)
            gs, gg = h.bn // h.gsz_sem, h.bn // h.gsz_geo
            if key == "ts":
                sa = (qc, h.g_sem_cat, h.g_geo_cat, h.g_sem_ts_vw, h.g_geo_vw_lr)
                cases.append((f"scan {key} sup_r 4", sa, dict(gpt_s=gs, gpt_g=gg, sup_r=4)))
                continue
            lr = key == "exact"
            sa = (qc, h.g_sem_cat, h.g_geo_cat, h.g_sem_vw_lr if lr else h.g_sem_vw,
                  h.g_geo_vw_lr if lr else h.g_geo_vw)
            cases.append((f"scan {key}", sa, dict(gpt_s=gs, gpt_g=gg)))
            if lr:
                cases.append((f"scan {key} has_geo=False", sa,
                              dict(gpt_s=gs, gpt_g=gg, has_geo=False)))
        for key in ("exact", "fast", "high"):
            h = banks[key]
            qc = packed(h)
            gg = h.bn // h.gsz_geo
            cases.append((f"stats {key} g_topk_cat", (qc, h.g_topk_cat, h.g_geo_cat, None, None),
                          dict(gpt_s=h.bn // h.topk_gsz, gpt_g=gg)))
            if key == "exact":
                cases.append((f"stats {key} g_sem_cat", (qc, h.g_sem_cat, h.g_geo_cat, None,
                                                        None),
                              dict(gpt_s=h.bn // h.gsz_sem, gpt_g=gg)))
        for tag, sa, kw in cases:
            tails = sa[3] is not None
            with torch.no_grad():
                got = rh._scan_tf32(*sa, **kw)
                torch.cuda.synchronize()
                mine = rh._scan_tf32_plain(*sa, **kw)
                if tails:
                    mag_args = (sa[0], sa[1], sa[2], sa[3].abs(), sa[4].abs())
                    ref = rh._hier_scan_plain(*sa, **kw)
                    ref = tuple(r for r in ref if r is not None)
                    mag = rh._hier_scan_plain(*mag_args, **kw)[-1]
                    mag_t = rh._scan_tf32_plain(*mag_args, **kw)[-1]
                else:
                    ref = rh._hier_scan_stats_plain(*sa[:3], **kw)
                    mag = mag_t = None
            e_t = _hold(tag, got, mine, mag_t)
            e_r = _hold(tag, got, ref, mag, stats_rel=1e-4)
            f32 = any(t is not None and t.dtype == torch.float32 for t in sa)
            fns = {"new": lambda: rh._scan_tf32(*sa, **kw)}
            if f32:
                fns["old"] = lambda: rh._scan_cores("f32", *sa, **kw)
            elif rh._stats_smem(max(sa[1].shape[1], sa[2].shape[1])) <= rh._SM90_MAX_SMEM:
                fns["old"] = lambda: rh._scan_stats_mma_sync(*sa[:3], **kw)
            else:
                fns["old"] = lambda: rh._scan_cores("deep", *sa, **kw)
            if args.parts and tails:
                fns["logits"] = lambda: rh._scan_tf32(*sa[:3], None, None, gpt_s=kw["gpt_s"],
                                                      gpt_g=kw["gpt_g"])
            order = ["new", "old", "old", "new"] + (["logits", "logits"] if "logits" in fns
                                                    else [])
            with torch.no_grad():
                ms = _turns(fns, order)
            fams = rh._scan_tf32_fams(*sa, **kw)
            segs = [rh._scan_tf32_plan(fm, sa[0].shape[0])[1] for fm in fams]
            print(f"B={b} {tag}: Bp {sa[0].shape[0]}, widths "
                  f"{[tuple(t.shape) for t in sa[1:] if t is not None]}, segments {segs}; "
                  f"err/bar vs its plain {e_t:.3e}, vs the one-pass plain {e_r:.3e}; "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
            if e_t > 1.0 or e_r > 1.0:
                raise AssertionError(f"B={b} {tag}: error over its bar")
    return 0


if __name__ == "__main__":
    sys.exit(main())
