"""The `exact` tier's hierarchical paths on one card, traced: where the time
goes, for comparing two checkouts.

Builds the informative 100,000-row bank (seed 0, padded to 4,096 rows, bf16
values) and its flagship HierBank at the `exact` tier on the card, as
chip_smoke.py does, and a HierBank at the JAX defaults (bn 512, gsz_sem 8,
gsz_geo 64, no knobs); then at B = 10,000 (random coordinates from seed 0):
  * serves RANGE and RANGE+ (``profile="flagship"``) and RANGE+ at the JAX
    defaults (``retrieval="hier"``) through `load_model`: host ms (the
    median of 5 calls, each ending in a synchronize) and a torch.profiler
    trace of 3 calls: device busy, idle share, the kernels with the most
    device time;
  * kernel 15 alone at RANGE's selection (`_hier_parts_call`, lr, the sem
    family), traced the same way: the device time of each kernel it runs.
Run it from each checkout's root in turns (A, B, B, A) in one sitting on
the card, each with its own package on the path:

    PYTHONPATH=. python3 tools/torch_exact_trace.py LABEL

Needs a CUDA card and nvcc.  Prints the card's name and power limit first.
"""

import statistics
import subprocess
import sys
import time

import torch


def _trace(tag: str, fn, calls: int = 3) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        span = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end
                                                          - e.time_range.start) / 1e3
    busy = sum(by_name.values())
    if not busy:
        print(f"{tag}: the profiler recorded no device time (not measured)")
        return
    print(f"{tag}: {calls} calls, host span {span / calls:.3f} ms a call, device busy "
          f"{busy / calls:.3f} ms a call, idle share {1 - busy / span:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"  {ms / calls:9.4f} ms/call  {100 * ms / busy:6.2f}%  {name[:100]}")


def _host_ms(fn, reps: int = 5) -> float:
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_exact_trace: no CUDA device", file=sys.stderr)
        return 1
    from range_tpu_torch import GeoBank, load_model
    from range_tpu_torch.api import SERVING_PROFILES
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    label = sys.argv[1] if len(sys.argv) > 1 else ""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[{label}] {smi.strip()}; range_tpu_torch from {rh.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    prof = SERVING_PROFILES["flagship"]
    bank = GeoBank.synthetic_informative(0, 100_000, pad_to=4096, value_dtype=torch.bfloat16,
                                         device=dev)
    hb = rh.build_hier_bank(bank, bn=512, gsz_sem=prof["gsz_sem"], gsz_geo=64,
                            lr_rank=prof["lr_rank"], lr_geo=prof["lr_geo"],
                            res_rank=prof["res_rank"], topk_gsz=prof["topk_gsz"], tier="exact")
    g = torch.Generator(device=dev).manual_seed(0)
    B = 10_000
    coords = torch.stack([torch.rand(B, generator=g, device=dev) * 360 - 180,
                          torch.rand(B, generator=g, device=dev) * 180 - 90], 1)
    encs = {"RANGE flagship": load_model("RANGE", db_path=hb, profile="flagship", tier="exact"),
            "RANGE+ flagship": load_model("RANGE+", db_path=hb, profile="flagship",
                                          tier="exact"),
            "RANGE+ at the JAX defaults": load_model("RANGE+", db_path=bank, retrieval="hier",
                                                     tier="exact")}
    with torch.no_grad():
        for name, enc in encs.items():
            ms = _host_ms(lambda: enc(coords))
            print(f"[{label}] exact {name} B={B}: {ms:.3f} ms end to end (host, median of 5)")
            _trace(f"[{label}] exact {name}", lambda: enc(coords))
        cfg = encs["RANGE flagship"].model.config
        bm, k_tiles, _, j_sem = cfg.hier_plan(B)
        q = encs["RANGE flagship"].model.query_embedding(coords).float()
        q_s, q_x = rh._pad_queries(q, lonlat_deg_to_xyz(coords), bm)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[rh._hybrid_order(q_x, B)]
        q_cat = q_cat.contiguous()
        gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
        m_s, s_s, _, _ = rh._hier_scan_stats_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat,
                                                   gpt_s=gpt_s, gpt_g=gpt_g)
        idx, _ = rh.select_tiles(m_s, s_s, None, None, t_real=hb.t_real, k_tiles=k_tiles,
                                 bm=bm, n_valid=B, j_sem=j_sem, j_geo=cfg.j_geo, mode="range")
        args = (q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx, hb.g_sem_cat,
                hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw)
        kw = dict(sem_d=hb.sem_d, bm=bm, bn=hb.bn, gpt_s=gpt_s, gpt_g=gpt_g, lr=True, geo=False)
        _trace(f"[{label}] kernel 15 lr at RANGE's selection (K={idx.shape[1]}, bm={bm})",
               lambda: rh._hier_parts_call(*args, **kw))
    return 0


if __name__ == "__main__":
    sys.exit(main())
