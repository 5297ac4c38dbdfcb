"""Smoke run of range_tpu_torch on one CUDA card.

Builds the port's sixteen CUDA kernels (and their variants: the scan's
segment-sum and wide-tail forms, the merged parts kernel without lr, the
family parts kernel's plain / lr / rr shapes and their sel and dedup_pad
forms, the refine kernel's has_parts form, the combine without lr_geo,
the int8 forms of the parts and pruned kernels, and kernel 2's two bodies:
the Hopper kernel of its bf16 tiers and the mma.sync body of its f32 tier)
from the eighteen sources of `range_tpu_torch/csrc/` (one nvcc per source,
all started together), holds each against its plain PyTorch version at the
main paths' shapes, prints the tower's bf16 mode on its Hopper body
(`csrc/siren_tower_sm90.cu`, wgmma; its ptxas log held to no spill and no
serialized wgmma) beside `csrc/siren_tower.cu`'s bf16 form (launched here
alone as the same-run yardstick) and kernel 16 (the combine, flagship rg
> 0 and rg = 0) on its Hopper body (`csrc/combine_cat_sm90.cu`, three TF32
products) beside its f32 body (`csrc/combine_cat.cu`, the exact tier's
route) at B = 1, 37, 1,000 and 10,000 in turns, with the bound and share of
each, prints kernel 2's Hopper kernel's drift for each length
of its accumulation chain and its time beside the mma.sync body's at B = 1,
37, 1,000 and 10,000, kernels 3 (int8 codes) and 5 (the partials, bf16 and
int8) on the same Hopper kernel beside their mma.sync body's entry points
(launched here alone as the same-run yardstick) at the same batches with
their bound and share and the drift of each segment length, kernel 8's
Hopper kernel (the scan) at each scan
shape of the paths with its bound, its share of it and the floor of its
exponentials (the flagship also at B = 1 and 37), its drift for each chain
length and its wide tail in two slices against three, and kernel 14's rr
shapes on their Hopper kernel beside their mma.sync body
(`csrc/hier_parts_family.cu`, built and launched here alone as the
same-run yardstick) at each rr shape of the paths (the flagship's two
families at B = 1, 37, 1,000 and 10,000, the tail_super flagship, the
rr-only knob bank, sel_lr=64, dedup=2, the rescue's re-run, gsz_sem=4)
with the same bound, share and floor, and its drift for each segment
length, and kernel 15 (the merged parts kernel) and kernel 14's value
shapes on their Hopper body (`csrc/hier_parts_sm90.cu`) beside their
mma.sync body (`csrc/hier_parts.cu`, launched here alone as the same-run
yardstick) at B = 1, 37, 1,000 and 10,000: kernel 15 lr at the RANGE
flagship and plain at the JAX defaults, bf16 and int8 values, kernel 14's
plain and lr shapes (both families), sel and dedup_pad forms, each with
its bound and share and (kernel 15) the drift of each segment length,
and kernels 10 and 11 (the top-k endpoint's argmax and k-carry) on their
Hopper body (`csrc/hier_argmax_sm90.cu`, its ptxas log held to no spill
and no serialized wgmma) beside their mma.sync body (`csrc/hier_argmax.cu`,
launched here alone as the same-run yardstick) at B = 1, 37, 1,000 and
10,000, each batch its own `hier_topk` request at k = 1 and 8, with its
bound, share and (B = 1,000, 10,000) the time of each segment count
(same-run times on CUDA events), then
drives the serving paths at full width (SatCLIP SH-L40 -> SIREN
1600->256->256->256 tower, 100,000-row bank with 256-d keys and bf16
1024-d values, 1,280-d output) and the training path:

  * the dense path, RANGE+ and RANGE over a `synthetic_device` bank, and
    RANGE+ with ``value_quant="int8"`` (the int8 kernel);
  * the hierarchical flagship path, RANGE+ with ``profile="flagship"``
    over the informative bank, whose HierBank is built on the card here;
  * hierarchical RANGE with ``profile="flagship"`` over the same HierBank
    (the geo-less scan and the merged parts kernel), and both flagship
    models over the bank's int8 HierBank;
  * the top-k endpoint `hier_topk` (k = 1 and 8), the `hier_nn` harness
    and `retrieve_hier(sort="hybrid")` over that HierBank, with the
    tower's query embeddings;
  * the flagship with the weighted-supergroup sem tail (``tail_super=64,
    m_corr=32``: the scan's segment-sum variant and the correction kernel)
    over the bank's tail_super HierBank, and the two-level top-k endpoint
    (gsz_super 64, K=48 of M=96 refined tiles: the refine kernel) over
    its two-level HierBank, both built on the card here;
  * the general one-level path (`load_model(retrieval="hier")` at the JAX
    defaults, bn 512, gsz_sem 8, gsz_geo 64 and no lr_rank / res_rank /
    lr_geo: the wide-tail scan and the merged parts kernel's plain
    variant), RANGE+ and RANGE, bf16 and int8, and one request for each of
    the lr, rr, lr + rr, k_geo-without-rr and lr + lr_geo banks (kernel
    14's plain / lr / rr shapes, the combine without lr_geo), all built on
    the card here;
  * the dense path on a device mesh: a world-size-1 NCCL process group (a
    FileStore in a temporary directory), `load_model(..., mesh=
    make_mesh((1, 1)))` RANGE+ (bf16, int8) and RANGE through the parts
    kernel, and the parts kernel's sum over 4 row slabs against the dense
    kernel (the cross-shard combine);
  * banks of groups of 4 rows (128 groups a tile): `load_model("RANGE+" |
    "RANGE", retrieval="hier", gsz_sem=4)` at the JAX defaults otherwise,
    and RANGE+ over one with the flagship's lr_rank / res_rank / lr_geo;
  * banks that kernel 14's rr shapes refused before (20,000 rows, the
    flagship's knobs): 96-row tiles of 12-row groups (a masked last step)
    and 3-row sem groups at bn 384 (128 a tile: the DIRECT walk), RANGE+
    and RANGE at B = 1,000 and 10,000, and kernel 14 at each; and the
    banks the rr shapes refused until this slice, odd group sizes at an odd
    multiple of 32 groups a tile (288-row tiles of 3-row groups, 96-row
    tiles of 1-row groups, 480-row tiles of 3-row groups; 8 geo groups a
    tile), the same way;
  * the rest of hierarchical serving over the informative bank: the
    flagship with ``sel_lr=64`` (and ``topk_lr=64``: hier_topk over the
    rank-64 selection sketch), with ``dedup=2``, and with the adaptive
    rescue (``adaptive_frac=0.05, adaptive_mult=3``, also on the
    tail_super flagship); the sel and dedup_pad forms also in kernel 14's
    lr shape (the bank without res_rank); and the two-level feature path,
    `load_model("RANGE+" | "RANGE", retrieval="hier", gsz_super=64)` over
    the JAX-defaults bank's two-level HierBank (M = 48);
  * pruned and hybrid dense retrieval over the informative bank clustered
    at bn 1,024 (padded packing): `retrieve_pruned` (RANGE+, RANGE, and a
    small int8 request) and `retrieve_hybrid` at bm 256;
  * hierarchical banks at the `exact` and `high` tiers (f32 operands;
    768 semantic columns), served by the CUDA-core body
    `csrc/hier_cores.cu` (`tiers_phases`): for each tier the informative
    bank's flagship, tail_super and two-level HierBanks built on the card,
    each of its forms of kernels 8, 9 and 12-15 against its plain version
    and timed beside it, RANGE+ and RANGE with ``profile="flagship"``,
    hier_topk (recall pooled over five batches), RANGE+ at the JAX
    defaults, the tail_super flagship and the two-level feature path and
    top-k, each request's launches counted; and JAX's exactness check at
    its test bank's shape (the exact tier with f32 values, every tile
    selected, against the exact dense answer);
  * SatCLIP contrastive training of the full-width SatCLIP-ResNet18-L40
    dual tower (ResNet-18 on 13 x 256 x 256 images, the SH-L40 SIREN
    location tower, embed 256): two AdamW steps of 16 accumulated
    micro-batches of 512, the SH-times kernel once per micro-batch;

and checks the answers against the exact f32 retrieval (the RANGE+
flagship's, with and without tail_super, against its fidelity bars:
relerr mean <= 0.04, p99 <= 0.165; RANGE's mean <= 0.10; int8 against bf16
mean < 0.01; RANGE+ at the JAX defaults and each knob subset mean <= 0.12
(`tests/test_hier.py:167`), RANGE there mean <= 0.10, the same bars on the
gsz_sem=4 banks and the banks of the refused shapes (both kinds); hier_topk's
recall@1 against the f32 `exact_nn` >= 0.999 at B = 10,000 and 1,000, the
two-level endpoint's at least the one-level selection's over the same
bank - 0.001; at each of the `exact` and `high` tiers the same flagship,
RANGE, hier_topk, defaults and tail_super bars, the two-level feature
path's mean <= 0.12 and its top-k's recall@1 >= 0.99, and the exact tier's
all-tiles answer within 1e-4 max relerr of the exact dense one; sel_lr's relerr mean within the flagship's + 0.02 and
dedup's within 1.02 x the flagship's on the same coordinates, topk_lr's
pooled recall@1 within 0.02 of the full selection operand's, the rescue's
untouched rows bit-identical to the rescue-off answer and its per-query
error max no higher (its p99 and the rescued rows' mean are printed),
the two-level feature path's relerr mean
<= 0.12 (RANGE+) and 0.10 (RANGE); the mesh's answers within 1e-3 x row
max of one card's; the
pruned and hybrid paths within |d| / max(|ref|, 0.1) < 5e-3 of the dense
kernel over the same rows; training's
losses finite and falling, one micro-step by the kernel route within 1e-5
of the plain route's loss, both autograd Functions' gradients on the plain
compose).  Every phase that fails raises.

    python3 chip_smoke.py

Prints the card's name and power limit, build logs, per-kernel errors and
times, one JSON line with the kernels (time, plain time, bound, launches on
the main path, largest error and largest error over its tolerance), and as
its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Exits non-zero, without that line, when there is no CUDA device.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

BANK_ROWS = 100_000
PAD_TO = 4096
BATCH = 10_000
SMALL_BATCH = 1_000
REQUESTS = (1, 37, 1_000, BATCH)
L, WIDTH = 40, 256
# kernel sources (one library each), and the kernels of the JSON line:
# (name, source, the TPU kernel it replaces)
SOURCES = ("siren_tower_sm90", "siren_tower", "fused_retrieval_sm90", "fused_retrieval",
           "hier_scan_sm90", "hier_parts_family_sm90", "hier_parts_family", "combine_cat_sm90",
           "combine_cat", "hier_scan_stats", "hier_argmax_sm90", "hier_argmax",
           "hier_parts_sm90", "hier_parts", "sh_times", "hier_refine", "hier_corr", "hier_cores")
# sources whose ptxas log must show no spill and no serialized wgmma
# (C7512: too few registers; C7514: issued in a loop or under a condition;
# C7520: divergent code between issue and wait): every kernel of a source
# named, and of the others the kernels whose mangled names match the
# pattern.  The values kernel: its deep instances (logits over 256
# columns); its one-pass int8 instance, <true, false>, spills a few bytes
# (converting a step's codes holds 32 words) and is not held.  The rr
# kernel: every instance but the rare groupings' deep one, <1, true>,
# which spills 4 / 20 bytes at 128 registers a thread (512 threads; the
# units path and the deep walk in one kernel: ROADMAP Queue 2, item 10 (d))
PTXAS_CLEAN = ("hier_argmax_sm90", "siren_tower_sm90", "combine_cat_sm90")
PTXAS_CLEAN_KERNELS = {"hier_parts_sm90": r"hier_parts_sm90_kernelIL[^E]*ELb1E",
                       "hier_parts_family_sm90":
                       r"hier_parts_family_sm90_kernelIL(i[02]ELb[01]E|i1ELb0E)"}
WGMMA_WARNINGS = ("C7512", "C7514", "C7520")
KERNELS = (("siren_tower", "siren_tower", "range_tpu/ops/sh.py:726"),
           # the tower's bf16 mode (the flagship's) on its Hopper body
           ("siren_tower_bf16", "siren_tower_sm90", "range_tpu/ops/sh.py:726"),
           ("fused_retrieval", "fused_retrieval_sm90", "range_tpu/ops/retrieval_pallas.py:123"),
           # kernel 2's 'exact' tier (f32 logits) on the mma.sync body
           ("fused_retrieval_exact", "fused_retrieval", "range_tpu/ops/retrieval_pallas.py:123"),
           ("fused_retrieval_i8", "fused_retrieval_sm90", "range_tpu/ops/retrieval_pallas.py:181"),
           ("hier_scan", "hier_scan_sm90", "range_tpu/ops/retrieval_hier.py:1443"),
           ("hier_parts_family", "hier_parts_family_sm90", "range_tpu/ops/retrieval_hier.py:2282"),
           ("combine_cat", "combine_cat_sm90", "range_tpu/ops/retrieval_hier.py:3102"),
           # kernel 16 at the exact tier, on its f32 body
           ("combine_cat_exact", "combine_cat", "range_tpu/ops/retrieval_hier.py:3102"),
           ("hier_scan_stats", "hier_scan_stats", "range_tpu/ops/retrieval_hier.py:1582"),
           ("hier_argmax", "hier_argmax_sm90", "range_tpu/ops/retrieval_hier.py:1645"),
           ("hier_topk", "hier_argmax_sm90", "range_tpu/ops/retrieval_hier.py:1682"),
           ("hier_parts", "hier_parts_sm90", "range_tpu/ops/retrieval_hier.py:2515"),
           ("sh_times", "sh_times", "range_tpu/ops/sh.py:539"),
           ("hier_refine", "hier_refine", "range_tpu/ops/retrieval_hier.py:2077"),
           ("hier_corr", "hier_corr", "range_tpu/ops/retrieval_hier.py:2209"),
           # the scan's segment-sum (sup_r_s) variant, `:1489-1497` of the kernel
           ("hier_scan_sup", "hier_scan_sm90", "range_tpu/ops/retrieval_hier.py:1443"),
           # the general one-level path's variants: the scan over full-width
           # group sums, kernel 15 without lr, kernel 14's value shapes (plain,
           # lr: on kernel 15's Hopper body) and its rr shape, kernel 16
           # without lr_geo
           ("hier_scan_wide", "hier_scan_sm90", "range_tpu/ops/retrieval_hier.py:1443"),
           ("hier_parts_plain", "hier_parts_sm90", "range_tpu/ops/retrieval_hier.py:2515"),
           ("hier_parts_family_plain", "hier_parts_sm90", "range_tpu/ops/retrieval_hier.py:2282"),
           ("hier_parts_family_lr", "hier_parts_sm90", "range_tpu/ops/retrieval_hier.py:2282"),
           ("hier_parts_family_rr", "hier_parts_family_sm90",
            "range_tpu/ops/retrieval_hier.py:2282"),
           ("combine_cat_rg0", "combine_cat_sm90", "range_tpu/ops/retrieval_hier.py:3102"),
           # kernel 13 over a full-width dvw (tail_super banks without lr_rank)
           ("hier_corr_wide", "hier_corr", "range_tpu/ops/retrieval_hier.py:2209"),
           # the multi-device partials (bf16, int8), the pruned one-family
           # softmax (bf16, int8) and the hybrid kernel
           ("fused_parts", "fused_retrieval_sm90", "range_tpu/ops/retrieval_pallas.py:314"),
           ("fused_parts_i8", "fused_retrieval_sm90", "range_tpu/ops/retrieval_pallas.py:314"),
           ("family_pruned", "fused_retrieval", "range_tpu/ops/retrieval_pallas.py:441"),
           ("family_pruned_i8", "fused_retrieval", "range_tpu/ops/retrieval_pallas.py:441"),
           ("fused_hybrid", "fused_retrieval", "range_tpu/ops/retrieval_pallas.py:660"),
           # the refine kernel's has_parts form (the two-level feature path),
           # kernel 14's sel and dedup_pad forms in their two sources
           ("hier_refine_parts", "hier_refine", "range_tpu/ops/retrieval_hier.py:2077"),
           ("hier_parts_family_sel_rr", "hier_parts_family_sm90",
            "range_tpu/ops/retrieval_hier.py:2282"),
           ("hier_parts_family_sel", "hier_parts_sm90", "range_tpu/ops/retrieval_hier.py:2282"),
           ("hier_parts_family_dedup_rr", "hier_parts_family_sm90",
            "range_tpu/ops/retrieval_hier.py:2282"),
           ("hier_parts_family_dedup", "hier_parts_sm90", "range_tpu/ops/retrieval_hier.py:2282"))
# the forms of the exact tier (f32 operands) and the high tier (logits deeper
# than 256 columns: 768) and the TPU kernels served in them, on the
# CUDA-core body (csrc/hier_cores.cu): each a KERNELS row per form
CORES_FORMS = (("f32", "exact"), ("deep", "high"))
CORES_ROWS = (("hier_scan", "range_tpu/ops/retrieval_hier.py:1443"),
              ("hier_scan_stats", "range_tpu/ops/retrieval_hier.py:1582"),
              ("hier_refine", "range_tpu/ops/retrieval_hier.py:2077"),
              ("hier_corr", "range_tpu/ops/retrieval_hier.py:2209"),
              ("hier_parts_family", "range_tpu/ops/retrieval_hier.py:2282"),
              ("hier_parts", "range_tpu/ops/retrieval_hier.py:2515"))
# the stats scan's deep form runs on its own kernel (its query block and
# group tiles fit shared memory at 768 columns), kernels 14 and 15's on
# their Hopper bodies' deep chains (passes of 256 columns)
DEEP_SOURCES = {"hier_scan_stats": "hier_scan_stats", "hier_parts_family": "hier_parts_family_sm90",
                "hier_parts": "hier_parts_sm90"}
KERNELS += tuple((f"{k}_{form}", DEEP_SOURCES.get(k, "hier_cores") if form == "deep"
                  else "hier_cores", rep) for k, rep in CORES_ROWS for form, _ in CORES_FORMS)
# the second bodies of the tower and the combine, each counted within its
# wrapper's launches: (its counter, the wrapper's)
VARIANTS = (("siren_tower_bf16", "siren_tower"), ("combine_cat_exact", "combine_cat"))
TOPK_K = 48  # the endpoint's tile budget, bench.py:150
# the two-level top-k (tools/r3_time1.py:103,127: gsz_super 64, K=48 of M=96)
# and the tail_super flagship (tools/r4_tsuper.py: "ts64 K32/m32/kg16")
GSZ_SUPER, TOPK_M = 64, 96
TAIL_SUPER, M_CORR = 64, 32
TS_M_CORR = 16  # a tail_super bank without lr_rank at the JAX defaults' k_tiles 16
# SatCLIP pretraining (configs/default.yaml:16-32, main_old.py:129): micro-batch
# 512, 16 accumulated, 13-band 256 x 256 patches (range_tpu/data/s2geo.py:4-6)
TRAIN_MICRO, TRAIN_ACCUM, TRAIN_STEPS = 512, 16, 2
IMAGE = (13, 256, 256)
RECALL_BAR = 0.999  # bench.py:190
# a bank of keys wider than 256 columns (hier_topk's passes of 128 a step)
WIDE_KEY_DIM, WIDE_ROWS = 512, 20_000

# H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bounds below
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
# real columns of the fast tier's geo block (hi/lo cross terms; the packed
# operands pad them to 128, `retrieval_fused.packed_dims`)
GEO_COLS = 9


def _cuda_ms(fn, reps: int) -> float:
    """Median device milliseconds of fn() from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _host_ms(fn, reps: int) -> float:
    """Median host-clock milliseconds of fn() ending in a synchronize."""
    times = []
    for i in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _bound(n_bytes: float, flops: float, peak: float, *more):
    """(least ms, what bounds it): the larger of bytes over the memory rate
    and operations over the peak rate of their type; ``more`` adds (flops,
    peak) pairs of operations of other types."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = sum(f / pk for f, pk in ((flops, peak),) + more) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _compare(name: str, got: torch.Tensor, ref: torch.Tensor, atol: float,
             rtol: float, why: str, rows_off_max: int | None = None):
    """Print and assert |got - ref| <= atol + rtol |ref| elementwise and, when
    given, that at most rows_off_max rows hold any error above 1e-4.
    Returns (max abs error, the largest error over its tolerance)."""
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs()
    max_abs = err.max().item()
    max_rel = (err / ref.abs().clamp_min(1e-6)).max().item()
    ratio = (err / (atol + rtol * ref.abs()).clamp_min(1e-30)).max().item()
    rows_off = (err > 1e-4).any(dim=1).sum().item()
    limit = "" if rows_off_max is None else f", at most {rows_off_max} rows off by > 1e-4"
    print(f"{name}: max_abs_err {max_abs:.3e}  mean_abs_err {err.mean().item():.3e}  "
          f"max_rel_err {max_rel:.3e}  err/tol {ratio:.3e}  rows off by > 1e-4: "
          f"{rows_off} of {err.shape[0]}  (tolerance atol {atol:.3g} + rtol "
          f"{rtol:g}*|ref|{limit}: {why})")
    if ratio > 1.0 or (rows_off_max is not None and rows_off > rows_off_max):
        raise AssertionError(f"{name}: error {ratio:.3f}x its tolerance or "
                             f"{rows_off} rows off")
    return max_abs, ratio


def _compare_terms(name: str, got: torch.Tensor, ref: torch.Tensor,
                   mag: torch.Tensor, why: str, frac: float = 4e-3,
                   rows_off_max: int = 0):
    """Print and assert |got - ref| <= min(frac * max_row |ref|, 2^-7 * mag)
    + 1e-6 elementwise, with mag each element's sum of its terms' magnitudes
    (the plain version over |operands|).  One bf16 ulp (<= 2^-7) of every
    term holds each element to its own terms, so low-rank columns far below
    their row's largest value are held as tightly as their own size; the
    row cap keeps it no looser than frac of the row's largest value where
    terms cancel.  A weight within ~1e-6 of a bf16 rounding boundary that
    rounds the other way moves its element by one ulp of that term, up to
    2^-7 of it, which exceeds the row cap where that one term is over half
    the row's largest value: up to ``rows_off_max`` rows may hold such
    elements, each within 2^-7 * mag (the dense kernel's allowance for the
    same flips).  Also prints each column's scale (the RMS over rows of
    |ref| / the row's max |ref|): smallest over the nonzero columns, median.
    Returns (max abs error, the largest error over its tolerance: the
    allowance's in the rows it covers)."""
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite")
    err = (got - ref).abs()
    row = ref.abs().amax(dim=1, keepdim=True)
    flip = 2.0 ** -7 * mag + 1e-6
    tol = torch.minimum(frac * row, flip - 1e-6) + 1e-6
    over = (err > tol).any(dim=1)
    n_over = int(over.sum())
    if n_over <= rows_off_max:
        tol = torch.where(over[:, None], flip, tol)
    ratio = (err / tol).max().item()
    col = (ref / row.clamp_min(1e-30)).pow(2).mean(dim=0).sqrt()
    col = col[col > 0]
    cols = (f"min {col.min().item():.3e}, median {col.median().item():.3e} over "
            f"{col.numel()} nonzero columns" if col.numel() else "no nonzero column")
    print(f"{name}: max_abs_err {err.max().item():.3e}  err/tol {ratio:.3e}  "
          f"max err / row scale {(err / row.clamp_min(1e-30)).max().item():.3e}  "
          f"column scale / row max: {cols}  "
          f"rows over the row cap: {n_over} (at most {rows_off_max}, each within 2^-7 x "
          f"sum |terms|)  (tolerance min({frac:g} x max_row |ref|, 2^-7 x sum |terms|): "
          f"{why})")
    if ratio > 1.0:
        raise AssertionError(f"{name}: error {ratio:.3f}x its tolerance")
    return err.max().item(), ratio


def _sh_times_plans(coords: torch.Tensor, L: int, w0: torch.Tensor, ref: torch.Tensor):
    """Kernel 4's launch alone (no fold, no wrapper, not counted) under other
    plans beside the one `sh_times_plan` picks: NC column slices x KS runs of
    the recurrence rows.  (1, 1) at B=512 and (8, 1) at B=10,000 are the
    kernel's first design (one pass over the rows, columns sliced to fill
    the card).  Each plan's sums are held to the f32 rule of phase 14."""
    import ctypes

    from range_tpu_torch.kernels._build import load_kernel_library
    from range_tpu_torch.ops import sh

    lib = load_kernel_library("sh_times")
    B, D = ref.shape
    dev = coords.device
    wc, ws = sh._fold_first_layer(w0, L, "analytic", torch.float32)
    ftabT = sh._fourier_table(L, torch.float32, dev, transposed=True)
    chosen = (ctypes.c_int * 2)()
    if lib.sh_times_plan(B, L, D, ctypes.addressof(chosen)) != 0:
        raise RuntimeError("sh_times_plan failed")
    stream = torch.cuda.current_stream(dev).cuda_stream
    for nc, ks in dict.fromkeys([tuple(chosen), (1, 1), (8, 1), (8, 5), (8, 10), (8, 20)]):
        out = torch.empty(B, D, device=dev)
        work = torch.empty(ks, B, D, device=dev)

        def run():
            rc = lib.sh_times_launch(coords.data_ptr(), ftabT.data_ptr(), wc.data_ptr(),
                                     ws.data_ptr(), out.data_ptr(), work.data_ptr(), B, L, D,
                                     nc, ks, 0, stream)
            if rc != 0:
                raise RuntimeError(f"sh_times launch (NC={nc}, KS={ks}): CUDA error {rc}")

        ms = _cuda_ms(run, 20)
        _compare(f"sh_times plan NC={nc} KS={ks} B={B}", out, ref, 1e-4 / 30, 0.0,
                          "the f32 rule above")
        tag = " (sh_times_plan's)" if (nc, ks) == tuple(chosen) else ""
        print(f"sh_times launch alone, B={B}, NC={nc}, KS={ks}{tag}: {ms:.4f} ms")


def _random_coords(n: int, gen: torch.Generator, dev) -> torch.Tensor:
    lon = torch.rand(n, generator=gen, device=dev) * 360.0 - 180.0
    lat = torch.rad2deg(torch.arcsin(
        torch.rand(n, generator=gen, device=dev) * 2.0 - 1.0))
    return torch.stack([lon, lat], 1)


def _start_build():
    """One nvcc per kernel source, all started together: (pool, jobs,
    start time) for `_build_all`."""
    from range_tpu_torch.kernels._build import build_kernel

    pool = ThreadPoolExecutor(len(SOURCES))
    return pool, [pool.submit(build_kernel, name) for name in SOURCES], time.perf_counter()


def _build_all(pool, jobs, t0):
    """Waits for `_start_build`'s nvcc runs; meanwhile the profiler's
    tracer starts up (its first trace in a process takes seconds, which
    `_trace` would otherwise spend in the first phase that traces)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    built = [job.result() for job in jobs]
    pool.shutdown()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(SOURCES)} sources in parallel")
    for name, (path, seconds, log) in zip(SOURCES, built):
        print(f"build {name}: {seconds:.1f} s -> {path.name}")
        for line in log.splitlines():
            # each kernel's (mangled) name, its registers and spills, and any
            # ptxas warning (C7514 / C7520: wgmma serialized)
            if ("Compiling entry" in line or "registers" in line or "spill" in line
                    or "warning" in line):
                print(f"  ptxas: {line.strip()}")
        if name in PTXAS_CLEAN or name in PTXAS_CLEAN_KERNELS:
            spill = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
            held = re.compile(PTXAS_CLEAN_KERNELS.get(name, ""))
            bad, kernel = [], ""
            for line in log.splitlines():
                if "Compiling entry" in line or "Function properties for" in line:
                    kernel = line
                if (held.search(kernel) or held.search(line)) and (
                        any(code in line for code in WGMMA_WARNINGS)
                        or any(int(n) for m in spill.finditer(line) for n in m.groups())):
                    bad.append(line.strip())
            if bad:
                raise AssertionError(f"ptxas on {name}: spills or serialized wgmma: {bad}")


def _sm90_drift(bank, q, q_xyz, mask, flip_atol) -> None:
    """Kernel 2's Hopper kernel at B=10,000 over the bank's 102,400 rows,
    fast tier, RANGE+, with segments of every length from one chain over
    the whole bank down to 3,200 rows (each block sums its segment through
    wgmma's accumulator).  For each: the largest error and the rows off by
    > 1e-4 against the plain version (the bar: max(2, B / 100) rows); the
    largest error over the mesh phase's cross-shard tolerance (1e-5 x max
    |v| + 1e-5 |kernel 2|) against kernel 5 over 4 row slabs, added; and the largest error over 1e-3 x row max (the mesh
    phase's bar against one card) against the mma.sync body's kernel 2.
    SEG_ROWS_MAX is the longest run that keeps all three."""
    from range_tpu_torch.ops import retrieval_fused as rf

    q_cat = rf.pack_queries(q, q_xyz, 12.0, 40.0, "fast")
    k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, "fast")
    sem_d, N, Dv = bank.key_dim, bank.num_rows, bank.value_dim
    ref = rf._retrieve_fused_plain(q_cat, k_cat, bank.values, mask, 0.5, sem_d=sem_d)
    parts = sum(rf.retrieve_fused_parts(
        q_cat, k_cat[r].contiguous(), bank.values[r].contiguous(), mask[:, r].contiguous(),
        sem_d=sem_d) for r in (slice(i * N // 4, (i + 1) * N // 4) for i in range(4)))
    slabs = 0.5 * (parts[:, :Dv] / parts[:, 2 * Dv:2 * Dv + 1].clamp_min(1e-30)
                   + parts[:, Dv:2 * Dv] / parts[:, 2 * Dv + 1:2 * Dv + 2].clamp_min(1e-30))
    mma = rf._launch_fused("fused_retrieval_launch", q_cat, k_cat, bank.values, None, mask,
                           0.5, sem_d)
    vmax = bank.values.abs().max().item()
    print(f"kernel 2 drift of the Hopper kernel's accumulation chain, B={BATCH}, N={N}, "
          f"fast, RANGE+ (SEG_ROWS_MAX = {rf.SEG_ROWS_MAX}):")
    for seg in (N, 51_200, 25_600, 12_800, 6_400, 3_200):
        plan = rf._segment_plan(BATCH, N, Dv, sem_d, seg_rows_max=seg)
        got = rf._launch_sm90(q_cat, k_cat, bank.values, mask, 0.5, sem_d, plan)
        err = (got - ref).abs()
        slab = ((slabs - got).abs() / (1e-5 * vmax + 1e-5 * got.abs())).max().item()
        one = ((got - mma).abs() / (1e-3 * mma.abs().amax(dim=1, keepdim=True))).max().item()
        ms = _cuda_ms(lambda: rf._launch_sm90(q_cat, k_cat, bank.values, mask, 0.5, sem_d,
                                              plan), 2)
        print(f"  {plan.n_seg} segments of {plan.seg_rows} rows ({plan.seg_rows // 16} k16 "
              f"steps): max_abs_err {err.max().item():.3e} (err/tol "
              f"{err.max().item() / flip_atol:.3e}), rows off by > 1e-4: "
              f"{(err > 1e-4).any(dim=1).sum().item()} (at most {max(2, BATCH // 100)}); "
              f"vs 4 slabs of kernel 5 err/tol {slab:.3e}; vs the mma.sync body err / "
              f"(1e-3 x row max) {one:.3e}; {ms:.3f} ms")


def _sm90_times(bank, q, q_xyz, mask, flip_atol, retr_why) -> None:
    """Kernel 2's bodies side by side, taken in turns (body, kernel, other
    form, other form, kernel, body): at B = 1, 37, 1,000 and 10,000, fast
    tier, RANGE+ and RANGE, the Hopper kernel (its flat form, the one the
    plan takes there), its cluster form and the mma.sync body on bf16
    operands (the body before the Hopper kernel); at B = 1,000 and 10,000,
    high tier, RANGE+, the Hopper kernel (its cluster form, the plan's
    choice there), its flat form and the mma.sync body.  Both forms are held against the
    plain version by the bars above.  At B=10,000, fast, the flat form's
    time per tile beside what one 64-row tile needs of the tensor cores
    and of shared memory."""
    from range_tpu_torch.ops import retrieval_fused as rf

    sem_d0, N, Dv = bank.key_dim, bank.num_rows, bank.value_dim
    for tier, mode, batches in (("fast", "range+", REQUESTS), ("fast", "range", REQUESTS),
                                ("high", "range+", (SMALL_BATCH, BATCH))):
        beta, temp = (0.5, 12.0) if mode == "range+" else (1.0, 15.0)
        k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, tier)
        sem_d = rf.packed_dims(sem_d0, tier)[0]
        for b in batches:
            q_cat = rf.pack_queries(q[:b], q_xyz[:b] if mode == "range+" else None, temp,
                                    40.0, tier)
            plan = rf._segment_plan(b, N, Dv, sem_d)
            other = rf._segment_plan(b, N, Dv, sem_d, form="cluster" if plan.cs == 0 else "flat")

            def run(pl):
                return lambda: rf._launch_sm90(q_cat, k_cat, bank.values, mask, beta, sem_d, pl)

            def old():
                return rf._launch_fused("fused_retrieval_launch", q_cat, k_cat, bank.values,
                                        None, mask, beta, sem_d)

            tag = f"kernel 2 [{tier},{mode}] B={b}"
            ref = rf._retrieve_fused_plain(q_cat, k_cat, bank.values, mask, beta, sem_d=sem_d)
            for pl in (plan, other):
                _compare(f"{tag} {pl} vs plain", run(pl)(), ref, flip_atol, 0.0, retr_why,
                         rows_off_max=max(2, b // 100))
            reps = 10 if b <= 37 else 3
            t = [_cuda_ms(fn, reps) for fn in (old, run(plan), run(other), run(other),
                                                run(plan), old)]
            print(f"{tag}: Hopper kernel {t[1]:.4f} / {t[4]:.4f} ms ({plan}), its "
                  f"{'cluster' if plan.cs == 0 else 'flat'} form {t[2]:.4f} / {t[3]:.4f} ms "
                  f"({other}), mma.sync body {t[0]:.4f} / {t[5]:.4f} ms")
            if (tier, mode, b) == ("fast", "range+", BATCH):
                _sm90_tile_budget(plan, sem_d, b, Dv, min(t[1], t[4]))


def _body_form(q_cat, k_cat, values, scale, mask, sem_d: int, parts: bool):
    """Kernel 3 or 5 on the mma.sync body (`fused_retrieval_i8_launch`,
    `fused_parts_launch` of `csrc/fused_retrieval.cu`, the body before the
    Hopper kernel), launched here alone as the same-run yardstick of
    `_form_times` on bf16 operands: no path of the port reaches it there,
    and it counts nowhere."""
    from range_tpu_torch.ops import retrieval_fused as rf

    if not parts:
        return rf._launch_fused("fused_retrieval_i8_launch", q_cat, k_cat, values, scale, mask,
                                0.5, sem_d)
    B, cat_d = q_cat.shape
    N, Dv = values.shape
    out = torch.empty((B, 2 * Dv + rf.PARTS_PAD), device=q_cat.device)
    rc = rf._lib().fused_parts_launch(
        q_cat.data_ptr(), k_cat.data_ptr(), values.data_ptr(),
        None if scale is None else scale.data_ptr(), mask.data_ptr(), out.data_ptr(), B, N,
        cat_d, sem_d, rf._GEO_D, Dv, 0, rf._stream(q_cat))
    if rc != 0:
        raise RuntimeError(f"fused_parts (mma.sync) launch failed: CUDA error {rc}")
    return out


def _form_times(name: str, bank, q, q_xyz, values, scale, mask, parts: bool, flip_atol,
                why: str) -> None:
    """Kernel 3 (``parts`` False: int8 codes, the blend) or kernel 5
    (``parts``: the partials, bf16 values or int8 codes) on the Hopper
    kernel beside its mma.sync body (`_body_form`), fast tier, RANGE+, at B
    = 1, 37, 1,000 and 10,000: each held against its plain version (kernel
    3 by the dense bars, kernel 5 by `_parts_hold`), then in turns body,
    kernel, kernel, body on CUDA events (`_turns_ms`; neither counted),
    with its bound and share of it; at B = 10,000 the drift of each
    segment length (one chain over the bank down to 3,200 rows) against
    the plain version."""
    from range_tpu_torch.ops import retrieval_fused as rf

    k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, "fast")
    sem_d, N, Dv, n = bank.key_dim, bank.num_rows, bank.value_dim, bank.n_valid
    row_bytes = Dv + 4 + 4 if scale is not None else Dv * 2 + 4

    def hold(tag, got, b, plain):
        if parts:
            return _parts_hold(tag, got, plain, rf._retrieve_fused_parts_plain(
                q_cat, k_cat, values.abs(), mask, scale, sem_d=sem_d), Dv, max(2, b // 100))
        return _compare(tag, got, plain, flip_atol, 0.0, why, rows_off_max=max(2, b // 100))

    for b in REQUESTS:
        q_cat = rf.pack_queries(q[:b], q_xyz[:b], 12.0, 40.0, "fast")

        def new(plan=None):
            return rf._launch_sm90(q_cat, k_cat, values, mask, 0.5, sem_d, plan, scale=scale,
                                   parts=parts)

        def old():
            return _body_form(q_cat, k_cat, values, scale, mask, sem_d, parts)

        plain = (rf._retrieve_fused_parts_plain(q_cat, k_cat, values, mask, scale, sem_d=sem_d)
                 if parts else
                 rf._retrieve_fused_plain(q_cat, k_cat, values, mask, 0.5, scale, sem_d=sem_d))
        plan = rf._segment_plan(b, N, Dv, sem_d, i8=scale is not None)
        tag = f"{name} B={b} {plan}"
        hold(f"{tag} vs plain", new(), b, plain)
        t = _turns_ms((("body", old), ("kernel", new), ("kernel", new), ("body", old)), 3)
        flops = 2 * b * n * (sem_d + GEO_COLS) + 2 * 2 * b * n * Dv
        n_bytes = (b * q_cat.shape[1] * 2 + n * (k_cat.shape[1] * 2 + row_bytes)
                   + b * (2 * Dv + rf.PARTS_PAD if parts else Dv) * 4)
        b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
        print(f"{tag}: Hopper kernel {t['kernel']:.4f} ms, mma.sync body {t['body']:.4f} ms "
              f"(CUDA events, turns body, kernel, kernel, body; {t['body'] / t['kernel']:.2f}x); "
              f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / t['kernel']:.4f}")
        if b != BATCH:
            continue
        print(f"{name} drift of the accumulation chain, B={b}, N={N} (SEG_ROWS_MAX = "
              f"{rf.SEG_ROWS_MAX}):")
        for seg in (N, 51_200, 25_600, 12_800, 6_400, 3_200):
            pl = rf._segment_plan(b, N, Dv, sem_d, seg_rows_max=seg, i8=scale is not None)
            got, ref = new(pl), plain
            if parts:  # each family over its own sum: the scale of the blend's output
                d = plain[:, 2 * Dv:2 * Dv + 2].clamp_min(1e-30)
                got, ref = (torch.cat([a[:, :Dv] / d[:, :1], a[:, Dv:2 * Dv] / d[:, 1:]], 1)
                            for a in (got, ref))
            err = (got - ref).abs()
            print(f"  {pl.n_seg} segments of {pl.seg_rows} rows ({pl.seg_rows // 16} k16 "
                  f"steps): max err {err.max().item():.3e} (err/tol "
                  f"{err.max().item() / flip_atol:.3e}), rows off by > 1e-4: "
                  f"{(err > 1e-4).any(dim=1).sum().item()} (at most {max(2, b // 100)}); "
                  f"{_cuda_ms(lambda: new(pl), 1):.3f} ms")


def _sm90_tile_budget(plan, sem_d: int, b: int, Dv: int, ms: float) -> None:
    """The flat form's measured time per 64-row tile on one SM (the run's
    ms over its waves of blocks and the tiles of a segment) beside what a
    tile needs: its tensor-core operations at the card's peak per SM, and
    its shared-memory traffic (the ring's TMA writes, and wgmma's operand
    reads: queries and keys of the semantic logits, the geo box, the value
    tile once per family) at 128 bytes a cycle per SM and the card's
    maximum SM clock."""
    mhz = _sm_clock_mhz()[1]
    kb, bn, dvs = sem_d // 64, plan.bn, plan.dvs
    blocks = -(-b // 64) * -(-Dv // dvs) * plan.n_seg
    waves = -(-blocks // 132)
    per_tile = ms / waves / (plan.seg_rows // bn) * 1e3  # microseconds
    flops = 2 * 64 * bn * (sem_d + 16) + 2 * 2 * 64 * bn * dvs
    tma = kb * bn * 128 + bn * 32 + (dvs // 64) * bn * 128 + bn * 4
    reads = 64 * sem_d * 2 + bn * sem_d * 2 + (64 + bn) * 32 + 2 * bn * dvs * 2
    tensor_us = flops / (BF16_FLOPS / 132) * 1e6
    smem_us = (tma + reads) / (128 * mhz * 1e6) * 1e6
    print(f"kernel 2 flat form, B={b}: {blocks} blocks in {waves} waves of 132, "
          f"{plan.seg_rows // bn} tiles a block: {per_tile:.3f} us a tile; a tile needs "
          f"{flops} tensor operations ({tensor_us:.3f} us at 989 TFLOP/s / 132 SMs) and "
          f"{tma + reads} bytes of shared-memory traffic ({tma} written by TMA, {reads} read "
          f"by wgmma: {smem_us:.3f} us at 128 B a cycle and {mhz:.0f} MHz)")


def _rr_kw(kw: dict) -> dict:
    """The rr launch's keywords (`_parts_family_rr`) from a family parts
    call's (``values`` and ``scale`` belong to the value shapes)."""
    out = dict(lr=True, sel=False, dedup_pad=False, geo_cols=None)
    out.update({k: v for k, v in kw.items() if k not in ("values", "scale")})
    return out


def _parts_mma_sync(q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, *, sem_d: int, bm: int,
                    bn: int, gpt: int, geo: bool, lrr: int, lr: bool = True, sel: bool = False,
                    dedup_pad: bool = False, geo_cols=None):
    """Kernel 14's rr shapes on their mma.sync body (`csrc/hier_parts_family.cu`,
    the body before the Hopper kernel), launched here alone as the
    same-run yardstick of `_parts_times`: no path of the port reaches it,
    and it counts nowhere.  It reads all of a family's columns (geo_cols
    is the Hopper kernel's)."""
    from range_tpu_torch.kernels._build import load_kernel_library
    from range_tpu_torch.ops import retrieval_hier as rh

    Bp, qw = q_cat.shape
    N, cat_d = k_cat.shape
    K, gw, W, rrp = idx.shape[1], g_cat.shape[1], g_vw.shape[1], z.shape[1]
    cols, qcols = rh._family_cols(geo, sem_d, cat_d, gw, qw, sel)
    scratch = torch.empty((Bp, K, gpt), device=q_cat.device)
    out = torch.empty((Bp, rrp + 128 + W if lr else lrr + 128 + rrp), device=q_cat.device)
    rc = load_kernel_library("hier_parts_family").hier_parts_family_launch(
        *[t.data_ptr() for t in (q_cat, k_cat, mask_neg, idx, g_cat, g_vw, z, scratch, out)],
        Bp, qw, cat_d, cols.start, cols.stop - cols.start, qcols.start, gw, bm, bn, gpt, K, W,
        lrr, rrp, N, int(lr), int(dedup_pad), torch.cuda.current_stream(q_cat.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hier_parts_family (mma.sync) launch failed: CUDA error {rc}")
    return out


def _sm_clock_mhz() -> tuple:
    """(current, maximum) SM clock in MHz, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True).stdout.split(",")
    return tuple(float(v) for v in out) if len(out) == 2 else (float("nan"),) * 2


@functools.lru_cache(maxsize=None)
def _max_sm_mhz() -> float:
    """The maximum SM clock nvidia-smi reports (read once: a call takes
    ~65 ms)."""
    return _sm_clock_mhz()[1]


def _exp_ms(n_exp: int) -> float:
    """The floor of n_exp exponentials: 16 exp2 a clock on each of the
    card's 132 SMs at the maximum SM clock."""
    return n_exp / (132 * 16 * _max_sm_mhz() * 1e6) * 1e3


def _scan_times(tag: str, args, kw, bound_ms: float, bound_by: str, n_exp: int,
                calls: int = 10) -> float:
    """Kernel 8's Hopper kernel at one scan shape, in two turns on CUDA
    events (`_turns_ms`; not counted): its device ms a call (the kernel and
    its segment reduction), its share of the bound, and beside the bound
    the floor of the exponentials it needs (`_exp_ms`).  Returns its ms."""
    from range_tpu_torch.ops import retrieval_hier as rh

    kernel = ("kernel", lambda: rh._launch_scan_sm90(*args, **kw))
    ms = _turns_ms((kernel, kernel), calls)["kernel"]
    print(f"{tag}: Hopper kernel {ms:.4f} ms (CUDA events, two turns); bound "
          f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.4f}; exp2 floor "
          f"{_exp_ms(n_exp):.4f} ms ({n_exp} exp2)")
    return ms


def _turns_ms(turns, calls: int) -> dict:
    """Device ms a call of each kind of turn: ``turns`` is a sequence of
    (kind, fn), each fn called `calls` times back to back between two CUDA
    events, in that order after a warm-up of each.  Each turn is queued
    behind a spin of the card (`torch.cuda._sleep`) three times as long as
    the host took to queue a call in the warm-up, so the events span the
    device's work and not the host's launches.  A kind's ms is the mean of
    its turns'."""
    host_s = 0.0
    for _ in range(2):  # the second round's host time sizes the spin
        t0 = time.perf_counter()
        for _, fn in turns:
            fn()
        host_s = (time.perf_counter() - t0) / len(turns)
        torch.cuda.synchronize()
    spin = int((3 * host_s * calls + 5e-4) * _max_sm_mhz() * 1e6)  # SM clocks
    ms = {}
    for kind, fn in turns:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        ms.setdefault(kind, []).append(start.elapsed_time(end) / calls)
    return {kind: statistics.mean(t) for kind, t in ms.items()}


def _parts_times(tag: str, args, kw, bound_ms: float, bound_by: str, n_exp: int,
                 calls: int = 5, body: bool = True) -> tuple:
    """Kernel 14's rr shapes on the Hopper kernel beside the mma.sync body
    (`_parts_mma_sync`) at one shape, in turns (body, kernel, kernel,
    body; neither counted) on CUDA events (`_turns_ms`): each one's device
    ms a call (the Hopper kernel's launch and its segment reduction, the
    body's one launch; the mean of its two turns), the kernel's share of
    the bound and the floor of the n_exp exponentials the shape needs
    (`_exp_ms`).  ``body=False``
    (more than 64 groups a tile, which the body does not take): the
    kernel's two turns alone.  Returns (the kernel's ms, the body's or
    None)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    rkw = _rr_kw(kw)

    def new():
        return rh._parts_family_rr(*args, **rkw)

    def old():
        return _parts_mma_sync(*args, **rkw)

    kernel = ("kernel", new)
    if body:
        t = _turns_ms((("body", old), kernel, kernel, ("body", old)), calls)
    else:
        t = dict(_turns_ms((kernel, kernel), calls), body=None)
    ms, old_ms = t["kernel"], t["body"]
    vs = (f"mma.sync body {old_ms:.4f} ms (CUDA events, turns body, kernel, kernel, body; "
          f"{old_ms / ms:.2f}x)" if body else "CUDA events, two turns; the mma.sync body "
          "takes at most 64 groups a tile")
    print(f"{tag}: Hopper kernel {ms:.4f} ms, {vs}; bound {bound_ms:.4f} ms "
          f"({bound_by}), share {bound_ms / ms:.4f}; exp2 floor {_exp_ms(n_exp):.4f} ms "
          f"({n_exp} exp2, 16 a clock x 132 SMs at {_max_sm_mhz():.0f} MHz)")
    return ms, old_ms


def _parts_drift(tag: str, args, kw, ref, mag, why: str):
    """Kernel 14's Hopper kernel with each list cut into segments of at most
    each of these tiles (each block sums its segment's rows through wgmma's
    accumulator): the longest a block's shared memory holds, the plan's,
    and down to one tile; for each the largest error over the terms rule
    (`_compare_terms`' tolerance) and the rows over it, against the plain
    version, and the time (CUDA events), beside PARTS_ROWS_MAX."""
    from range_tpu_torch.ops import retrieval_hier as rh

    rkw = _rr_kw(kw)
    sh = rh._parts_shapes(*args, **{k: v for k, v in rkw.items() if k != "dedup_pad"})
    Bp, K = args[0].shape[0], args[3].shape[1]
    pk = (K, kw["bn"], kw["gpt"], sh["kf"], sh["gwe"], sh["share"], args[6].shape[1],
          sh["acols"])
    base = rh._parts_plan(Bp, *pk, sh["out_w"])
    longest = max(c for c in range(1, K + 1) if rh._parts_fits(rh._parts_layout(*pk, c, 2)))
    print(f"{tag}: drift of the accumulation chain (PARTS_ROWS_MAX = {rh.PARTS_ROWS_MAX} rows; "
          f"the plan {base}; tolerance: {why}):")
    for cap in sorted({longest, base.seg_cap, 8, 4, 2, 1}, reverse=True):
        plan = rh.PartsPlan(-(-K // cap), cap, 2)
        got = rh._parts_family_rr(*args, **rkw, plan=plan)
        err = (got - ref).abs()
        tol = torch.minimum(4e-3 * ref.abs().amax(dim=1, keepdim=True), 2.0 ** -7 * mag) + 1e-6
        ms = _cuda_ms(lambda: rh._parts_family_rr(*args, **rkw, plan=plan), 5)
        print(f"  segments of {cap} tiles ({cap * kw['bn']} rows a chain, {plan.n_seg} a list): "
              f"err/tol {(err / tol).max().item():.3e}, rows over it "
              f"{(err > tol).any(dim=1).sum().item()} of {Bp}; {ms:.4f} ms (CUDA events)")


def _values_launch(args, kw, merged: bool, plan=None, n_seg=None):
    """The Hopper values kernel's launch (`csrc/hier_parts_sm90.cu`) of a
    `_hier_parts_call` (``merged``) or a value-shape `_hier_parts_family_call`
    with these arguments, ``plan`` / ``n_seg`` overriding its plan's;
    counted nowhere."""
    from range_tpu_torch.ops import retrieval_hier as rh

    if merged:
        q_cat, k_cat, values, scale, mask, idx, g_s, g_g, vw_s, vw_g = args
        return rh._values_sm90("hier_parts", q_cat, k_cat, values, scale, mask, idx,
                               (g_s, vw_s, kw["gpt_s"]),
                               (g_g, vw_g, kw["gpt_g"]) if kw.get("geo", True) else None,
                               sem_d=kw["sem_d"], bm=kw["bm"], bn=kw["bn"], merged=True,
                               lr=kw.get("lr", True), plan=plan, n_seg=n_seg)
    q_cat, k_cat, mask, idx, g_cat, g_vw, _ = args
    return rh._values_sm90("hier_parts_family", q_cat, k_cat, kw["values"], kw["scale"], mask,
                           idx, (g_cat, g_vw, kw["gpt"]), None, sem_d=kw["sem_d"], bm=kw["bm"],
                           bn=kw["bn"], merged=False, geo0=kw["geo"], lr=kw.get("lr", True),
                           sel=kw.get("sel", False), dedup=kw.get("dedup_pad", False),
                           plan=plan, n_seg=n_seg)


def _values_mma_sync(args, kw, merged: bool):
    """Kernel 15 or kernel 14's value shapes on their mma.sync body
    (`csrc/hier_parts.cu`, the body before the Hopper values kernel),
    launched here alone as the same-run yardstick of `_values_turns`: no
    path of the port reaches it, and it counts nowhere."""
    from range_tpu_torch.kernels._build import load_kernel_library
    from range_tpu_torch.ops import retrieval_hier as rh

    lib = load_kernel_library("hier_parts")
    lr = kw.get("lr", True)

    def p(t):
        return None if t is None else t.data_ptr()

    if merged:
        q_cat, k_cat, values, scale, mask, idx, g_s, g_g, vw_s, vw_g = args
        (Bp, cat_d), (N, Dv), K = q_cat.shape, values.shape, idx.shape[1]
        Ws, Wg = vw_s.shape[1], vw_g.shape[1]
        out = torch.empty((Bp, 2 * Dv + 128 + (Ws if lr else 0)), device=q_cat.device)
        rc = lib.hier_parts_launch(
            p(q_cat), p(k_cat), p(values), p(scale), p(mask), p(idx), p(g_s), p(g_g), p(vw_s),
            p(vw_g), p(out), Bp, cat_d, kw["sem_d"], Dv, kw["bm"], kw["bn"], kw["gpt_s"],
            kw["gpt_g"], K, Ws, Wg, g_g.shape[1], int(kw.get("geo", True)), int(lr),
            int(scale is not None), rh._stream(q_cat))
    else:
        q_cat, k_cat, mask, idx, g_cat, g_vw, _ = args
        values, scale = kw["values"], kw["scale"]
        (Bp, qw), (N, Dv), K, W = q_cat.shape, values.shape, idx.shape[1], g_vw.shape[1]
        out = torch.empty((Bp, Dv + 128 + (W if lr else 0)), device=q_cat.device)
        rc = lib.hier_parts_family_values_launch(
            p(q_cat), p(k_cat), p(values), p(scale), p(mask), p(idx), p(g_cat), p(g_vw), p(out),
            Bp, qw, k_cat.shape[1], kw["sem_d"], Dv, kw["bm"], kw["bn"], kw["gpt"], K, W,
            g_cat.shape[1], int(kw["geo"]), int(lr), int(scale is not None),
            int(kw.get("sel", False)), int(kw.get("dedup_pad", False)), rh._stream(q_cat))
    if rc != 0:
        raise RuntimeError(f"hier_parts (mma.sync) launch failed: CUDA error {rc}")
    return out


def _values_bound(args, kw, merged: bool, b: int):
    """(bound ms, what bounds it) of one values launch, counted from its
    inputs: per real query and valid selected row, each family's row
    logits over its real columns (sem_d, or the 9 geo ones) and the value
    product over Dv; per group the group logits and the product over the
    lr coefficients or Dv + the count; each input read once (the union of
    the selected tiles), the output written once."""
    if merged:
        q_cat, k_cat, values, scale, mask, idx, g_s, g_g, vw_s, vw_g = args
        fams = [(kw["sem_d"], kw["gpt_s"], g_s, vw_s, kw.get("lr", True))]
        if kw.get("geo", True):
            fams.append((GEO_COLS, kw["gpt_g"], g_g, vw_g, False))
    else:
        q_cat, k_cat, mask, idx, g_cat, g_vw, _ = args
        values, scale = kw["values"], kw["scale"]
        real = GEO_COLS if kw["geo"] else kw["sem_d"]
        fams = [(real, kw["gpt"], g_cat, g_vw, kw.get("lr", True))]
    Dv, bn, bm = values.shape[1], kw["bn"], kw["bm"]
    nB, K = idx.shape
    valid = (mask[0] == 0).reshape(-1, bn).sum(dim=1).double()
    qb = _block_queries(nB, bm, idx.device, n=b)
    if kw.get("dedup_pad"):
        keep = torch.ones_like(idx, dtype=torch.bool)
        keep[:, 1:] = idx[:, 1:] != idx[:, :-1]
        rows = (valid[idx.long()] * keep).sum(dim=1)
        tiles = keep.sum(dim=1).double()
    else:
        rows, tiles = valid[idx.long()].sum(dim=1), torch.full((nB,), float(K), device=idx.device)
    pairs, qt = (qb * rows).sum().item(), (qb * tiles).sum().item()
    U = int(torch.unique(idx).numel())
    flops = n_bytes = 0.0
    for real, gpt, g, vw, lr in fams:
        flops += 2 * pairs * (real + Dv) + 2 * qt * gpt * (real + (vw.shape[1] if lr else Dv + 1))
        n_bytes += U * gpt * (g.shape[1] + vw.shape[1]) * 2
        # the columns it produces: acc and d, and alr
        n_bytes += b * (Dv + 1 + (vw.shape[1] if lr else 0)) * 4
    kf = sum(real for real, *_ in fams)  # the query and key columns the logits need
    n_bytes += b * kf * 2 + U * bn * (kf * 2 + Dv * values.element_size() + 4
                                      + (4 if scale is not None else 0))
    return _bound(n_bytes, flops, BF16_FLOPS)


def _values_turns(tag: str, args, kw, merged: bool, b: int, calls: int = 3) -> tuple:
    """The Hopper values kernel beside its mma.sync body (`_values_mma_sync`)
    at one shape, in turns body, kernel, kernel, body on CUDA events
    (`_turns_ms`; neither counted), with its bound and share (`_values_bound`,
    b real queries).  A kernel slower than the body is printed as such.
    Returns (the kernel's ms, the body's ms, bound ms, what bounds it)."""
    t = _turns_ms((("body", lambda: _values_mma_sync(args, kw, merged)),
                   ("kernel", lambda: _values_launch(args, kw, merged)),
                   ("kernel", lambda: _values_launch(args, kw, merged)),
                   ("body", lambda: _values_mma_sync(args, kw, merged))), calls)
    b_ms, b_by = _values_bound(args, kw, merged, b)
    slower = "" if t["kernel"] < t["body"] else "; SLOWER than the mma.sync body"
    print(f"{tag}: Hopper values kernel {t['kernel']:.4f} ms, mma.sync body {t['body']:.4f} ms "
          f"(CUDA events, turns body, kernel, kernel, body; {t['body'] / t['kernel']:.2f}x); "
          f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / t['kernel']:.4f}{slower}")
    return t["kernel"], t["body"], b_ms, b_by


def _values_batches(tag: str, request, merged: bool, ref_fn, segs, why: str):
    """The values launch of a request at each batch of REQUESTS:
    ``request(b)`` gives the (args, kw) of a B = b request's launch (its
    own queries, its plan's bm and lists, the padded rows sorted last);
    its b real queries' rows are held against its plain version segment by
    segment (`_compare_terms` over each (name, columns) of ``segs``, rows
    over the row cap in at most max(2, b / 100)), and the padded rows,
    which the path drops, each to the flip bound (their q is 0, so p = e
    = 1 and a plain shape's acc, the sum of the tile's rows less its
    groups' sums, is rounding residue); each is timed in turns beside the
    mma.sync body (`_values_turns`, b real queries).  Returns the B =
    10,000 turn's (ms, body ms, bound ms, what bounds it) and (max error,
    the largest error over its tolerance)."""
    out = None
    pad_why = (f"{why}; padded rows (q = 0: p = e = 1), which the path drops: each within the "
               "flip bound")
    for b in REQUESTS:
        args, kw = request(b)
        got = _values_launch(args, kw, merged)
        ref, mag = ref_fn(args, kw, False), ref_fn(args, kw, True)
        n_pad, errs = got.shape[0] - b, []
        for name, c in segs:
            errs.append(_compare_terms(f"{tag} B={b} {name} vs plain", got[:b, c], ref[:b, c],
                                       mag[:b, c], why, rows_off_max=max(2, b // 100)))
            if n_pad:
                _compare_terms(f"{tag} B={b} {name}, its {n_pad} padded rows", got[b:, c],
                               ref[b:, c], mag[b:, c], pad_why, rows_off_max=n_pad)
        K = args[5 if merged else 3].shape[1]
        res = _values_turns(f"{tag} B={b} K={K} bm={kw['bm']}", args, kw, merged, b)
        if b == BATCH:
            out = res + ((max(e for e, _ in errs), max(r for _, r in errs)),)
    return out


def _values_drift(tag: str, args, kw, merged: bool, ref, mag, why: str):
    """The values kernel with each list cut into n_seg segments of whole
    tiles (one chain over the list, the plan's, down to a tile each; each
    block sums its segment's rows through wgmma's accumulator): for each
    the largest error over the terms rule and the rows over it, against
    the plain version, and the time (CUDA events), beside PARTS_ROWS_MAX."""
    from range_tpu_torch.ops import retrieval_hier as rh

    K, bn = args[5 if merged else 3].shape[1], kw["bn"]
    print(f"{tag}: drift of the accumulation chain (PARTS_ROWS_MAX = {rh.PARTS_ROWS_MAX} rows; "
          f"tolerance: {why}):")
    for n_seg in sorted({1, 2, 4, 8, K} - {n for n in (2, 4, 8) if n > K}):
        got = _values_launch(args, kw, merged, n_seg=n_seg)
        err = (got - ref).abs()
        tol = torch.minimum(4e-3 * ref.abs().amax(dim=1, keepdim=True), 2.0 ** -7 * mag) + 1e-6
        ms = _cuda_ms(lambda: _values_launch(args, kw, merged, n_seg=n_seg), 3)
        print(f"  {n_seg} segments a list ({-(-K // n_seg) * bn} rows a chain at most): err/tol "
              f"{(err / tol).max().item():.3e}, rows over it {(err > tol).any(dim=1).sum().item()}"
              f" of {args[0].shape[0]}; {ms:.4f} ms (CUDA events)")


def _scan_drift(tag: str, args, kw, ref, mag, rows=(None, 12_800, 6_400, 3_200)):
    """Kernel 8's Hopper kernel with the sem family cut into segments of at
    most each of ``rows`` tail rows (None: one chain over the family; each
    block sums its segment through wgmma's accumulator), the rest of the
    plan `_scan_plan`'s: the sem tail's largest error over the tails'
    tolerance (min(4e-3 x row max, 2^-7 x sum |terms|) + 1e-6,
    `_compare_terms`) and the rows over it, and the time (CUDA events),
    beside the SCAN_ROWS_MAX the plan keeps (the dense kernel's chain bound)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    fams = rh._scan_shapes(*args, **kw)
    Bp, Ws = args[0].shape[0], args[3].shape[1]
    base = rh._scan_plan(Bp, fams)
    G, _, _, gpt, sup = fams[0]
    T = G // gpt
    print(f"{tag}: drift of the accumulation chain (SCAN_ROWS_MAX = {rh.SCAN_ROWS_MAX}):")
    for r in rows:
        tps = T if r is None else min(T, max(1, r * sup // gpt))
        plan = base._replace(fams=(base.fams[0]._replace(n_seg=-(-T // tps), seg_tiles=tps),)
                             + base.fams[1:])
        got = rh._launch_scan_sm90(*args, **kw, plan=plan)[1][:, :Ws]
        err = (got - ref[:, :Ws]).abs()
        tol = torch.minimum(4e-3 * ref[:, :Ws].abs().amax(dim=1, keepdim=True),
                            2.0 ** -7 * mag[:, :Ws]) + 1e-6
        ms = _cuda_ms(lambda: rh._launch_scan_sm90(*args, **kw, plan=plan), 5)
        print(f"  sem segments {-(-T // tps)} of {tps} tiles ({tps * gpt // sup // 16} k16 steps "
              f"a chain): sem tail err/tol {(err / tol).max().item():.3e}, rows over it "
              f"{(err > tol).any(dim=1).sum().item()} of {Bp}; {ms:.3f} ms")


def _tower_bound(b: int, bf16: bool):
    """(least ms, what bounds it) of the tower at b queries: the work it
    needs, the basis (the Legendre recurrence ~4 operations an entry, the
    trig product 1), basis @ W0, the hidden and last layers and two sin
    layers, not the kernels' Fourier synthesis or folded products; the
    products at the f32 rate, or in the bf16 mode at the bf16 tensor rate
    (the elementwise work at the f32 rate either way); the weights in f32
    or bf16."""
    mm = 2 * b * (L * L * WIDTH + 2 * WIDTH * WIDTH)
    ew = b * (5 * L * L + 2 * WIDTH)
    weights = L * L * WIDTH + 2 * WIDTH * WIDTH
    n_bytes = b * (2 + WIDTH) * 4 + (2 if bf16 else 4) * weights + 4 * 3 * WIDTH
    if not bf16:
        return _bound(n_bytes, mm + ew, F32_FLOPS)
    return _bound(n_bytes, mm, BF16_FLOPS, (ew, F32_FLOPS))


def _tower_f32_body_bf16(coords, params):
    """`csrc/siren_tower.cu`'s bf16 form (bf16_ops = 1) launched alone, not
    counted: the yardstick of the bf16 mode's Hopper body.  Its f32
    operands are prepared here, once.  Returns (launch, its output)."""
    import ctypes

    from range_tpu_torch.kernels._build import load_kernel_library
    from range_tpu_torch.ops import sh

    ftabT, wc, ws, deep, wl, bpack = sh._tower_f32(L, params, "analytic")
    lib = load_kernel_library("siren_tower")
    B = coords.shape[0]
    out = torch.empty(B, WIDTH, device=coords.device)
    n_deep = len(params["layers"]) - 1
    stream = torch.cuda.current_stream(coords.device).cuda_stream

    def run():
        rc = lib.siren_tower_launch(coords.data_ptr(), ftabT.data_ptr(), wc.data_ptr(),
                                    ws.data_ptr(), bpack.data_ptr(), deep.data_ptr(),
                                    wl.data_ptr(), out.data_ptr(), B, L, WIDTH, n_deep,
                                    ctypes.c_float(30.0), ctypes.c_float(1.0), 1, stream)
        if rc != 0:
            raise RuntimeError(f"siren_tower (bf16 form) launch: CUDA error {rc}")

    return run, out


def _combine_bounds(b: int, ck: dict, Dq: int) -> dict:
    """Kernel 16's work at b queries: 2 b Dv K flops of f32 products (K = 2
    rrp + r + rg; rg = 0 adds 2 b Dv of additive geo terms), bytes the
    partials read once, the bases, the output.  Its bound at the f32 rate
    (the CUDA-core body's, the exact tier's) and at the rate of the form
    the Hopper body runs, three TF32 products each ("tf32x3")."""
    Dv, rrp, r, rg, Ws, Wg = (ck[k] for k in ("Dv", "rrp", "r", "rg", "Ws", "Wg"))
    K = 2 * rrp + r + rg
    flops = 2 * b * Dv * K
    pg_w = rrp + 128 + Wg if rg else Dv + 128 + rrp
    n_bytes = (b * ((rrp + 128 + Ws) + pg_w + Ws + Wg + Dq) * 4 + K * Dv * 4
               + b * (Dv + Dq) * 4)
    extra = 0 if rg else 2 * b * Dv
    return dict(f32=_bound(n_bytes, flops + extra, F32_FLOPS),
                tf32x3=_bound(n_bytes, 3 * flops, TF32_FLOPS, (extra, F32_FLOPS)))


def _combine_turns(tag: str, c_args, ck: dict, b: int, calls: int = 10) -> dict:
    """Kernel 16 at one request: its Hopper body (the fast and high tiers'
    route) and its f32 body (the exact tier's route, `tier="exact"`) each
    held against the plain version (f32 products in another summation
    order: 1e-5 + 1e-5 |ref|), then timed in turns f32 body, Hopper body,
    Hopper body, f32 body on CUDA events (`_turns_ms`; launches here count
    in no drive), with both bounds (`_combine_bounds`) and the shares."""
    from range_tpu_torch.ops import retrieval_hier as rh

    ref = rh._combine_cat_plain(*c_args, **ck)
    why = "f32 products in another summation order"
    e_new, r_new = _compare(f"{tag} Hopper body (TF32 x3)", rh._combine_cat_call(*c_args, **ck),
                            ref, 1e-5, 1e-5, why)
    e_old, r_old = _compare(f"{tag} f32 body", rh._combine_cat_call(*c_args, **ck, tier="exact"),
                            ref, 1e-5, 1e-5, why)
    new = ("sm90", lambda: rh._combine_cat_call(*c_args, **ck))
    old = ("f32", lambda: rh._combine_cat_call(*c_args, **ck, tier="exact"))
    t = _turns_ms((old, new, new, old), calls)
    bd = _combine_bounds(b, ck, c_args[3].shape[1])
    (bt, bt_by), (bf, bf_by) = bd["tf32x3"], bd["f32"]
    print(f"{tag}: Hopper body {t['sm90']:.4f} ms, f32 body {t['f32']:.4f} ms "
          f"({t['f32'] / t['sm90']:.2f}x; CUDA events, in turns); bound at the TF32 x3 rate "
          f"{bt:.4f} ms ({bt_by}), share {bt / t['sm90']:.4f}; at the f32 rate {bf:.4f} ms "
          f"({bf_by}), the f32 body's share {bf / t['f32']:.4f}")
    return dict(new=(e_new, r_new, t["sm90"], bt, bt_by), old=(e_old, r_old, t["f32"], bf, bf_by))


def _send(enc, c):
    # the B=37 request arrives as a numpy float64 array, as numpy callers
    # send coordinates; the entry point casts it to f32
    return enc(c.double().cpu().numpy() if c.shape[0] == 37 else c)


def dense_phases(dev, gen, report) -> float:
    """Phases 3-4 of the dense slice: its two kernels against their plain
    versions, then RANGE+ and RANGE through load_model.  Returns the RANGE+
    end-to-end ms at B=10,000."""
    from range_tpu_torch import GeoBank, load_model
    from range_tpu_torch.bank import dequantize_values, quantize_values
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import sh
    from range_tpu_torch.ops.nets import SirenNet

    net = SirenNet(L * L, WIDTH, WIDTH, 2, device=dev, generator=gen)
    params = net.tower_params()
    coords = _random_coords(BATCH, gen, dev)
    with torch.no_grad():
        for md, atol, why in (
                (None, 1e-4, "same f32 math, another summation order; "
                 "sin(30 h) multiplies h's rounding by 30"),
                (torch.bfloat16, 2e-2, "same bf16 operand rounding points; "
                 "an f32 sum that lands near a bf16 tie rounds the other "
                 "way, 2^-8 relative, amplified by sin(30 h)")):
            tag = "f32" if md is None else "bf16"
            got = sh.siren_tower(coords, L, params, matmul_dtype=md)
            ref = sh._siren_tower_plain(coords, L, params, matmul_dtype=md)
            err, ratio = _compare(f"siren_tower[{tag}] B={BATCH}", got, ref, atol, 0.0, why)
            ms = _cuda_ms(lambda: sh.siren_tower(coords, L, params, matmul_dtype=md), 20)
            plain_ms = _cuda_ms(
                lambda: sh._siren_tower_plain(coords, L, params, matmul_dtype=md), 20)
            print(f"siren_tower[{tag}] B={BATCH}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            b_ms, b_by = _tower_bound(BATCH, md is not None)
            if md is None:  # the dense path's mode, on csrc/siren_tower.cu
                report["siren_tower"] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                             plain_ms=plain_ms, bound_ms=b_ms,
                                             bound_by=b_by)
                continue
            # the bf16 mode (the flagship's) on its Hopper body, beside the f32
            # body's bf16 form, each batch its own request
            for b in REQUESTS:
                cb = coords[:b].contiguous()
                ref_b = sh._siren_tower_plain(cb, L, params, matmul_dtype=md)
                e_b, r_b = _compare(f"siren_tower_sm90[bf16] B={b}",
                                    sh.siren_tower(cb, L, params, matmul_dtype=md), ref_b,
                                    atol, 0.0, why)
                old_run, old_out = _tower_f32_body_bf16(cb, params)
                old_run()
                _compare(f"siren_tower[bf16] B={b}, the f32 body's bf16 form", old_out, ref_b,
                         atol, 0.0, why)
                new = ("sm90", lambda: sh.siren_tower(cb, L, params, matmul_dtype=md))
                t = _turns_ms((("f32 body", old_run), new, new, ("f32 body", old_run)),
                              10 if b >= SMALL_BATCH else 20)
                b_ms, b_by = _tower_bound(b, True)
                print(f"siren_tower[bf16] B={b}: Hopper body {t['sm90']:.4f} ms, the f32 "
                      f"body's bf16 form {t['f32 body']:.4f} ms ({t['f32 body'] / t['sm90']:.2f}x;"
                      f" CUDA events, in turns); bound {b_ms:.4f} ms ({b_by}, products at the "
                      f"bf16 rate), share {b_ms / t['sm90']:.4f}; plan "
                      f"{sh._tower_plan(b, L, WIDTH)}")
                if b == BATCH:
                    report["siren_tower_bf16"] = dict(
                        max_abs_err=e_b, err_over_tol=r_b, ms=t["sm90"], plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by)

        bank = GeoBank.synthetic_device(0, BANK_ROWS, pad_to=PAD_TO,
                                        value_dtype=torch.bfloat16, device=dev)
        q = torch.randn(BATCH, bank.key_dim, generator=gen, device=dev)
        q = q / torch.linalg.norm(q, dim=1, keepdim=True)
        q_xyz = lonlat_deg_to_xyz(coords)
        mask = (rf.NEG * (1.0 - bank.row_mask()))[None, :]
        # same logits up to summation order, so p differs by ~1e-6 relative;
        # the rare p that close to a bf16 rounding boundary rounds the other
        # way before the value product: one bf16 ulp (<= 2^-7 relative) of
        # one weight, times at most the largest |v|, in a few rows
        flip_atol = bank.values.abs().max().item() / 128
        retr_why = ("the same logits up to summation order; a p within that "
                    "difference of a bf16 rounding boundary rounds the other way "
                    "(one ulp <= 2^-7 of one weight, times max |v|) in rare rows")
        # kernel 2: the Hopper kernel (bf16 tiers) at the dense path's shape,
        # the high tier and RANGE at B=1,000, the small requests; the exact
        # tier on the mma.sync body
        for tier, mode, b in (("fast", "range+", BATCH), ("exact", "range+", SMALL_BATCH),
                              ("high", "range+", SMALL_BATCH),
                              ("fast", "range", SMALL_BATCH), ("fast", "range+", 1),
                              ("fast", "range+", 37)):
            qx = q_xyz[:b] if mode == "range+" else None
            beta = 0.5 if mode == "range+" else 1.0
            temp = 12.0 if mode == "range+" else 15.0
            q_cat = rf.pack_queries(q[:b], qx, temp, 40.0, tier)
            k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, tier)
            sem_d, _ = rf.packed_dims(bank.key_dim, tier)

            def kernel():
                return rf.retrieve_fused(q_cat, k_cat, bank.values, mask, beta, sem_d=sem_d)

            def plain():
                return rf._retrieve_fused_plain(q_cat, k_cat, bank.values, mask, beta,
                                                sem_d=sem_d)

            name = "fused_retrieval_exact" if tier == "exact" else "fused_retrieval"
            tag = f"{name}[{tier},{mode}] B={b} N={bank.num_rows}"
            if tier != "exact":
                plan = rf._segment_plan(b, bank.num_rows, bank.value_dim, sem_d)
                print(f"{tag}: {plan}, {rf._sm90_smem(sem_d, *plan[:4])} bytes of shared "
                      "memory a block")
            err, ratio = _compare(tag, kernel(), plain(), flip_atol, 0.0, retr_why,
                                  rows_off_max=max(2, b // 100))
            ms = _cuda_ms(kernel, 5 if b > 37 else 20)
            plain_ms = _cuda_ms(plain, 3)
            print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
            if tier == "exact":  # f32 logits on the CUDA cores, bf16 value products
                n, Dv = bank.n_valid, bank.value_dim
                n_bytes = (b * q_cat.shape[1] * 4 + n * (k_cat.shape[1] * 4 + Dv * 2 + 4)
                           + b * Dv * 4)
                f32_ops = 2 * b * n * (sem_d + 3)
                b_ms, b_by = _bound(n_bytes, f32_ops + 2 * 2 * b * n * Dv * F32_FLOPS
                                    / BF16_FLOPS, F32_FLOPS)
                report[name] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            if b == BATCH:  # the dense path's tier and shape
                n, Dv = bank.n_valid, bank.value_dim
                # bf16 sem logits (sem_d) and hi/lo geo logits (9 columns),
                # two bf16 value products, over the valid rows
                flops = 2 * b * n * (sem_d + GEO_COLS) + 2 * 2 * b * n * Dv
                n_bytes = (b * q_cat.shape[1] * 2 + n * (k_cat.shape[1] * 2 + Dv * 2 + 4)
                           + b * Dv * 4)
                b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
                report["fused_retrieval"] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                                 plain_ms=plain_ms, bound_ms=b_ms,
                                                 bound_by=b_by)

        _sm90_drift(bank, q, q_xyz, mask, flip_atol)
        _sm90_times(bank, q, q_xyz, mask, flip_atol, retr_why)

        # the int8 kernel over the same bank's int8 codes (dense RANGE+, fast)
        bank8 = quantize_values(bank)
        q_cat = rf.pack_queries(q, q_xyz, 12.0, 40.0, "fast")
        k_cat = rf.pack_bank(bank8.keys_sem, bank8.xyz, "fast")
        sem_d = bank.key_dim

        def kernel8():
            return rf.retrieve_fused_i8(q_cat, k_cat, bank8.values, bank8.value_scale, mask,
                                        0.5, sem_d=sem_d)

        def plain8():
            return rf._retrieve_fused_plain(q_cat, k_cat, bank8.values, mask, 0.5,
                                            bank8.value_scale, sem_d=sem_d)

        tag = f"fused_retrieval_i8[fast,range+] B={BATCH} N={bank.num_rows}"
        err, ratio = _compare(tag, kernel8(), plain8(),
                              dequantize_values(bank8).abs().max().item() / 128, 0.0,
                              retr_why + " (the weight being p times its row's scale)",
                              rows_off_max=max(2, BATCH // 100))
        ms = _cuda_ms(kernel8, 5)
        plain_ms = _cuda_ms(plain8, 3)
        print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        n, Dv = bank.n_valid, bank.value_dim
        flops = 2 * BATCH * n * (sem_d + GEO_COLS) + 2 * 2 * BATCH * n * Dv
        # int8 codes and an f32 scale a row, instead of bf16 values
        n_bytes = (BATCH * q_cat.shape[1] * 2 + n * (k_cat.shape[1] * 2 + Dv + 4 + 4)
                   + BATCH * Dv * 4)
        b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
        report["fused_retrieval_i8"] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                            plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        # kernels 3 and 5 on the Hopper kernel beside the mma.sync body
        flip8 = dequantize_values(bank8).abs().max().item() / 128
        why8 = retr_why + " (the weight being p times its row's scale)"
        _form_times("kernel 3 [int8]", bank, q, q_xyz, bank8.values, bank8.value_scale, mask,
                    False, flip8, why8)
        _form_times("kernel 5 [bf16]", bank, q, q_xyz, bank.values, None, mask, True,
                    flip_atol, retr_why)
        _form_times("kernel 5 [int8]", bank, q, q_xyz, bank8.values, bank8.value_scale, mask,
                    True, flip8, why8)

    # ---- 4. the dense path, through the entry point
    models = {name: load_model(name, db_path=bank, device="cuda")
              for name in ("RANGE+", "RANGE")}
    requests = [_random_coords(b, gen, dev) for b in REQUESTS]
    sh.siren_tower.launches = 0
    rf.retrieve_fused.launches = 0
    answers = {name: [_send(enc, c) for c in requests] for name, enc in models.items()}
    torch.cuda.synchronize()
    launches = {"siren_tower": sh.siren_tower.launches,
                "fused_retrieval": rf.retrieve_fused.launches}
    print(f"dense path launches: {launches}")
    for name, count in launches.items():
        if count != len(models) * len(requests):  # once per request, f64 one too
            raise AssertionError(f"the dense path launched {name} {count} times, "
                                 f"not once per request")
        report[name]["launches"] = count

    for name, outs in answers.items():
        mode = "range+" if name == "RANGE+" else "range"
        for c, out in zip(requests, outs):
            B = c.shape[0]
            if out.shape != (B, 1280) or not torch.isfinite(out).all():
                raise AssertionError(f"{name} B={B}: shape {tuple(out.shape)} or non-finite")
            q_sem = out[:, bank.value_dim:]
            norm_err = (torch.linalg.norm(q_sem, dim=1) - 1.0).abs().max().item()
            if norm_err > 1e-5:
                raise AssertionError(f"{name} B={B}: query part not unit-norm ({norm_err:.2e})")
            with torch.no_grad():
                ref = retrieval.retrieve(
                    q_sem, lonlat_deg_to_xyz(c) if mode == "range+" else None, bank,
                    sem_temp=12.0 if mode == "range+" else 15.0, beta=0.5, mode=mode)
            _compare(f"{name} B={B} vs exact f32 retrieve", out[:, :bank.value_dim], ref,
                     5e-2, 1e-1, "the fast tier's tolerance in "
                     "tests/test_retrieval_pallas.py: bf16 semantic logits")

    e2e = _host_ms(lambda: models["RANGE+"](requests[-1]), 5)
    print(f"dense RANGE+ end to end B={BATCH} (coords already on the card): "
          f"median {e2e:.3f} ms over 5 calls")

    # ---- 4a. the exact tier through the entry point: kernel 2's mma.sync body
    exact = load_model("RANGE+", db_path=bank, tier="exact", device="cuda")
    out, got = _drive(f"dense RANGE+ tier='exact' B={SMALL_BATCH}",
                      lambda: exact(requests[2]), {"siren_tower": 1, "fused_retrieval_exact": 1})
    report["fused_retrieval_exact"]["launches"] = got["fused_retrieval_exact"]
    with torch.no_grad():
        ref = retrieval.retrieve(out[:, bank.value_dim:], lonlat_deg_to_xyz(requests[2]), bank,
                                 sem_temp=12.0, beta=0.5)
    _compare(f"RANGE+ tier='exact' B={SMALL_BATCH} vs exact f32 retrieve",
             out[:, :bank.value_dim], ref, 5e-2, 1e-1, "the fast tier's tolerance (the exact "
             "tier rounds only the weights to bf16)")
    del exact

    # ---- 4b. RANGE+ with value_quant="int8", through the entry point
    enc8 = load_model("RANGE+", db_path=bank, value_quant="int8", device="cuda")
    b8 = enc8.model.bank
    bytes16 = bank.values.numel() * bank.values.element_size()
    bytes8 = b8.values.numel() * b8.values.element_size() + b8.value_scale.numel() * 4
    print(f"dense value bank on the card ({bank.num_rows} x {bank.value_dim}): bf16 "
          f"{bytes16 / 1e6:.3f} MB, int8 {bytes8 / 1e6:.3f} MB (codes + f32 scales)")
    count = 0
    for c in requests:
        out, got = _drive(f"dense RANGE+ int8 B={c.shape[0]}", lambda: _send(enc8, c),
                          {"siren_tower": 1, "fused_retrieval_i8": 1})
        count += got["fused_retrieval_i8"]
        if out.shape != (c.shape[0], 1280) or not torch.isfinite(out).all():
            raise AssertionError(f"dense int8 B={c.shape[0]}: shape or non-finite")
    report["fused_retrieval_i8"]["launches"] = count
    with torch.no_grad():  # `retrieve` serves an int8 bank from its f32 reconstruction
        ref = retrieval.retrieve(out[:, bank.value_dim:], lonlat_deg_to_xyz(requests[-1]), b8,
                                 sem_temp=12.0, beta=0.5)
    _compare(f"RANGE+ int8 B={BATCH} vs exact f32 retrieve over the dequantized bank",
             out[:, :bank.value_dim], ref, 5e-2, 1e-1, "the fast tier's tolerance in "
             "tests/test_retrieval_pallas.py: bf16 semantic logits")
    e2e8 = _host_ms(lambda: enc8(requests[-1]), 5)
    print(f"dense RANGE+ int8 end to end B={BATCH}: median {e2e8:.3f} ms over 5 calls")
    return e2e


def _counters() -> dict:
    """Each kernel's launch count: (its wrapper, the wrapper's attribute
    that counts it).  The scan's segment-sum and wide-tail variants count
    in `.sup_launches` / `.wide_launches` besides the scan's `.launches`,
    kernel 15's plain variant in `.plain_launches` besides `.launches`,
    kernel 16's rg = 0 variant on its Hopper body in `.rg0_launches` and
    its f32 body (the exact tier) in `.exact_launches` besides `.launches`,
    the tower's bf16 mode (its Hopper body) in `.bf16_launches` besides
    `.launches`,
    kernel 13's wide form in `.wide_launches` besides `.launches`;
    each of kernel 14's four shapes counts in its own attribute (two live
    in another source), `hier_parts_family` the flagship's rr + lr one;
    its sel and dedup_pad forms in `.sel_launches` / `.dedup_launches`
    (every shape) and `.sel_rr_launches` / `.dedup_rr_launches` (the rr
    shapes': the rows of hier_parts.cu's forms report the difference);
    kernel 12's has_parts form in `.parts_launches` besides `.launches`."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh
    from range_tpu_torch.ops import sh

    wrappers = {"siren_tower": sh.siren_tower, "fused_retrieval": rf.retrieve_fused,
                "fused_retrieval_i8": rf.retrieve_fused_i8,
                "hier_scan": rh._hier_scan_call,
                "hier_parts_family": rh._hier_parts_family_call,
                "combine_cat": rh._combine_cat_call,
                "hier_scan_stats": rh._hier_scan_stats_call,
                "hier_argmax": rh._hier_argmax_call, "hier_topk": rh._hier_topk_call,
                "hier_parts": rh._hier_parts_call,
                "sh_times": sh.spherical_harmonics_times_fused,
                "hier_refine": rh._hier_refine_call, "hier_corr": rh._hier_corr_call}
    counters = {k: (w, "launches") for k, w in wrappers.items()}
    counters["hier_scan_sup"] = (rh._hier_scan_call, "sup_launches")
    counters["hier_scan_wide"] = (rh._hier_scan_call, "wide_launches")
    counters["hier_parts_plain"] = (rh._hier_parts_call, "plain_launches")
    counters["combine_cat_rg0"] = (rh._combine_cat_call, "rg0_launches")
    counters["combine_cat_exact"] = (rh._combine_cat_call, "exact_launches")
    counters["siren_tower_bf16"] = (sh.siren_tower, "bf16_launches")
    counters["hier_corr_wide"] = (rh._hier_corr_call, "wide_launches")
    counters["fused_retrieval_exact"] = (rf.retrieve_fused, "exact_launches")
    counters["fused_parts"] = (rf.retrieve_fused_parts, "launches")
    counters["fused_parts_i8"] = (rf.retrieve_fused_parts, "i8_launches")
    counters["family_pruned"] = (rf._family_pruned_call, "launches")
    counters["family_pruned_i8"] = (rf._family_pruned_call, "i8_launches")
    counters["fused_hybrid"] = (rf.retrieve_fused_hybrid, "launches")
    fam = rh._hier_parts_family_call
    counters["hier_parts_family"] = (fam, "rrlr_launches")
    for shape in ("plain", "lr", "rr"):
        counters[f"hier_parts_family_{shape}"] = (fam, f"{shape}_launches")
    for form in ("sel", "dedup"):
        counters[f"hier_parts_family_{form}"] = (fam, f"{form}_launches")
        counters[f"hier_parts_family_{form}_rr"] = (fam, f"{form}_rr_launches")
    counters["hier_refine_parts"] = (rh._hier_refine_call, "parts_launches")
    for k, _ in CORES_ROWS:
        for form, _ in CORES_FORMS:
            if hasattr(wrappers[k], f"{form}_launches"):  # not the parts kernels' deep forms
                counters[f"{k}_{form}"] = (wrappers[k], f"{form}_launches")
    return counters


def hier_phases(dev, gen, report):
    """The flagship slice: build the informative bank and its HierBank on
    the card, hold the three hier kernels against their plain versions at
    the main path's shapes, serve through load_model(profile="flagship"),
    check fidelity.  Returns (the flagship end-to-end ms at B=10,000, the
    HierBank, the encoder, the source bank)."""
    from range_tpu_torch import GeoBank, load_model
    from range_tpu_torch.api import SERVING_PROFILES
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh
    from range_tpu_torch.ops import sh

    # ---- 5. the bank build, on the card
    prof = SERVING_PROFILES["flagship"]
    t0 = time.perf_counter()
    bank = GeoBank.synthetic_informative(0, BANK_ROWS, pad_to=PAD_TO,
                                         value_dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hb = rh.build_hier_bank(bank, bn=512, gsz_sem=prof["gsz_sem"], gsz_geo=64,
                            lr_rank=prof["lr_rank"], lr_geo=prof["lr_geo"],
                            res_rank=prof["res_rank"], topk_gsz=prof["topk_gsz"])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"informative bank {BANK_ROWS} rows: {t1 - t0:.2f} s; build_hier_bank "
          f"(flagship knobs): {t2 - t1:.2f} s; t_real {hb.t_real}, t_pad {hb.t_pad}, "
          f"rows {hb.bank.num_rows}")

    # ---- 6. each hier kernel against its plain version, main-path shapes
    enc = load_model("RANGE+", db_path=hb, profile="flagship", device="cuda")
    cfg = enc.model.config
    bm, k_tiles, k_geo, j_sem = cfg.hier_plan(BATCH)
    coords = _random_coords(BATCH, gen, dev)
    with torch.no_grad():
        q = enc.model.query_embedding(coords)
        x = lonlat_deg_to_xyz(coords)
        q_s, q_x = rh._pad_queries(q, x, bm)
        order = rh._hybrid_order(q_x, BATCH)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[order].contiguous()
        gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
        scan_args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw_lr)
        scan_kw = dict(gpt_s=gpt_s, gpt_g=gpt_g)
        got = rh._hier_scan_call(*scan_args, **scan_kw)
        ref = rh._hier_scan_plain(*scan_args, **scan_kw)
        Ws, Wg = hb.g_sem_vw_lr.shape[1], hb.g_geo_vw_lr.shape[1]
        mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(),
                                  hb.g_geo_vw_lr.abs(), **scan_kw)[4]
        flip = ("an exp2 within the logits' f32 difference of a bf16 boundary rounds "
                "the other way: one ulp of one term")
        errs = [
            _compare("hier_scan m_s", got[0], ref[0], 1e-4, 0.0,
                     "f32 sums of the same bf16 products in another order, |l| < 60"),
            _compare("hier_scan s_s", got[1], ref[1], 0.0, 1e-4,
                     "f32 sums of f32 exp2 in another order"),
            _compare("hier_scan m_g", got[2], ref[2], 1e-4, 0.0,
                     "f32 sums of the same bf16 products in another order, |l| < 60"),
            _compare("hier_scan s_g", got[3], ref[3], 0.0, 1e-4,
                     "f32 sums of f32 exp2 in another order"),
            _compare_terms("hier_scan tails[sem]", got[4][:, :Ws], ref[4][:, :Ws],
                           mag[:, :Ws], flip),
            _compare_terms("hier_scan tails[geo]", got[4][:, Ws:], ref[4][:, Ws:],
                           mag[:, Ws:], flip)]
        m_s, s_s, m_g, s_g, tails = got
        idx_s, _ = rh.select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real, k_tiles=k_tiles,
                                   bm=bm, n_valid=BATCH, j_sem=j_sem, j_geo=cfg.j_geo,
                                   mode="range")
        idx_g, _ = rh.select_tiles(m_g, s_g, m_s, s_s, t_real=hb.t_real, k_tiles=k_geo,
                                   bm=bm, n_valid=BATCH, j_sem=cfg.j_geo, j_geo=j_sem,
                                   mode="range")
        plain_ms = _cuda_ms(lambda: rh._hier_scan_plain(*scan_args, **scan_kw), 3)
        print(f"hier_scan B={BATCH}: plain {plain_ms:.3f} ms")
        Gs, Gg = hb.t_real * gpt_s, hb.t_real * gpt_g
        ws, wg = hb.g_sem_cat.shape[1], hb.g_geo_cat.shape[1]

        def scan_bound(b):
            """The work b queries need: sem group logits over sem_d columns,
            geo over the 9 real ones; tails over the lr coefficients and the
            count column (the operands pad geo to 128 and W to a multiple of
            128)."""
            flops = 2 * b * (Gs * (hb.sem_d + hb.lr_rank + 1) + Gg * (GEO_COLS + hb.lr_geo + 1))
            n_bytes = (b * (ws + wg) * 2 + (Gs * (ws + Ws) + Gg * (wg + Wg)) * 2
                       + 4 * b * hb.t_pad * 4 + b * (Ws + Wg) * 4)
            return _bound(n_bytes, flops, BF16_FLOPS)

        b_ms, b_by = scan_bound(BATCH)
        ms = _scan_times(f"hier_scan B={BATCH}", scan_args, scan_kw, b_ms, b_by,
                         BATCH * (Gs + Gg))
        report["hier_scan"] = dict(max_abs_err=max(e for e, _ in errs),
                                   err_over_tol=max(r for _, r in errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        # the requests too small to fill the card alone: B = 1 and 37
        for b in (1, 37):
            q_sb, q_xb = rh._pad_queries(q[:b], x[:b], cfg.hier_plan(b)[0])
            qc = rf.pack_queries(q_sb, q_xb, 12.0, 40.0, hb.tier)[
                rh._hybrid_order(q_xb, b)].contiguous()
            args_b = (qc,) + scan_args[1:]
            got_b = rh._hier_scan_call(*args_b, **scan_kw)
            ref_b = rh._hier_scan_plain(*args_b, **scan_kw)
            mag_b = rh._hier_scan_plain(qc, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(),
                                        hb.g_geo_vw_lr.abs(), **scan_kw)[4]
            for i, stat in enumerate(("m_s", "s_s", "m_g", "s_g")):
                _compare(f"hier_scan B={b} {stat}", got_b[i], ref_b[i], *(
                    (1e-4, 0.0, "f32 sums of the same bf16 products in another order")
                    if stat[0] == "m" else (0.0, 1e-4, "f32 sums of f32 exp2 in another order")))
            _compare_terms(f"hier_scan B={b} tails", got_b[4], ref_b[4], mag_b, flip)
            plan_b = rh._scan_plan(qc.shape[0], rh._scan_shapes(*args_b, **scan_kw,
                                                                has_geo=True, sup_r=0))
            _scan_times(f"hier_scan B={b} (Bp {qc.shape[0]}, {plan_b})", args_b, scan_kw,
                        *scan_bound(b), b * (Gs + Gg), calls=20)

        why = ("bf16(p) and bf16(e - ps/cnt) can round the other way where the logits' f32 "
               "summation order moves them across a bf16 boundary: one ulp of one term")
        got_p, p_errs, tot = _rr_families(f"B={BATCH}", hb, q_cat, idx_s, idx_g, bm, BATCH,
                                          why, plain_time=True)
        if tot[1] < 2 * tot[0]:
            raise AssertionError("hier_parts_family: the Hopper kernel takes more than half "
                                 "the mma.sync body's time at the flagship")
        parts = {fam: v[0] for fam, v in got_p.items()}
        b_ms, b_by = _bound(tot[3], tot[4], BF16_FLOPS)
        report["hier_parts_family"] = dict(max_abs_err=max(e for e, _ in p_errs),
                                           err_over_tol=max(r for _, r in p_errs), ms=tot[0],
                                           plain_ms=tot[2], bound_ms=b_ms, bound_by=b_by)
        _, args_s, kw_s = got_p["sem"]
        pkw = {k: v for k, v in kw_s.items() if k != "geo_cols"}
        _parts_drift(f"hier_parts_family[sem] B={BATCH}", args_s, kw_s,
                     rh._hier_parts_family_plain(*args_s, **pkw),
                     rh._hier_parts_family_plain(*args_s, **pkw, magnitude=True), why)
        # the flagship at B = 1, 37 and 1,000: its budgets widen (hier_plan)
        ck = dict(Ws=Ws, r=hb.lr_rank, rrp=hb.z_sem.shape[1], Dv=hb.value_dim, beta=0.5,
                  rg=hb.lr_geo, Wg=Wg)
        bases = (hb.w_sem, hb.u_sem, hb.w_geo, hb.u_geo)
        combine = {}  # kernel 16's operands of each request
        for b in (1, 37, SMALL_BATCH):
            bm_b, k_b, kg_b, j_b = cfg.hier_plan(b)
            q_sb, q_xb = rh._pad_queries(q[:b], x[:b], bm_b)
            order_b = rh._hybrid_order(q_xb, b)
            qc = rf.pack_queries(q_sb, q_xb, 12.0, 40.0, hb.tier)[order_b].contiguous()
            st = rh._hier_scan_call(qc, *scan_args[1:], **scan_kw)
            i_s, _ = rh.select_tiles(*st[:4], t_real=hb.t_real, k_tiles=k_b, bm=bm_b,
                                     n_valid=b, j_sem=j_b, j_geo=cfg.j_geo, mode="range")
            i_g, _ = rh.select_tiles(st[2], st[3], st[0], st[1], t_real=hb.t_real,
                                     k_tiles=kg_b, bm=bm_b, n_valid=b, j_sem=cfg.j_geo,
                                     j_geo=j_b, mode="range")
            out_b, _, _ = _rr_families(f"B={b} (Bp {qc.shape[0]})", hb, qc, i_s, i_g, bm_b, b,
                                       why)
            q_srt_b = torch.nn.functional.pad(q[:b], (0, 0, 0, qc.shape[0] - b))[order_b]
            combine[b] = (out_b["sem"][0], out_b["geo"][0], st[4], q_srt_b.contiguous())

        q_srt = torch.nn.functional.pad(q, (0, 0, 0, q_cat.shape[0] - BATCH))[order]
        combine[BATCH] = (parts["sem"], parts["geo"], tails, q_srt.contiguous())
        # kernel 16 at each request: the Hopper body beside the f32 body
        for b in REQUESTS:
            c_args = combine[b] + bases
            res = _combine_turns(f"combine_cat B={b} (Bp {c_args[0].shape[0]})", c_args, ck, b)
        plain_ms = _cuda_ms(lambda: rh._combine_cat_plain(*c_args, **ck), 10)
        print(f"combine_cat B={BATCH}: plain {plain_ms:.3f} ms (cuBLAS f32 products, TF32 off)")
        for key, (err, ratio, ms, b_ms, b_by) in (("combine_cat", res["new"]),
                                                  ("combine_cat_exact", res["old"])):
            report[key] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms, plain_ms=plain_ms,
                               bound_ms=b_ms, bound_by=b_by, launches=0)
        Dv = hb.value_dim

    # ---- 7. the flagship path, through the entry point: the tower and the
    # combine on their Hopper bodies
    per_request = {"siren_tower": 1, "siren_tower_bf16": 1, "hier_scan": 1,
                   "hier_parts_family": 2, "combine_cat": 1}
    requests = [_random_coords(b, gen, dev) for b in REQUESTS]
    answers, launches = [], dict.fromkeys(per_request, 0)
    for c in requests:
        out, got = _drive(f"flagship B={c.shape[0]}: (bm, K, k_geo, j_sem) = "
                          f"{cfg.hier_plan(c.shape[0])}", lambda: _send(enc, c), per_request)
        answers.append(out)
        launches = {k: n + got[k] for k, n in launches.items()}
    print(f"flagship path launches: {launches}")
    for k in ("siren_tower_bf16", "hier_scan", "hier_parts_family", "combine_cat"):
        report[k]["launches"] = launches[k]

    for c, out in zip(requests, answers):
        B = c.shape[0]
        if out.shape != (B, 1280) or not torch.isfinite(out).all():
            raise AssertionError(f"flagship B={B}: shape {tuple(out.shape)} or non-finite")
        norm_err = (torch.linalg.norm(out[:, Dv:], dim=1) - 1.0).abs().max().item()
        if norm_err > 1e-5:
            raise AssertionError(f"flagship B={B}: query part not unit-norm ({norm_err:.2e})")

    # ---- 8. fidelity at B=10,000 against the exact f32 retrieve
    out = answers[-1]
    with torch.no_grad():
        ref = retrieval.retrieve(out[:, Dv:], lonlat_deg_to_xyz(requests[-1]), hb.bank,
                                 sem_temp=12.0, beta=0.5)
    rel = (out[:, :Dv] - ref).abs() / ref.abs().clamp_min(0.1)
    mean, p99 = rel.mean().item(), torch.quantile(rel.flatten()[::4], 0.99).item()
    print(f"flagship B={BATCH} relerr vs exact f32 retrieve: mean {mean:.5f} (bar 0.04), "
          f"p99 {p99:.5f} (bar 0.165; every 4th element)")
    if mean > 0.04 or p99 > 0.165:
        raise AssertionError("flagship fidelity outside its bars")

    e2e = _host_ms(lambda: enc(requests[-1]), 5)
    print(f"flagship RANGE+ end to end B={BATCH} (coords already on the card): "
          f"median {e2e:.3f} ms over 5 calls")
    _trace(lambda: enc(requests[-1]), 3, f"flagship B={BATCH}")
    return e2e, hb, enc, bank


def _row_logits(q2, ql, khl, mask, rows) -> torch.Tensor:
    """f64 hi/lo logits (q2 . khl + ql . kh + mask) of rows [Bp, k]."""
    kr = khl[rows.long()].double()
    Dk = ql.shape[1]
    return ((q2.double()[:, None, :] * kr).sum(-1)
            + (ql.double()[:, None, :] * kr[..., :Dk]).sum(-1)
            + mask[0, rows.long()].double())


def _compare_klist(name, got, ref, q2, ql, hb, tol, why):
    """Hold a kernel's (scores, rows) [Bp, k] to its plain version's: scores
    within tol, and rows equal wherever the kernel's row's logit is more
    than tol from the plain score at that position (a near-tie).  Prints
    the largest score error, its ratio to tol, the entries whose rows
    differ and how many of them are near-ties.  Returns (max abs error,
    error over tol)."""
    (gs, gr), (rs, rr) = [(s.reshape(s.shape[0], -1), r.reshape(r.shape[0], -1))
                          for s, r in (got, ref)]
    if gr.dtype != torch.int32 or gr.shape != rr.shape or not torch.isfinite(gs).all():
        raise AssertionError(f"{name}: rows {gr.dtype} {tuple(gr.shape)} or scores non-finite")
    err = (gs - rs).abs().max().item()
    off = gr != rr
    near = (_row_logits(q2, ql, hb.khl_sem, hb.mask_neg, gr) - rs.double()).abs() <= tol
    n_off, n_near = int(off.sum()), int((off & near).sum())
    print(f"{name}: max_abs_err {err:.3e}  err/tol {err / tol:.3e}  rows differing "
          f"{n_off} of {gr.numel()}, {n_near} of them near-ties within {tol:g}  "
          f"(tolerance {tol:g}: {why})")
    if err > tol or n_off != n_near:
        raise AssertionError(f"{name}: score error {err:.3e} or {n_off - n_near} rows off "
                             f"outside near-ties")
    return err, err / tol


def _klist_launch(args, kw, k: int, plan=None):
    """The Hopper top-k kernel and its fold (`_klist_kernel`, the unsorted
    list) with these arguments, ``plan`` overriding `_klist_plan`'s;
    counted nowhere."""
    from range_tpu_torch.ops import retrieval_hier as rh

    entry = "hier_argmax_sm90_launch" if k == 1 else "hier_topk_sm90_launch"
    return rh._klist_kernel(entry, *args, k=k, plan=plan, **kw)


def _klist_mma_sync(args, kw, k: int):
    """Kernels 10 and 11 on their mma.sync body (`csrc/hier_argmax.cu`, the
    body before the Hopper kernel), launched here alone as the same-run
    yardstick of `_klist_turns`: no path of the port reaches it, and it
    counts nowhere.  Returns the unsorted list (scores, rows) [Bp, k]."""
    from range_tpu_torch.kernels._build import load_kernel_library
    from range_tpu_torch.ops import retrieval_hier as rh

    q2, ql, khl, mask, idx = args
    Bp, K = q2.shape[0], idx.shape[1]
    scores = torch.empty((Bp, k), dtype=torch.float32, device=q2.device)
    rows = torch.empty((Bp, k), dtype=torch.int32, device=q2.device)
    lib = load_kernel_library("hier_argmax")
    ptrs = [t.data_ptr() for t in (q2, ql, khl, mask, idx, scores, rows)]
    shape = (Bp, kw["Dk"], kw["bm"], kw["bn"], K)
    rc = (lib.hier_argmax_launch(*ptrs, *shape, rh._stream(q2)) if k == 1
          else lib.hier_topk_launch(*ptrs, *shape, k, rh._stream(q2)))
    if rc != 0:
        raise RuntimeError(f"hier_argmax (mma.sync) launch failed: CUDA error {rc}")
    return scores, rows


def _klist_bound(args, kw, b: int, k: int):
    """(bound ms, what bounds it) of one argmax / top-k launch over b real
    queries: the hi/lo logits (3 Dk deep) over the selected tiles; the
    queries, the union of the selected tiles' keys and mask read once, the
    list written once."""
    q2, ql, khl, mask, idx = args
    Dk, bn, K = kw["Dk"], kw["bn"], idx.shape[1]
    U = int(torch.unique(idx).numel())
    flops = 2 * b * K * bn * 3 * Dk
    n_bytes = b * 3 * Dk * 2 + U * bn * (2 * Dk * 2 + 4) + b * k * 8
    return _bound(n_bytes, flops, BF16_FLOPS)


def _klist_request(q, x, hb, b: int):
    """The argmax / top-k operands of a `hier_topk` request of the first b
    queries at its own budget (`_topk_budget`: bm and K), as the endpoint
    makes them: queries padded, sorted, split hi/lo; the tiles its stats
    (over g_topk_cat, mode 'range') select.  Returns (args, kw)."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    k_tiles, bm, j_sem = rh._topk_budget(b, TOPK_K, 256, 6)
    q_s, q_x = rh._pad_queries(q[:b], x[:b], bm)
    order = rh._hybrid_order(q_x, b)
    q_cat = rf.pack_queries(q_s, None, 12.0, 40.0, hb.tier)[order].contiguous()
    qh, ql = rf._split_hilo(q_s)
    stats = rh._hier_scan_stats_call(q_cat, hb.g_topk_cat, hb.g_geo_cat,
                                     gpt_s=hb.bn // hb.topk_gsz, gpt_g=hb.bn // hb.gsz_geo)
    idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=k_tiles, bm=bm, n_valid=b,
                             j_sem=j_sem, mode="range")
    args = (torch.cat([qh, qh], 1)[order].contiguous(), ql[order].contiguous(), hb.khl_sem,
            hb.mask_neg, idx)
    return args, dict(Dk=hb.bank.key_dim, bm=bm, bn=hb.bn)


def _klist_turns(tag: str, args, kw, k: int, b: int, calls: int = 5) -> tuple:
    """The Hopper top-k kernel (with its fold) beside its mma.sync body
    (`_klist_mma_sync`) at one request, in turns body, kernel, kernel, body
    on CUDA events (`_turns_ms`; neither counted), with its bound and share
    (`_klist_bound`, b real queries).  A kernel slower than the body is
    printed as such.  Returns (the kernel's ms, the body's ms, bound ms,
    what bounds it)."""
    t = _turns_ms((("body", lambda: _klist_mma_sync(args, kw, k)),
                   ("kernel", lambda: _klist_launch(args, kw, k)),
                   ("kernel", lambda: _klist_launch(args, kw, k)),
                   ("body", lambda: _klist_mma_sync(args, kw, k))), calls)
    b_ms, b_by = _klist_bound(args, kw, b, k)
    slower = "" if t["kernel"] < t["body"] else "; SLOWER than the mma.sync body"
    print(f"{tag}: Hopper kernel {t['kernel']:.4f} ms, mma.sync body {t['body']:.4f} ms "
          f"(CUDA events, turns body, kernel, kernel, body; {t['body'] / t['kernel']:.2f}x); "
          f"bound {b_ms:.4f} ms ({b_by}), share {b_ms / t['kernel']:.4f}{slower}")
    return t["kernel"], t["body"], b_ms, b_by


def _klist_batches(q, x, hb, why: str) -> dict:
    """Kernels 10 and 11 on each batch of REQUESTS, each its own
    `hier_topk` request (`_klist_request`: its plan's bm and K), at k = 1
    and 8: held against the plain version (sorted as the wrappers sort,
    `_compare_klist`, 1e-5, rows off only at near-ties) and timed in turns
    beside the mma.sync body (`_klist_turns`); at B = 10,000 and 1,000 the
    kernel's time for each segment count is printed too.  Returns {k: the
    B = 10,000 turn's (ms, body ms, bound ms, what bounds it, max error,
    error over tolerance)}."""
    from range_tpu_torch.ops import retrieval_hier as rh

    out = {}
    for b in REQUESTS:
        args, kw = _klist_request(q, x, hb, b)
        K = args[4].shape[1]
        plan = rh._klist_plan(args[0].shape[0], kw["bm"], K, kw["bn"], kw["Dk"], 8)
        for k in (1, 8):
            tag = f"hier_{'argmax' if k == 1 else 'topk'} k={k} B={b} K={K} bm={kw['bm']}"
            err, ratio = _compare_klist(
                f"{tag} (plan {tuple(plan)}) vs plain",
                rh._sort_klist(*_klist_launch(args, kw, k)),
                rh._sort_klist(*rh._hier_klist_plain(*args, k=k, **kw)),
                args[0], args[1], hb, 1e-5, why)
            res = _klist_turns(tag, args, kw, k, b)
            if b == BATCH:
                out[k] = res + (err, ratio)
            if b in (SMALL_BATCH, BATCH):
                segs = sorted({n for n in (1, 2, 3, 4, 6, 8, 12, 16, 24, 36, 48, 72, 144)
                               if n <= K} | {plan.n_seg})
                times = [f"{n}: {_cuda_ms(lambda: _klist_launch(args, kw, k, plan._replace(n_seg=n)), 5):.4f}"
                         for n in segs]
                print(f"{tag}: ms by segments a list (CUDA events; the plan's {plan.n_seg}): "
                      + ", ".join(times))
    return out


def _tally(report: dict, launches: dict) -> None:
    """Add a phase's launch counts to the kernels line's rows, each second
    body's launches (`VARIANTS`) to its own row and not to its wrapper's."""
    own = dict(launches)
    for variant, parent in VARIANTS:
        own[parent] = own.get(parent, 0) - own.get(variant, 0)
    for k, n in own.items():
        if n:
            report[k]["launches"] += n


def _drive(tag: str, fn, expected: dict):
    """Run fn() with every launch count set to 0 just before, read them
    just after, and assert they equal `expected` (others 0)."""
    counters = _counters()
    for wrapper, attr in counters.values():
        setattr(wrapper, attr, 0)
    out = fn()
    torch.cuda.synchronize()
    got = {k: getattr(wrapper, attr) for k, (wrapper, attr) in counters.items()}
    want = {k: expected.get(k, 0) for k in counters}
    # a drive that names no body of the tower or the combine: every launch
    # on one of its two bodies (the bf16 mode's or the exact tier's, or
    # neither), as its model's settings route them
    for variant, parent in VARIANTS:
        if variant not in expected and got[variant] in (0, want[parent]):
            want[variant] = got[variant]
    print(f"{tag}: launches {got}")
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    return out, got


def _misses(q, hb, got, true) -> None:
    """Print what hier_topk's misses are: the f64 exact-logit gap between
    the true and the returned row, near-ties (gap < 1e-5, where the hi/lo
    logits, ~2^-17 relative per operand, may order them the other way)
    apart from the rest (the true row's tile was not selected)."""
    miss = (got != true).nonzero()[:, 0]
    if not miss.numel():
        return
    keys = hb.bank.keys_sem.double()
    qm = q[miss].double()
    gap = (qm * keys[true[miss].long()]).sum(1) - (qm * keys[got[miss].long()]).sum(1)
    near = int((gap < 1e-5).sum())
    print(f"hier_topk misses: {miss.numel()}, {near} near-ties (exact-logit gap < 1e-5), "
          f"{miss.numel() - near} outside the selected tiles; gaps "
          f"{sorted(round(g, 7) for g in gap.tolist())}")


def _recall_batches(dev, enc, hb, q0, x0, true0, rows0):
    """recall@1 of hier_topk at K = 48 (and, printed only, 56 and 64) on
    the main batch and four more batches of B random coordinates (seeds
    1-4).  One batch of 10,000 holds ~0-15 selection misses, so one batch
    is a noisy measurement of the rate; the bar is held on all five.
    Returns the K = 48 recall of each batch."""
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval, retrieval_hier as rh

    table = []
    for seed in range(5):
        if seed:
            coords = _random_coords(BATCH, torch.Generator(device=dev).manual_seed(seed), dev)
            with torch.no_grad():
                q = enc.model.query_embedding(coords).float()
            x, true = lonlat_deg_to_xyz(coords), retrieval.exact_nn(q, hb.bank)
            rows = rh.hier_topk(q, x, hb, k_tiles=TOPK_K)
        else:
            q, x, true, rows = q0, x0, true0, rows0
        table.append([(rows == true).float().mean().item()]
                     + [(rh.hier_topk(q, x, hb, k_tiles=K) == true).float().mean().item()
                        for K in (56, 64)])
    print(f"recall@1 hier_topk B={BATCH} (rows: query batch 0-4; columns K = {TOPK_K}, 56, "
          "64): " + "; ".join(" ".join(f"{r:.5f}" for r in row) for row in table))
    return [row[0] for row in table]


def topk_phases(dev, gen, report, hb, enc) -> float:
    """The top-k slice over the flagship HierBank: the stats, argmax and
    top-k kernels against their plain versions at hier_topk's shapes, the
    recall phase against the f32 exact_nn, the hier_nn harness, the
    hybrid-sorted retrieve_hier, each path's launches counted.  Returns the
    endpoint's host-clock ms at B=10,000."""
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    coords = _random_coords(BATCH, gen, dev)
    with torch.no_grad():
        q = enc.model.query_embedding(coords).float()
    x = lonlat_deg_to_xyz(coords)

    # ---- 9. the three kernels against their plain versions, hier_topk's shapes
    k_tiles, bm, j_sem = rh._topk_budget(BATCH, TOPK_K, 256, 6)
    q_s, q_x = rh._pad_queries(q, x, bm)
    order = rh._hybrid_order(q_x, BATCH)
    q_cat = rf.pack_queries(q_s, None, 12.0, 40.0, hb.tier)[order].contiguous()
    # hier_nn and the hybrid sort scan g_sem_cat with the locations packed,
    # so that operand's geo stats are held on real geo logits
    q_cat_xyz = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[order].contiguous()
    qh, ql = rf._split_hilo(q_s)
    q2, ql = torch.cat([qh, qh], 1)[order].contiguous(), ql[order].contiguous()
    gpt_g = hb.bn // hb.gsz_geo
    errs = []
    for operand, gpt, qc in (("g_topk_cat", hb.bn // hb.topk_gsz, q_cat),
                             ("g_sem_cat", hb.bn // hb.gsz_sem, q_cat_xyz)):
        args, kw = (qc, getattr(hb, operand), hb.g_geo_cat), dict(gpt_s=gpt, gpt_g=gpt_g)
        got = rh._hier_scan_stats_call(*args, **kw)
        ref = rh._hier_scan_stats_plain(*args, **kw)
        for i, stat in enumerate(("m_s", "s_s", "m_g", "s_g")):
            tag = f"hier_scan_stats[{operand}, gpt {gpt}] {stat}"
            errs.append(_compare(tag, got[i], ref[i], *(
                (1e-4, 0.0, "f32 sums of the same bf16 products in another order, |l| < 60")
                if stat[0] == "m" else (0.0, 1e-4, "f32 sums of f32 exp2 in another order"))))
        if operand == "g_topk_cat":  # hier_topk's operand
            stats = got
            ms = _cuda_ms(lambda: rh._hier_scan_stats_call(*args, **kw), 10)
            plain_ms = _cuda_ms(lambda: rh._hier_scan_stats_plain(*args, **kw), 3)
            print(f"hier_scan_stats[{operand}] B={BATCH}: kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms")
            ws, wg = hb.g_topk_cat.shape[1], hb.g_geo_cat.shape[1]
            Gs, Gg = hb.t_real * gpt, hb.t_real * gpt_g
            # the work needed: sem group logits over sem_d columns, geo over
            # the 9 real ones, over the real tiles; the four stats written
            flops = 2 * BATCH * (Gs * hb.sem_d + Gg * GEO_COLS)
            n_bytes = (BATCH * (ws + wg) * 2 + (Gs * ws + Gg * wg) * 2
                       + 4 * BATCH * hb.t_pad * 4)
            b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
            report["hier_scan_stats"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                             bound_by=b_by)
    report["hier_scan_stats"].update(max_abs_err=max(e for e, _ in errs),
                                     err_over_tol=max(r for _, r in errs))

    idx, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=k_tiles, bm=bm,
                             n_valid=BATCH, j_sem=j_sem, mode="range")
    K = idx.shape[1]
    why = ("f32 sums of 768 bf16 products, |l| <= ~1, in tensor-core and cuBLAS order; "
           "rows may differ only at near-ties")
    # the Hopper kernel beside its mma.sync body at B = 1, 37, 1,000, 10,000
    turns = _klist_batches(q, x, hb, why)
    for name, k in (("hier_argmax", 1), ("hier_topk", 8)):
        args = (q2, ql, hb.khl_sem, hb.mask_neg, idx)
        kw = dict(Dk=hb.bank.key_dim, bm=bm, bn=hb.bn)
        if k == 1:
            call, plain = rh._hier_argmax_call, rh._hier_argmax_plain
        else:
            call, plain = rh._hier_topk_call, rh._hier_topk_plain
            kw["k"] = k
        err, ratio = _compare_klist(f"{name} k={k} B={BATCH} K={K}", call(*args, **kw),
                                    plain(*args, **kw), q2, ql, hb, 1e-5, why)
        plain_ms = _cuda_ms(lambda: plain(*args, **kw), 3)
        ms, _, b_ms, b_by, t_err, t_ratio = turns[k]
        print(f"{name} k={k} B={BATCH} K={K}: kernel {ms:.4f} ms (and its fold; CUDA events "
              f"in turns), plain {plain_ms:.3f} ms")
        report[name] = dict(max_abs_err=max(err, t_err), err_over_tol=max(ratio, t_ratio),
                            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # ---- 10. the paths, each with its launches counted, and recall@1
    true = retrieval.exact_nn(q, hb.bank)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        true_tf32 = retrieval.exact_nn(q, hb.bank)
        with torch.no_grad():  # what the flag would do to a plain f32 product
            keys = hb.bank.keys_sem.float()
            loose = torch.cat([retrieval.first_argmax(q[lo:lo + 2048] @ keys.T
                                                      + hb.mask_neg[0])
                               for lo in range(0, BATCH, 2048)])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    print(f"exact_nn with TF32 on globally: {int((true_tf32 != true).sum())} rows differ "
          f"(a plain f32 argmax under TF32: {int((loose != true).sum())} of {BATCH})")
    if not torch.equal(true_tf32, true):
        raise AssertionError("exact_nn depends on the TF32 flag")

    small = SMALL_BATCH
    drives = {}
    rows1, drives["topk1"] = _drive(
        f"hier_topk k=1 B={BATCH} K={TOPK_K}",
        lambda: rh.hier_topk(q, x, hb, k_tiles=TOPK_K), {"hier_scan_stats": 1, "hier_argmax": 1})
    rows1s, drives["topk1s"] = _drive(
        f"hier_topk k=1 B={small} K={TOPK_K} (widened: {rh._topk_budget(small, TOPK_K, 256, 6)})",
        lambda: rh.hier_topk(q[:small], x[:small], hb, k_tiles=TOPK_K),
        {"hier_scan_stats": 1, "hier_argmax": 1})
    rows8, drives["topk8"] = _drive(
        f"hier_topk k=8 B={BATCH} K={TOPK_K}",
        lambda: rh.hier_topk(q, x, hb, k=8, k_tiles=TOPK_K), {"hier_scan_stats": 1, "hier_topk": 1})
    nn, drives["nn"] = _drive(
        f"hier_nn B={BATCH} K=32 j_sem=3",
        lambda: rh.hier_nn(q, x, hb, k_tiles=32, j_sem=3), {"hier_scan_stats": 1})
    bm_f, k_f, kg_f, j_f = enc.model.config.hier_plan(BATCH)
    hyb, drives["hybrid"] = _drive(
        f"retrieve_hier sort=hybrid B={BATCH} (bm {bm_f}, K {k_f}, k_geo {kg_f}, j_sem {j_f})",
        lambda: rh.retrieve_hier(q, x, hb, k_tiles=k_f, k_geo=kg_f, j_sem=j_f, bm=bm_f,
                                 sort="hybrid", concat_query=q),
        {"hier_scan_stats": 1, "hier_scan": 1, "hier_parts_family": 2, "combine_cat": 1})
    for name in ("hier_scan_stats", "hier_argmax", "hier_topk"):
        report[name]["launches"] = sum(d[name] for d in drives.values())

    rec_s = (rows1s == true[:small]).float().mean().item()
    rec_nn = (nn == true).float().mean().item()
    _misses(q, hb, rows1, true)
    recs = _recall_batches(dev, enc, hb, q, x, true, rows1)
    rec = sum(recs) / len(recs)
    print(f"recall@1 hier_topk vs f32 exact_nn, K={TOPK_K}: B={BATCH} batches "
          f"{' '.join(f'{r:.5f}' for r in recs)}, pooled over {len(recs) * BATCH} queries "
          f"{rec:.5f}; B={small} {rec_s:.5f} (bar >= {RECALL_BAR} on each of the two); "
          f"hier_nn (K=32, j_sem=3) {rec_nn:.5f}")
    if rows1.dtype != torch.int32 or rows8.shape != (BATCH, 8) or rec < RECALL_BAR \
            or rec_s < RECALL_BAR:
        raise AssertionError(f"hier_topk recall@1 {rec:.5f} / {rec_s:.5f} below {RECALL_BAR} "
                             f"or rows of the wrong type or shape")
    # k=8: the first column is the k=1 row up to near-ties, scores descend
    q2u = torch.cat([rf._split_hilo(q)[0]] * 2, 1)
    qlu = rf._split_hilo(q)[1]
    l8 = _row_logits(q2u, qlu, hb.khl_sem, hb.mask_neg, rows8)
    l1 = _row_logits(q2u, qlu, hb.khl_sem, hb.mask_neg, rows1[:, None])[:, 0]
    first_off = rows8[:, 0] != rows1
    gap = (l8[:, 0] - l1).abs()[first_off]
    gap = gap.max().item() if first_off.any() else 0.0
    rise = (l8[:, 1:] - l8[:, :-1]).max().item()
    print(f"hier_topk k=8: first column != the k=1 row in {int(first_off.sum())} queries "
          f"(largest logit gap there {gap:.3e}); largest rise along a row {rise:.3e}")
    if gap > 1e-5 or rise > 1e-5:
        raise AssertionError("hier_topk k=8 disagrees with k=1 or is not descending")
    ref = retrieval.retrieve(q, x, hb.bank, sem_temp=12.0, beta=0.5)
    Dv = hb.value_dim
    rel = (hyb[:, :Dv] - ref).abs() / ref.abs().clamp_min(0.1)
    if hyb.shape != (BATCH, Dv + q.shape[1]) or not torch.isfinite(hyb).all():
        raise AssertionError("retrieve_hier sort=hybrid: shape or non-finite")
    print(f"retrieve_hier sort=hybrid relerr vs exact f32 retrieve: mean {rel.mean().item():.5f}, "
          f"p99 {torch.quantile(rel.flatten()[::4], 0.99).item():.5f} (every 4th element)")

    topk_ms = _host_ms(lambda: rh.hier_topk(q, x, hb, k_tiles=TOPK_K), 5)
    print(f"hier_topk endpoint B={BATCH} K={TOPK_K} (queries on the card): median "
          f"{topk_ms:.3f} ms over 5 calls")
    _trace(lambda: rh.hier_topk(q, x, hb, k_tiles=TOPK_K), 3, f"hier_topk B={BATCH}")
    return topk_ms


def _block_queries(nB: int, bm: int, dev, n: int = BATCH) -> torch.Tensor:
    """Real queries of each selection block of bm sorted queries (the
    padded rows sort last), n of them in all."""
    return (n - torch.arange(nB, device=dev) * bm).clamp(0, bm).double()


def _rr_work(hbq, idx, bm: int, geo: bool, n: int, lr: bool = True, gw: int = 0):
    """(bytes, flops, exponentials) one call of kernel 14's rr shapes
    needs, counted from this run's selection: for each of the n real
    queries and each distinct tile of its block's list (a dedup_pad
    repeat once), the row logits over the family's real columns (sem_d,
    or the 9 geo ones) and az over the rr columns per valid row, the group
    logits over the real columns (or the sel sketch's gw) and alr over the
    lr coefficients and the count (lr) or Dv + the count (rr) per group;
    one exp2 per valid row and per group; each input read once (the
    queries' columns, the listed tiles' key, z and mask rows, their
    centroid and vw rows), the output written once."""
    bn, sem_d, Dv = hbq.bn, hbq.sem_d, hbq.value_dim
    gpt = bn // (hbq.gsz_geo if geo else hbq.gsz_sem)
    real = GEO_COLS if geo else sem_d
    gcols = gw or real
    rrp = (hbq.z_geo if geo else hbq.z_sem).shape[1]
    lrr = (hbq.lr_geo if geo else hbq.lr_rank) if lr else Dv
    W = ((hbq.g_geo_vw_lr if geo else hbq.g_sem_vw_lr) if lr
         else (hbq.g_geo_vw if geo else hbq.g_sem_vw)).shape[1]
    nB = idx.shape[0]
    keep = torch.ones_like(idx, dtype=torch.bool)
    keep[:, 1:] = idx[:, 1:] != idx[:, :-1]
    valid = (hbq.mask_neg[0] == 0).reshape(-1, bn).sum(dim=1).double()
    qb = _block_queries(nB, bm, idx.device, n)
    pairs = (qb * (valid[idx.long()] * keep).sum(dim=1)).sum().item()
    groups = (qb * keep.sum(dim=1)).sum().item() * gpt
    U = int(torch.unique(idx).numel())
    out_w = rrp + 128 + W if lr else lrr + 128 + rrp
    n_bytes = (n * (real + (gw if gw else 0)) * 2 + U * bn * ((real + rrp) * 2 + 4)
               + U * gpt * (gcols + W) * 2 + n * out_w * 4)
    flops = 2 * pairs * (real + rrp) + 2 * groups * (gcols + lrr + 1)
    return n_bytes, flops, int(pairs + groups)


def _rr_turn(tag: str, hbq, args, kw, n: int, why: str, lr: bool = True, gw: int = 0,
             body: bool = True, plain_time: bool = False, residue: bool = False):
    """One call of kernel 14's rr shapes (``kw`` with the geo family's
    geo_cols) held against its plain version over all the family's
    columns, segment by segment (`_compare_terms`, rows over the row cap
    in at most max(2, n / 100)), its zero columns exactly zero, and timed
    beside the mma.sync body (`_parts_times`) with its bound and
    exponentials from `_rr_work`; ``plain_time``: the plain version timed
    too (the kernels line's rows).

    ``residue`` (the lr shape at groups of one row): e and bf16(p) are the
    same row's exponential, computed twice, so alr = sum bf16(e - ps) vw
    is rounding residue (its row max ~1e-4 of the sum of |terms|) that a
    rounding of either side moves past the row cap in most rows.  There
    alr is held to its flip bound, 2^-7 x sum |terms| (one ulp of e and
    of bf16(p) times |vw|), in every row: a bound that its residue meets,
    and not a check of its arithmetic.  That check is the same launch with
    each group's centroid taken from the group before it (g_cat rolled one
    row), where e is another row's exponential and alr no residue: there
    alr is held to the terms rule with rows over the row cap in at most
    max(2, n / 100).  az keeps the terms rule in either case.
    Returns (the output, the errors, kernel ms, body ms, plain ms or 0,
    bytes, flops, exponentials)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    pkw = {k: v for k, v in kw.items() if k != "geo_cols"}
    got = rh._hier_parts_family_call(*args, **kw)
    ref = rh._hier_parts_family_plain(*args, **pkw)
    mag = rh._hier_parts_family_plain(*args, **pkw, magnitude=True)
    rrp, lrr = args[6].shape[1], kw["lrr"]
    if lr:  # az | 0 | alr
        segs, zero = (("az", slice(0, rrp)), ("alr", slice(rrp + 128, None))), (rrp, rrp + 128)
    else:  # acc | d | 0 | az
        segs = (("acc", slice(0, lrr)), ("d", slice(lrr, lrr + 1)),
                ("az", slice(lrr + 128, None)))
        zero = (lrr + 1, lrr + 128)
    rule, flip = max(2, n // 100), residue and lr
    errs = [_compare_terms(f"{tag} {name}", got[:, c], ref[:, c], mag[:, c],
                           why + ("; one-row groups: alr is rounding residue, every row held "
                                  "to the flip bound" if flip and name == "alr" else ""),
                           rows_off_max=got.shape[0] if flip and name == "alr" else rule)
            for name, c in segs]
    if flip:
        a, c = (*args[:4], args[4].roll(1, 0).contiguous(), *args[5:]), segs[-1][1]
        errs.append(_compare_terms(
            f"{tag} alr, each group's centroid the group before it's",
            rh._hier_parts_family_call(*a, **kw)[:, c],
            rh._hier_parts_family_plain(*a, **pkw)[:, c],
            rh._hier_parts_family_plain(*a, **pkw, magnitude=True)[:, c], why, rows_off_max=rule))
    if got[:, zero[0]:zero[1]].abs().max().item() != 0.0:
        raise AssertionError(f"{tag}: the d / pad columns not zero")
    plain_ms = (_cuda_ms(lambda: rh._hier_parts_family_plain(*args, **pkw), 2) if plain_time
                else 0.0)
    n_bytes, flops, n_exp = _rr_work(hbq, args[3], kw["bm"], kw["geo"], n, lr=lr, gw=gw)
    ms, old_ms = _parts_times(tag, args, kw, *_bound(n_bytes, flops, BF16_FLOPS), n_exp,
                              body=body)
    return got, errs, ms, old_ms or 0.0, plain_ms, n_bytes, flops, n_exp


def _rr_families(tag: str, hbq, qc, idx_s, idx_g, bm: int, n: int, why: str,
                 body: bool = True, plain_time: bool = False, residue: bool = False,
                 **extra):
    """Both families' rr + lr parts of one request shape through `_rr_turn`,
    and their sums printed beside the body's.  Returns ({family: output},
    the errors, [kernel ms, body ms, plain ms, bytes, flops, exponentials]
    summed)."""
    gpt_s, gpt_g = hbq.bn // hbq.gsz_sem, hbq.bn // hbq.gsz_geo
    out, errs, tot = {}, [], [0.0] * 6
    for fam, idx, g_cat, vw, z, gpt, lrr in (
            ("sem", idx_s, hbq.g_sem_cat, hbq.g_sem_vw_lr, hbq.z_sem, gpt_s, hbq.lr_rank),
            ("geo", idx_g, hbq.g_geo_cat, hbq.g_geo_vw_lr, hbq.z_geo, gpt_g, hbq.lr_geo)):
        geo = fam == "geo"
        args = (qc, hbq.k_cat, hbq.mask_neg, idx, g_cat, vw, z)
        kw = dict(sem_d=hbq.sem_d, bm=bm, bn=hbq.bn, gpt=gpt, geo=geo, lrr=lrr,
                  geo_cols=GEO_COLS if geo else None, **extra)
        res = _rr_turn(f"hier_parts_family[{fam}] {tag} K={idx.shape[1]} bm={bm}", hbq, args,
                       kw, n, why, body=body, plain_time=plain_time,
                       residue=residue and not geo)
        out[fam] = (res[0], args, kw)
        errs += res[1]
        tot = [a + b for a, b in zip(tot, res[2:])]
    b_ms, b_by = _bound(tot[3], tot[4], BF16_FLOPS)
    vs = f", mma.sync body {tot[1]:.4f} ms ({tot[1] / tot[0]:.2f}x)" if body else ""
    print(f"hier_parts_family[sem + geo] {tag}: Hopper kernel {tot[0]:.4f} ms{vs}; bound "
          f"{b_ms:.4f} ms ({b_by}), share {b_ms / tot[0]:.4f}; exp2 floor "
          f"{_exp_ms(int(tot[5])):.4f} ms; SM clock after the turns "
          f"{_sm_clock_mhz()[0]:.0f} MHz")
    return out, errs, tot


def range_phases(dev, gen, report, hb, enc_plus, bank) -> float:
    """The hierarchical RANGE slice and int8 HierBanks: build the bank's
    int8 HierBank on the card; hold the geo-less scan and the merged parts
    kernel (both geo settings, bf16 and int8 values) against their plain
    versions at the RANGE flagship's shapes; serve RANGE through
    load_model(profile="flagship") over the RANGE+ phase's HierBank with
    its launches counted; check its relerr against the exact f32 retrieve
    and the int8 flagship models against the bf16 ones.  Returns the RANGE
    flagship end-to-end ms at B=10,000."""
    from range_tpu_torch import load_model
    from range_tpu_torch.api import SERVING_PROFILES
    from range_tpu_torch.bank import quantize_values
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    prof = SERVING_PROFILES["flagship"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hb8 = rh.build_hier_bank(quantize_values(bank), bn=512, gsz_sem=prof["gsz_sem"],
                             gsz_geo=64, lr_rank=prof["lr_rank"], lr_geo=prof["lr_geo"],
                             res_rank=prof["res_rank"], topk_gsz=prof["topk_gsz"])
    torch.cuda.synchronize()
    print(f"int8 HierBank build (flagship knobs): {time.perf_counter() - t0:.2f} s; "
          f"t_real {hb8.t_real}")
    for tag, h in (("bf16", hb), ("int8", hb8)):
        n = h.values.numel() * h.values.element_size()
        n += 0 if h.value_scale is None else h.value_scale.numel() * 4
        print(f"HierBank value operand on the card ({tuple(h.values.shape)}), {tag}: "
              f"{n / 1e6:.3f} MB")

    enc = load_model("RANGE", db_path=hb, profile="flagship", device="cuda")
    cfg = enc.model.config
    bm, k_tiles, _, j_sem = cfg.hier_plan(BATCH)
    coords = _random_coords(BATCH, gen, dev)
    gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo

    def operands(hbq, b=BATCH):
        """RANGE's packed queries (the first b) in its home-tile order, the
        same queries with their locations packed (the geo family live, for
        GEO=true), the scan's outputs, the selection at b's plan, its bm."""
        bm_b, k_b, _, j_b = cfg.hier_plan(b)
        q_s, q_x = rh._pad_queries(q[:b], x[:b], bm_b)
        q0 = rf.pack_queries(q_s, None, 15.0, 40.0, hbq.tier)
        home = rh._home_tile(rh._hier_scan_stats_call(
            q0, hbq.g_sem_cat, hbq.g_geo_cat, gpt_s=gpt_s, gpt_g=gpt_g)[0], hbq.t_real)
        order = rh._hybrid_order(None, b, home, hbq.t_pad)
        qc = q0[order].contiguous()
        qx = rf.pack_queries(q_s, q_x, 15.0, 40.0, hbq.tier)[order].contiguous()
        scan = rh._hier_scan_call(qc, hbq.g_sem_cat, hbq.g_geo_cat, hbq.g_sem_vw_lr,
                                  hbq.g_geo_vw, gpt_s=gpt_s, gpt_g=gpt_g, has_geo=False)
        idx, _ = rh.select_tiles(scan[0], scan[1], None, None, t_real=hbq.t_real,
                                 k_tiles=k_b, bm=bm_b, n_valid=b, j_sem=j_b,
                                 j_geo=cfg.j_geo, mode="range")
        return qc, qx, idx, bm_b

    flip = ("bf16 weights (p times the row's scale, e - ps) can round the other way "
            "where the logits' f32 summation order moves them across a bf16 boundary: "
            "one ulp of one term")
    with torch.no_grad():
        q = enc.model.query_embedding(coords)
        x = lonlat_deg_to_xyz(coords)
        # ---- 11. the geo-less scan (a variant of kernel 8) and kernel 15
        qc, _, _, _ = operands(hb)
        sargs = (qc, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw)
        skw = dict(gpt_s=gpt_s, gpt_g=gpt_g, has_geo=False)
        got = rh._hier_scan_call(*sargs, **skw)
        ref = rh._hier_scan_plain(*sargs, **skw)
        mag = rh._hier_scan_plain(qc, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(),
                                  hb.g_geo_vw, **skw)[4]
        _compare("hier_scan[has_geo=False] m_s", got[0], ref[0], 1e-4, 0.0,
                 "f32 sums of the same bf16 products in another order, |l| < 60")
        _compare("hier_scan[has_geo=False] s_s", got[1], ref[1], 0.0, 1e-4,
                 "f32 sums of f32 exp2 in another order")
        _compare_terms("hier_scan[has_geo=False] tails[sem]", got[4], ref[4], mag, flip)
        if got[2] is not None or got[4].shape[1] != hb.g_sem_vw_lr.shape[1]:
            raise AssertionError("the geo-less scan returned geo outputs")
        plain_ms = _cuda_ms(lambda: rh._hier_scan_plain(*sargs, **skw), 3)
        # the sem-only work: group logits over sem_d columns, tails over the
        # lr coefficients and the count, two stats, over the real tiles
        Gs, ws_, Ws_ = hb.t_real * gpt_s, hb.g_sem_cat.shape[1], hb.g_sem_vw_lr.shape[1]
        b_ms, b_by = _bound(BATCH * ws_ * 2 + Gs * (ws_ + Ws_) * 2 + 2 * BATCH * hb.t_pad * 4
                            + BATCH * Ws_ * 4, 2 * BATCH * Gs * (hb.sem_d + hb.lr_rank + 1),
                            BF16_FLOPS)
        _scan_times(f"hier_scan[has_geo=False] B={BATCH}", sargs, skw, b_ms, b_by, BATCH * Gs)
        print(f"hier_scan[has_geo=False] B={BATCH}: plain {plain_ms:.3f} ms")

        Dv, Ws = hb.value_dim, hb.g_sem_vw_lr.shape[1]
        segs = {"acc_s": slice(0, Dv), "d_s": slice(2 * Dv, 2 * Dv + 1),
                "alr": slice(2 * Dv + 128, 2 * Dv + 128 + Ws)}
        geo_segs = {"acc_g": slice(Dv, 2 * Dv), "d_g": slice(2 * Dv + 1, 2 * Dv + 2)}
        for quant, hbq in (("bf16", hb), ("int8", hb8)):
            qc, qx, idx, _ = operands(hbq)
            for geo in (False, True):
                args = ((qx if geo else qc), hbq.k_cat, hbq.values, hbq.value_scale,
                        hbq.mask_neg, idx, hbq.g_sem_cat, hbq.g_geo_cat, hbq.g_sem_vw_lr,
                        hbq.g_geo_vw)
                kw = dict(sem_d=hbq.sem_d, bm=bm, bn=hbq.bn, gpt_s=gpt_s, gpt_g=gpt_g,
                          geo=geo)
                tag = f"hier_parts[{quant}, GEO={str(geo).lower()}]"
                got = rh._hier_parts_call(*args, **kw)
                ref = rh._hier_parts_plain(*args, **kw)
                mag = rh._hier_parts_plain(*args, **kw, magnitude=True)
                errs = [_compare_terms(f"{tag} {name}", got[:, cols], ref[:, cols],
                                       mag[:, cols], flip, rows_off_max=max(2, BATCH // 100))
                        for name, cols in {**segs, **(geo_segs if geo else {})}.items()]
                zero = [got[:, 2 * Dv + 2:2 * Dv + 128]] + (
                    [] if geo else [got[:, Dv:2 * Dv], got[:, 2 * Dv + 1:2 * Dv + 2]])
                if any(z.abs().max().item() != 0.0 for z in zero):
                    raise AssertionError(f"{tag}: the pad (or skipped geo) columns not zero")
                k_ms, _, b_ms, b_by = _values_turns(f"{tag} B={BATCH} K={idx.shape[1]} bm={bm}",
                                                    args, kw, True, BATCH)
                p_ms = _cuda_ms(lambda: rh._hier_parts_plain(*args, **kw), 2)
                print(f"{tag} B={BATCH} K={idx.shape[1]} bm={bm}: plain {p_ms:.3f} ms")
                if not geo:  # the RANGE flagship's launch at B = 1, 37, 1,000
                    for b in REQUESTS[:-1]:
                        qc_b, _, idx_b, bm_b = operands(hbq, b)
                        a_b = (qc_b,) + args[1:5] + (idx_b,) + args[6:]
                        kw_b = dict(kw, bm=bm_b)
                        _compare_terms(f"{tag} B={b} vs plain", rh._hier_parts_call(*a_b, **kw_b),
                                       rh._hier_parts_plain(*a_b, **kw_b),
                                       rh._hier_parts_plain(*a_b, **kw_b, magnitude=True), flip,
                                       rows_off_max=max(2, b // 100))
                        _values_turns(f"{tag} B={b} K={idx_b.shape[1]} bm={bm_b}", a_b, kw_b,
                                      True, b)
                    if quant == "bf16":
                        _values_drift(f"{tag} B={BATCH}", args, kw, True, ref, mag, flip)
                if quant == "bf16" and not geo:  # the RANGE flagship's launch
                    report["hier_parts"] = dict(
                        max_abs_err=max(e for e, _ in errs),
                        err_over_tol=max(r for _, r in errs), ms=k_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by)
                else:
                    report["hier_parts"]["max_abs_err"] = max(
                        report["hier_parts"]["max_abs_err"], *(e for e, _ in errs))
                    report["hier_parts"]["err_over_tol"] = max(
                        report["hier_parts"]["err_over_tol"], *(r for _, r in errs))

    # ---- 12. the RANGE flagship path, through the entry point
    per_request = {"siren_tower": 1, "hier_scan_stats": 1, "hier_scan": 1, "hier_parts": 1}
    requests = [_random_coords(b, gen, dev) for b in REQUESTS]
    answers, launches = [], dict.fromkeys(per_request, 0)
    for c in requests:
        out, got = _drive(f"RANGE flagship B={c.shape[0]}: (bm, K, k_geo, j_sem) = "
                          f"{cfg.hier_plan(c.shape[0])}", lambda: _send(enc, c), per_request)
        answers.append(out)
        launches = {k: n + got[k] for k, n in launches.items()}
        with torch.no_grad():
            unit = enc.model.query_embedding(c)
        if out.shape != (c.shape[0], 1280) or not torch.isfinite(out).all():
            raise AssertionError(f"RANGE flagship B={c.shape[0]}: shape or non-finite")
        q_err = (out[:, Dv:] - unit).abs().max().item()
        if q_err > 1e-6:
            raise AssertionError(f"RANGE flagship B={c.shape[0]}: the query half is not "
                                 f"the unit query ({q_err:.2e})")
    print(f"RANGE flagship path launches: {launches}")
    report["hier_parts"]["launches"] = launches["hier_parts"]
    for k in ("hier_scan", "hier_scan_stats"):  # both flagship paths launch these
        report[k]["launches"] += launches[k]

    out = answers[-1]
    with torch.no_grad():
        ref = retrieval.retrieve(out[:, Dv:], None, hb.bank, sem_temp=15.0, mode="range")
    rel = (out[:, :Dv] - ref).abs() / ref.abs().clamp_min(0.1)
    mean, p99 = rel.mean().item(), torch.quantile(rel.flatten()[::4], 0.99).item()
    print(f"RANGE flagship B={BATCH} relerr vs exact f32 retrieve(mode='range'): mean "
          f"{mean:.5f} (bar 0.10, tests/test_hier.py:128-135), p99 {p99:.5f} (every 4th "
          "element)")
    if mean > 0.10:
        raise AssertionError("RANGE flagship fidelity outside its bar")

    # ---- 13. both flagship models over the int8 HierBank, against bf16
    for name, enc16, want in (
            ("RANGE", enc, per_request),
            ("RANGE+", enc_plus, {"siren_tower": 1, "hier_scan": 1, "hier_parts_family": 2,
                                  "combine_cat": 1})):
        enc8 = load_model(name, db_path=hb8, profile="flagship", value_quant="int8",
                          device="cuda")
        out8, _ = _drive(f"{name} flagship int8 B={BATCH}", lambda: enc8(requests[-1]), want)
        out16 = enc16(requests[-1])
        rel = (out8[:, :Dv] - out16[:, :Dv]).abs() / out16[:, :Dv].abs().clamp_min(0.1)
        print(f"{name} flagship int8 vs bf16 HierBank B={BATCH}: relerr mean "
              f"{rel.mean().item():.5f} (bar < 0.01, tests/test_hier.py:139-149), p99 "
              f"{torch.quantile(rel.flatten()[::4], 0.99).item():.5f}; int8 end to end "
              f"{_host_ms(lambda: enc8(requests[-1]), 5):.3f} ms")
        if not torch.isfinite(out8).all() or rel.mean().item() >= 0.01:
            raise AssertionError(f"{name} flagship int8 against bf16 outside its bar")

    e2e = {c.shape[0]: _host_ms(lambda: enc(c), 5) for c in requests[1:]}
    print("RANGE flagship end to end (coords already on the card), median of 5 calls: "
          + ", ".join(f"B={b} {ms:.3f} ms" for b, ms in e2e.items()))
    _trace(lambda: enc(requests[-1]), 3, f"RANGE flagship B={BATCH}")
    return e2e[BATCH]


def tail_super_phases(dev, gen, report, bank, enc_plus) -> float:
    """The weighted-supergroup sem tail on the flagship: build the
    informative bank's tail_super HierBank on the card; hold the scan's
    segment-sum variant and the correction kernel against their plain
    versions at the flagship's B=10,000 shapes; serve load_model("RANGE+",
    profile="flagship", tail_super=64, m_corr=32) with its launches
    counted; hold its relerr against the exact f32 retrieve to the
    flagship bars.  Returns (its end-to-end ms at B=10,000, its
    HierBank)."""
    from range_tpu_torch import load_model
    from range_tpu_torch.api import SERVING_PROFILES
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    # ---- 13b. the tail_super HierBank, built on the card
    prof = SERVING_PROFILES["flagship"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hb = rh.build_hier_bank(bank, bn=512, gsz_sem=prof["gsz_sem"], gsz_geo=64,
                            lr_rank=prof["lr_rank"], lr_geo=prof["lr_geo"],
                            res_rank=prof["res_rank"], topk_gsz=prof["topk_gsz"],
                            tail_super=TAIL_SUPER)
    torch.cuda.synchronize()
    print(f"build_hier_bank (flagship knobs, tail_super={TAIL_SUPER}): "
          f"{time.perf_counter() - t0:.2f} s; g_sem_ts_vw {tuple(hb.g_sem_ts_vw.shape)}, "
          f"g_sem_ts_dvw {tuple(hb.g_sem_ts_dvw.shape)}")
    enc = load_model("RANGE+", db_path=hb, profile="flagship", tail_super=TAIL_SUPER,
                     m_corr=M_CORR, device="cuda")
    cfg = enc.model.config
    bm, k_tiles, k_geo, j_sem = cfg.hier_plan(BATCH)
    coords = _random_coords(BATCH, gen, dev)
    gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
    sup_r = hb.tail_super // hb.gsz_sem
    flip = ("an exp2 (or a supergroup's f32 sum of them) within the logits' f32 "
            "difference of a bf16 boundary rounds the other way: one ulp of one term")
    with torch.no_grad():
        q = enc.model.query_embedding(coords)
        x = lonlat_deg_to_xyz(coords)
        q_s, q_x = rh._pad_queries(q, x, bm)
        order = rh._hybrid_order(q_x, BATCH)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[order].contiguous()

        # ---- 13c. the scan's segment-sum variant and the correction kernel
        args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_ts_vw, hb.g_geo_vw_lr)
        kw = dict(gpt_s=gpt_s, gpt_g=gpt_g, sup_r=sup_r)
        got = rh._hier_scan_call(*args, **kw)
        ref = rh._hier_scan_plain(*args, **kw)
        mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_ts_vw.abs(),
                                  hb.g_geo_vw_lr.abs(), **kw)[4]
        Ws, Wg = hb.g_sem_ts_vw.shape[1], hb.g_geo_vw_lr.shape[1]
        tag = f"hier_scan[sup_r={sup_r}]"
        errs = [_compare(f"{tag} {stat}", got[i], ref[i], *(
                    (1e-4, 0.0, "f32 sums of the same bf16 products in another order")
                    if stat[0] == "m" else (0.0, 1e-4, "f32 sums of f32 exp2 in another order")))
                for i, stat in enumerate(("m_s", "s_s", "m_g", "s_g"))]
        errs += [_compare_terms(f"{tag} tails[sem]", got[4][:, :Ws], ref[4][:, :Ws],
                                mag[:, :Ws], flip),
                 _compare_terms(f"{tag} tails[geo]", got[4][:, Ws:], ref[4][:, Ws:],
                                mag[:, Ws:], flip)]
        plain_ms = _cuda_ms(lambda: rh._hier_scan_plain(*args, **kw), 3)
        Gs, Gg = hb.t_real * gpt_s, hb.t_real * gpt_g
        ws, wg = hb.g_sem_cat.shape[1], hb.g_geo_cat.shape[1]
        # the work needed: sem group logits over sem_d columns, geo over the
        # 9 real ones; the sem tail over Gs / sup_r supergroup rows of lr
        # coefficients and the count (the sums of sup_r exponentials left
        # out with the exponentials), the geo tail as the scan's
        flops = 2 * BATCH * (Gs * hb.sem_d + Gs // sup_r * (hb.lr_rank + 1)
                             + Gg * (GEO_COLS + hb.lr_geo + 1))
        n_bytes = (BATCH * (ws + wg) * 2 + (Gs * ws + Gs // sup_r * Ws + Gg * (wg + Wg)) * 2
                   + 4 * BATCH * hb.t_pad * 4 + BATCH * (Ws + Wg) * 4)
        b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
        ms = _scan_times(f"{tag} B={BATCH}", args, kw, b_ms, b_by, BATCH * (Gs + Gg))
        print(f"{tag} B={BATCH}: plain {plain_ms:.3f} ms")
        report["hier_scan_sup"] = dict(max_abs_err=max(e for e, _ in errs),
                                       err_over_tol=max(r for _, r in errs), ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

        m_s, s_s, m_g, s_g, _ = got
        idx_sm, _ = rh.select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real,
                                    k_tiles=k_tiles + M_CORR, bm=bm, n_valid=BATCH,
                                    j_sem=j_sem, j_geo=cfg.j_geo, mode="range")
        cargs, ckw = (q_cat, idx_sm, hb.g_sem_cat, hb.g_sem_ts_dvw), dict(bm=bm, gpt=gpt_s)
        nB, M = idx_sm.shape
        tag = f"hier_corr B={BATCH} K+m_corr={M} bm={bm}"
        err, ratio = _compare_terms(
            tag, rh._hier_corr_call(*cargs, **ckw), rh._hier_corr_plain(*cargs, **ckw),
            rh._hier_corr_plain(*cargs, **ckw, magnitude=True),
            "bf16 weights of f32 logits summed in another order: one ulp of one term",
            rows_off_max=max(2, BATCH // 100))
        ms = _cuda_ms(lambda: rh._hier_corr_call(*cargs, **ckw), 10)
        plain_ms = _cuda_ms(lambda: rh._hier_corr_plain(*cargs, **ckw), 3)
        W = hb.g_sem_ts_dvw.shape[1]
        U = int(torch.unique(idx_sm).numel())  # tiles read, each once
        groups = (_block_queries(nB, bm, dev) * M).sum().item() * gpt_s
        # the work needed: group logits over sem_d columns and the product
        # over the lr coefficients and the count, for each real query's
        # listed tiles; the listed tiles' centroid and dvw rows read once
        b_ms, b_by = _bound(BATCH * hb.sem_d * 2 + U * gpt_s * (ws + W) * 2 + BATCH * W * 4,
                            2 * groups * (hb.sem_d + hb.lr_rank + 1), BF16_FLOPS)
        print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); {U} distinct tiles listed")
        report["hier_corr"] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                   plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        # kernel 14 at the tail_super flagship: the list's first k_tiles exact
        idx_gt, _ = rh.select_tiles(m_g, s_g, m_s, s_s, t_real=hb.t_real, k_tiles=k_geo, bm=bm,
                                    n_valid=BATCH, j_sem=cfg.j_geo, j_geo=j_sem, mode="range")
        _rr_families(f"tail_super B={BATCH}", hb, q_cat, idx_sm[:, :k_tiles].contiguous(),
                     idx_gt, bm, BATCH, "bf16(p) and bf16(e - ps/cnt) can round the other way "
                     "where the logits' f32 summation order moves them across a bf16 boundary: "
                     "one ulp of one term")

    # ---- 13d. the tail_super flagship, through the entry point
    per_request = {"siren_tower": 1, "hier_scan": 1, "hier_scan_sup": 1, "hier_corr": 1,
                   "hier_parts_family": 2, "combine_cat": 1}
    requests = [_random_coords(b, gen, dev) for b in REQUESTS]
    answers, launches = [], dict.fromkeys(per_request, 0)
    for c in requests:
        out, got = _drive(f"tail_super flagship B={c.shape[0]}: (bm, K, k_geo, j_sem) = "
                          f"{cfg.hier_plan(c.shape[0])}, m_corr {M_CORR}",
                          lambda: _send(enc, c), per_request)
        answers.append(out)
        launches = {k: n + got[k] for k, n in launches.items()}
        if out.shape != (c.shape[0], 1280) or not torch.isfinite(out).all():
            raise AssertionError(f"tail_super flagship B={c.shape[0]}: shape or non-finite")
    print(f"tail_super flagship path launches: {launches}")
    for k in ("hier_scan_sup", "hier_corr"):
        report[k]["launches"] = launches[k]
    for k in ("hier_scan", "hier_parts_family", "combine_cat"):
        report[k]["launches"] += launches[k]

    Dv = hb.value_dim
    out = answers[-1]
    with torch.no_grad():
        ref = retrieval.retrieve(out[:, Dv:], lonlat_deg_to_xyz(requests[-1]), hb.bank,
                                 sem_temp=12.0, beta=0.5)
    rel = (out[:, :Dv] - ref).abs() / ref.abs().clamp_min(0.1)
    mean, p99 = rel.mean().item(), torch.quantile(rel.flatten()[::4], 0.99).item()
    base = enc_plus(requests[-1])  # the one-level flagship, same coordinates
    with torch.no_grad():
        ref0 = retrieval.retrieve(base[:, Dv:], lonlat_deg_to_xyz(requests[-1]),
                                  enc_plus.model.bank.bank, sem_temp=12.0, beta=0.5)
    rel0 = (base[:, :Dv] - ref0).abs() / ref0.abs().clamp_min(0.1)
    print(f"tail_super flagship B={BATCH} relerr vs exact f32 retrieve: mean {mean:.5f} "
          f"(bar 0.04), p99 {p99:.5f} (bar 0.165; every 4th element); the one-level "
          f"flagship on the same coordinates: mean {rel0.mean().item():.5f}, p99 "
          f"{torch.quantile(rel0.flatten()[::4], 0.99).item():.5f}")
    if mean > 0.04 or p99 > 0.165:
        raise AssertionError("tail_super flagship fidelity outside its bars")
    e2e = {c.shape[0]: _host_ms(lambda: enc(c), 5) for c in requests[1:]}
    print("tail_super flagship end to end (coords already on the card), median of 5 "
          "calls: " + ", ".join(f"B={b} {ms:.3f} ms" for b, ms in e2e.items())
          + f"; the one-level flagship B={BATCH} {_host_ms(lambda: enc_plus(requests[-1]), 5):.3f}"
          " ms")
    _trace(lambda: enc(requests[-1]), 3, f"tail_super flagship B={BATCH}")
    return e2e[BATCH], hb


def two_level_topk_phases(dev, gen, report, bank, enc) -> float:
    """The two-level top-k endpoint: build the informative bank's
    two-level HierBank (bn 512, gsz_sem 8, gsz_geo 64, gsz_super 64) on
    the card; hold the refine kernel (and the stats scan over g_sup_cat)
    against their plain versions at hier_topk's B=10,000 shapes (K=48,
    M=96); drive hier_topk (k = 1, 8; B = 10,000 and 1,000) with its
    launches counted; print recall@1 against the f32 exact_nn, pooled over
    five batches, beside the one-level selection over the same HierBank
    (g_sem_cat) at the same K, and hold the two-level result to at least
    the one-level one - 0.001.  Returns (the endpoint's ms at B=10,000,
    the two-level HierBank)."""
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    # ---- 13e. the two-level HierBank, built on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hb = rh.build_hier_bank(bank, bn=512, gsz_sem=8, gsz_geo=64, gsz_super=GSZ_SUPER)
    torch.cuda.synchronize()
    print(f"build_hier_bank (two-level: bn 512, gsz_sem 8, gsz_geo 64, gsz_super "
          f"{GSZ_SUPER}): {time.perf_counter() - t0:.2f} s; g_sup_cat "
          f"{tuple(hb.g_sup_cat.shape)}, g_sem_cat {tuple(hb.g_sem_cat.shape)}")
    one = dataclasses.replace(hb, gsz_super=0, g_sup_cat=None)  # its g_sem_cat branch
    coords = _random_coords(BATCH, gen, dev)
    with torch.no_grad():
        q = enc.model.query_embedding(coords).float()
    x = lonlat_deg_to_xyz(coords)

    # ---- 13f. the refine kernel (and the coarse stats) at hier_topk's shapes
    k_tiles, bm, j_sem = rh._topk_budget(BATCH, TOPK_K, 256, 6)
    mt = min(TOPK_M, hb.t_real)
    gpt_f, gpt_sup, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_super, hb.bn // hb.gsz_geo
    q_s, q_x = rh._pad_queries(q, x, bm)
    order = rh._hybrid_order(q_x, BATCH)
    q_cat = rf.pack_queries(q_s, None, 12.0, 40.0, hb.tier)[order].contiguous()
    sargs, skw = (q_cat, hb.g_sup_cat, hb.g_geo_cat), dict(gpt_s=gpt_sup, gpt_g=gpt_g)
    stats = rh._hier_scan_stats_call(*sargs, **skw)
    for i, (stat, a, b) in enumerate(zip(("m_s", "s_s", "m_g", "s_g"), stats,
                                         rh._hier_scan_stats_plain(*sargs, **skw))):
        _compare(f"hier_scan_stats[g_sup_cat, gpt {gpt_sup}] {stat}", a, b, *(
            (1e-4, 0.0, "f32 sums of the same bf16 products in another order")
            if stat[0] == "m" else (0.0, 1e-4, "f32 sums of f32 exp2 in another order")))
    idx_m, _ = rh.select_tiles(*stats, t_real=hb.t_real, k_tiles=mt, bm=bm, n_valid=BATCH,
                               j_sem=j_sem, mode="range")
    rargs = (q_cat, idx_m, hb.g_sem_cat, hb.g_sup_cat, None, None)
    rkw = dict(bm=bm, gpt_f=gpt_f, gpt_sup=gpt_sup, stats_only=True)
    got = rh._hier_refine_call(*rargs, **rkw)
    ref = rh._hier_refine_plain(q_cat, idx_m, hb.g_sem_cat, bm=bm, gpt_f=gpt_f)
    nB, M = idx_m.shape
    tag = f"hier_refine B={BATCH} M={M} gpt_f={gpt_f} bm={bm}"
    errs = [_compare(f"{tag} m_f", got[0], ref[0], 1e-4, 0.0,
                     "f32 sums of the same bf16 products in another order, |l| < 60"),
            _compare(f"{tag} s_f", got[1], ref[1], 0.0, 1e-4,
                     "f32 sums of f32 exp2 in another order")]
    ms = _cuda_ms(lambda: rh._hier_refine_call(*rargs, **rkw), 10)
    plain_ms = _cuda_ms(lambda: rh._hier_refine_plain(q_cat, idx_m, hb.g_sem_cat, bm=bm,
                                                      gpt_f=gpt_f), 3)
    U = int(torch.unique(idx_m).numel())
    groups = (_block_queries(nB, bm, dev) * M).sum().item() * gpt_f
    # the work needed: the fine logits over sem_d columns for each real
    # query's listed tiles; the listed tiles' centroids read once, the two
    # stats written
    b_ms, b_by = _bound(BATCH * hb.sem_d * 2 + U * gpt_f * hb.g_sem_cat.shape[1] * 2
                        + 2 * BATCH * M * 4, 2 * groups * hb.sem_d, BF16_FLOPS)
    print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by}); {U} distinct tiles listed")
    report["hier_refine"] = dict(max_abs_err=max(e for e, _ in errs),
                                 err_over_tol=max(r for _, r in errs), ms=ms,
                                 plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # ---- 13g. the endpoint, with its launches counted, and recall@1
    small = SMALL_BATCH
    kw = dict(k_tiles=TOPK_K, m_tiles=TOPK_M)
    drives = {}
    for k, b in ((1, BATCH), (1, small), (8, BATCH), (8, small)):
        rows, drives[(k, b)] = _drive(
            f"two-level hier_topk k={k} B={b} K={TOPK_K} M={TOPK_M}",
            lambda: rh.hier_topk(q[:b], x[:b], hb, k=k, **kw),
            {"hier_scan_stats": 1, "hier_refine": 1,
             ("hier_argmax" if k == 1 else "hier_topk"): 1})
        if rows.dtype != torch.int32 or rows.shape != ((b,) if k == 1 else (b, k)):
            raise AssertionError(f"two-level hier_topk k={k}: rows {rows.dtype} "
                                 f"{tuple(rows.shape)}")
        if (k, b) == (1, BATCH):
            rows1 = rows
        elif (k, b) == (1, small):
            rows1s = rows
    report["hier_refine"]["launches"] = sum(d["hier_refine"] for d in drives.values())
    for name in ("hier_scan_stats", "hier_argmax", "hier_topk"):
        report[name]["launches"] += sum(d[name] for d in drives.values())

    # ---- 13h. recall@1: two-level (M = 96, and M = every tile), one-level
    table = []
    full = dict(k_tiles=TOPK_K, m_tiles=hb.t_real)
    for seed in range(5):  # the main batch and four more (seeds 1-4)
        if seed:
            c = _random_coords(BATCH, torch.Generator(device=dev).manual_seed(seed), dev)
            with torch.no_grad():
                qb = enc.model.query_embedding(c).float()
            xb, r2 = lonlat_deg_to_xyz(c), None
        else:
            qb, xb, r2 = q, x, rows1
        true = retrieval.exact_nn(qb, hb.bank)
        r2 = rh.hier_topk(qb, xb, hb, **kw) if r2 is None else r2
        table.append([(r == true).float().mean().item() for r in (
            r2, rh.hier_topk(qb, xb, hb, **full), rh.hier_topk(qb, xb, one, k_tiles=TOPK_K))])
        if not seed:
            true0 = true
    two, two_full, lvl1 = (sum(col) / len(table) for col in zip(*table))
    rec_s = (rows1s == true0[:small]).float().mean().item()
    rec_s1 = (rh.hier_topk(q[:small], x[:small], one, k_tiles=TOPK_K)
              == true0[:small]).float().mean().item()
    print(f"recall@1 vs f32 exact_nn, K={TOPK_K}, B={BATCH} batches 0-4 (two-level M="
          f"{TOPK_M} / two-level M={hb.t_real} (every tile) / one-level over g_sem_cat): "
          + "; ".join(" / ".join(f"{r:.5f}" for r in row) for row in table)
          + f"; pooled over {len(table) * BATCH} queries: {two:.5f} / {two_full:.5f} / "
          f"{lvl1:.5f}; B={small}: two-level {rec_s:.5f}, one-level {rec_s1:.5f}")
    gap = lvl1 - two
    print(f"two-level (M={TOPK_M}) against one-level selection: {gap:+.5f} pooled recall@1 "
          f"({'within' if gap <= 0.001 else 'NOT within'} 0.001 of it)")

    # every miss of the M=96 endpoint on batch 0 is the selection's (the
    # true row's tile not among its block's K tiles) or an exact-logit
    # near-tie; and with every tile refined the fine stats select as well
    # as the one-level scan's
    inv = torch.argsort(order)[:BATCH]
    m_f, s_f, _ = rh._hier_refine_call(*rargs, **rkw)
    idx_loc, _ = rh.select_tiles(m_f, s_f, rh._gather_cols(stats[2], idx_m, bm),
                                 rh._gather_cols(stats[3], idx_m, bm), t_real=mt,
                                 k_tiles=min(k_tiles, mt), bm=bm, n_valid=BATCH,
                                 j_sem=j_sem, mode="range")
    idx = torch.gather(idx_m, 1, idx_loc.long())
    miss = (rows1 != true0).nonzero()[:, 0]
    blk, tile = inv[miss] // bm, true0[miss].long() // hb.bn
    in_k = (idx[blk] == tile[:, None]).any(dim=1)
    in_m = (idx_m[blk] == tile[:, None]).any(dim=1)
    keys = hb.bank.keys_sem.double()
    lgap = ((q[miss].double() * keys[true0[miss].long()]).sum(1)
            - (q[miss].double() * keys[rows1[miss].long()]).sum(1))
    near = lgap < 1e-5
    print(f"two-level misses on batch 0: {miss.numel()}: true tile outside the coarse M "
          f"{int((~in_m).sum())}, in M but not in K {int((in_m & ~in_k).sum())}, in K "
          f"{int(in_k.sum())} (near-ties, exact-logit gap < 1e-5: {int((in_k & near).sum())})")
    if (in_k & ~near).any() or two_full < lvl1 - 0.001:
        raise AssertionError(f"two-level hier_topk: {int((in_k & ~near).sum())} misses inside "
                             f"the selected tiles, or recall@1 with every tile refined "
                             f"{two_full:.5f} below the one-level {lvl1:.5f} - 0.001")

    topk_ms = _host_ms(lambda: rh.hier_topk(q, x, hb, **kw), 5)
    one_ms = _host_ms(lambda: rh.hier_topk(q, x, one, k_tiles=TOPK_K), 5)
    print(f"two-level hier_topk endpoint B={BATCH} K={TOPK_K} M={TOPK_M} (queries on the "
          f"card): median {topk_ms:.3f} ms over 5 calls; one-level over g_sem_cat "
          f"{one_ms:.3f} ms")
    _trace(lambda: rh.hier_topk(q, x, hb, **kw), 3, f"two-level hier_topk B={BATCH}")
    return topk_ms, hb


def general_phases(dev, gen, report, bank):
    """The general one-level hierarchical path (banks with any subset of
    lr_rank / res_rank / lr_geo): build the informative bank's HierBank at
    the JAX defaults (bn 512, gsz_sem 8, gsz_geo 64, no knobs), its int8
    HierBank, one with every knob (lr_rank 256, res_rank 128, lr_geo 384,
    gsz_sem 8; the operands of the variant checks) and one per knob subset
    served (lr; rr; lr + rr without lr_geo; lr + lr_geo; tail_super=64
    without lr_rank), all on the card;
    hold the wide-tail scan, kernel 15's plain variant, kernel 14's plain /
    lr / rr shapes and kernel 16 without lr_geo against their plain
    versions at B=10,000; serve load_model("RANGE+" | "RANGE",
    retrieval="hier") at the defaults (B = 1, 37, 1,000, 10,000), with int8
    values, and one request per knob subset (lr; rr; lr + rr without
    lr_geo; k_geo=8 without rr; lr + lr_geo at k_geo=8, the request that
    takes kernel 14's lr shape; tail_super=64 without lr_rank, the full-
    width forms of the segment-sum scan and of kernel 13), each with its
    launches counted; hold the relerr bars.
    Returns the default-knob RANGE+ end-to-end ms at B=10,000."""
    from range_tpu_torch import load_model
    from range_tpu_torch.bank import quantize_values
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    # ---- 16. the HierBanks, built on the card
    knobs = {"defaults": {}, "lr": dict(lr_rank=256), "rr": dict(res_rank=128),
             "lr_rr": dict(lr_rank=256, res_rank=128),
             "lr_lrg": dict(lr_rank=256, lr_geo=384),
             "all": dict(lr_rank=256, res_rank=128, lr_geo=384),
             "ts": dict(tail_super=TAIL_SUPER)}
    banks = {}
    for name, kw in knobs.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        banks[name] = rh.build_hier_bank(bank, bn=512, gsz_sem=8, gsz_geo=64, **kw)
        torch.cuda.synchronize()
        print(f"build_hier_bank (bn 512, gsz_sem 8, gsz_geo 64, {kw or 'no knobs'}): "
              f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    banks["int8"] = rh.build_hier_bank(quantize_values(bank), bn=512, gsz_sem=8, gsz_geo=64)
    torch.cuda.synchronize()
    hb, hv = banks["defaults"], banks["all"]
    print(f"int8 HierBank at the defaults: {time.perf_counter() - t0:.2f} s; t_real "
          f"{hb.t_real}, t_pad {hb.t_pad}; g_sem_cat {tuple(hb.g_sem_cat.shape)}, g_sem_vw "
          f"{tuple(hb.g_sem_vw.shape)}, g_geo_cat {tuple(hb.g_geo_cat.shape)}, g_geo_vw "
          f"{tuple(hb.g_geo_vw.shape)}")

    enc = load_model("RANGE+", db_path=hb, retrieval="hier", device="cuda")
    cfg = enc.model.config
    bm, k_tiles, _, j_sem = cfg.hier_plan(BATCH)
    k_geo = max(8, k_tiles // 2)  # the k_geo a res_rank bank gets
    gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
    Dv, sem_d = hb.value_dim, hb.sem_d
    coords = _random_coords(BATCH, gen, dev)
    flip = ("bf16 weights (p times the row's scale, e, e - ps/cnt) can round the other way "
            "where the logits' f32 summation order moves them across a bf16 boundary: one "
            "ulp of one term")
    rows_off = max(2, BATCH // 100)
    with torch.no_grad():
        q = enc.model.query_embedding(coords)
        x = lonlat_deg_to_xyz(coords)
        q_s, q_x = rh._pad_queries(q, x, bm)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[
            rh._hybrid_order(q_x, BATCH)].contiguous()

        # ---- 17. the wide-tail scan: two families, the mixed launch, geo-less
        Gs, Gg = hb.t_real * gpt_s, hb.t_real * gpt_g
        ws, wg = hb.g_sem_cat.shape[1], hb.g_geo_cat.shape[1]
        scans = {}
        for case, sem_vw, has_geo in (("two-family", hb.g_sem_vw, True),
                                      ("mixed", hv.g_sem_vw_lr, True),
                                      ("geo-less", hb.g_sem_vw, False)):
            args = (q_cat, hb.g_sem_cat, hb.g_geo_cat, sem_vw, hb.g_geo_vw)
            kw = dict(gpt_s=gpt_s, gpt_g=gpt_g, has_geo=has_geo)
            got = rh._hier_scan_call(*args, **kw)
            ref = rh._hier_scan_plain(*args, **kw)
            mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, sem_vw.abs(),
                                      hb.g_geo_vw.abs(), **kw)[4]
            Ws, Wg = sem_vw.shape[1], hb.g_geo_vw.shape[1] if has_geo else 0
            tag = f"hier_scan[wide, {case}]"
            errs = [_compare(f"{tag} m_s", got[0], ref[0], 1e-4, 0.0,
                             "f32 sums of the same bf16 products in another order"),
                    _compare(f"{tag} s_s", got[1], ref[1], 0.0, 1e-4,
                             "f32 sums of f32 exp2 in another order"),
                    _compare_terms(f"{tag} tails[sem]", got[4][:, :Ws], ref[4][:, :Ws],
                                   mag[:, :Ws], flip)]
            if has_geo:
                errs += [_compare(f"{tag} m_g", got[2], ref[2], 1e-4, 0.0,
                                  "f32 sums of the same bf16 products in another order"),
                         _compare(f"{tag} s_g", got[3], ref[3], 0.0, 1e-4,
                                  "f32 sums of f32 exp2 in another order"),
                         _compare_terms(f"{tag} tails[geo]", got[4][:, Ws:], ref[4][:, Ws:],
                                        mag[:, Ws:], flip)]
            plain_ms = _cuda_ms(lambda: rh._hier_scan_plain(*args, **kw), 2)
            # the work needed: group logits over sem_d (and the 9 geo) columns,
            # the tails over Dv + the count (or the lr coefficients + the count)
            r_s = hv.lr_rank if case == "mixed" else Dv
            flops = 2 * BATCH * (Gs * (sem_d + r_s + 1)
                                 + (Gg * (GEO_COLS + Dv + 1) if has_geo else 0))
            n_bytes = (BATCH * (ws + (wg if has_geo else 0)) * 2 + Gs * (ws + Ws) * 2
                       + (Gg * (wg + Wg) * 2 if has_geo else 0)
                       + (4 if has_geo else 2) * BATCH * hb.t_pad * 4 + BATCH * (Ws + Wg) * 4)
            b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
            ms = _scan_times(f"{tag} B={BATCH}", args, kw, b_ms, b_by,
                             BATCH * (Gs + (Gg if has_geo else 0)))
            print(f"{tag} B={BATCH}: plain {plain_ms:.3f} ms")
            if case == "two-family":
                # the wide tail's other cut: three 384-column slices, each
                # recomputing the logits (the mma.sync body's cut)
                fams = rh._scan_shapes(*args, **kw)
                plan = rh._scan_plan(q_cat.shape[0], fams)
                three = rh._scan_plan(q_cat.shape[0], tuple(f[:2] + (384,) + f[3:]
                                                            for f in fams))
                three = three._replace(fams=tuple(f._replace(n_sl=3) for f in three.fams))
                _compare_terms(f"{tag} in three 384-column slices, tails[sem]",
                               rh._launch_scan_sm90(*args, **kw, plan=three)[1][:, :Ws],
                               ref[4][:, :Ws], mag[:, :Ws], flip)
                t = [_cuda_ms(lambda p=p: rh._launch_scan_sm90(*args, **kw, plan=p), 10)
                     for p in (plan, three, three, plan)]
                print(f"{tag} B={BATCH}: two 576-column slices ({plan}) {t[0]:.4f} / "
                      f"{t[3]:.4f} ms, three 384-column slices ({three}) {t[1]:.4f} / "
                      f"{t[2]:.4f} ms")
                _scan_drift(f"{tag} B={BATCH}", args, kw, ref[4], mag)
            scans[case] = got
            if case == "two-family":
                report["hier_scan_wide"] = dict(
                    max_abs_err=max(e for e, _ in errs), err_over_tol=max(r for _, r in errs),
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
            else:
                report["hier_scan_wide"]["max_abs_err"] = max(
                    report["hier_scan_wide"]["max_abs_err"], *(e for e, _ in errs))
                report["hier_scan_wide"]["err_over_tol"] = max(
                    report["hier_scan_wide"]["err_over_tol"], *(r for _, r in errs))

        # ---- 18. kernel 15's plain variant (GEO true / false, bf16 / int8)
        m_s, s_s, m_g, s_g, tails = scans["two-family"]
        chosen = {}

        def selection(b):
            """A B = b request's packed queries (the first b of this
            phase's) in their order and its selection at b's own plan:
            (q_cat, bm, the merged launch's list, {geo: the family's list,
            k_geo = max(8, K // 2)})."""
            if b not in chosen:
                bm_b, k_b, _, j_b = cfg.hier_plan(b)
                q_sb, q_xb = rh._pad_queries(q[:b], x[:b], bm_b)
                qc = rf.pack_queries(q_sb, q_xb, 12.0, 40.0, hb.tier)[
                    rh._hybrid_order(q_xb, b)].contiguous()
                st = rh._hier_scan_stats_call(qc, hb.g_sem_cat, hb.g_geo_cat, gpt_s=gpt_s,
                                              gpt_g=gpt_g)
                at = dict(t_real=hb.t_real, bm=bm_b, n_valid=b)
                chosen[b] = (qc, bm_b, rh.select_tiles(*st, k_tiles=k_b, j_sem=j_b,
                                                         j_geo=cfg.j_geo, **at)[0],
                               {False: rh.select_tiles(*st, k_tiles=k_b, j_sem=j_b,
                                                       j_geo=cfg.j_geo, mode="range", **at)[0],
                                True: rh.select_tiles(st[2], st[3], st[0], st[1],
                                                      k_tiles=max(8, k_b // 2), j_sem=cfg.j_geo,
                                                      j_geo=j_b, mode="range", **at)[0]})
            return chosen[b]

        idx, _ = rh.select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real, k_tiles=k_tiles,
                                 bm=bm, n_valid=BATCH, j_sem=j_sem, j_geo=cfg.j_geo)
        segs = {"acc_s": slice(0, Dv), "d_s": slice(2 * Dv, 2 * Dv + 1)}
        geo_segs = {"acc_g": slice(Dv, 2 * Dv), "d_g": slice(2 * Dv + 1, 2 * Dv + 2)}
        for quant, hbq in (("bf16", hb), ("int8", banks["int8"])):
            for geo in (True, False):
                args = (q_cat, hbq.k_cat, hbq.values, hbq.value_scale, hbq.mask_neg, idx,
                        hbq.g_sem_cat, hbq.g_geo_cat, hbq.g_sem_vw, hbq.g_geo_vw)
                kw = dict(sem_d=sem_d, bm=bm, bn=hbq.bn, gpt_s=gpt_s, gpt_g=gpt_g, geo=geo,
                          lr=False)
                tag = f"hier_parts[plain, {quant}, GEO={str(geo).lower()}]"
                got = rh._hier_parts_call(*args, **kw)
                ref = rh._hier_parts_plain(*args, **kw)
                mag = rh._hier_parts_plain(*args, **kw, magnitude=True)
                errs = [_compare_terms(f"{tag} {name}", got[:, cols], ref[:, cols],
                                       mag[:, cols], flip, rows_off_max=rows_off)
                        for name, cols in {**segs, **(geo_segs if geo else {})}.items()]
                zero = [got[:, 2 * Dv + 2:]] + (
                    [] if geo else [got[:, Dv:2 * Dv], got[:, 2 * Dv + 1:2 * Dv + 2]])
                if any(z.abs().max().item() != 0.0 for z in zero):
                    raise AssertionError(f"{tag}: the pad (or skipped geo) columns not zero")
                if geo:  # the default RANGE+ request's launch: B = 1, 37, 1,000, 10,000
                    def request(b, args=args, kw=kw):
                        qc, bm_b, i_m, _ = selection(b)
                        return (qc,) + args[1:5] + (i_m,) + args[6:], dict(kw, bm=bm_b)

                    k_ms, _, b_ms, b_by, _ = _values_batches(
                        tag, request, True,
                        lambda a, k, m: rh._hier_parts_plain(*a, **k, magnitude=m),
                        list({**segs, **geo_segs}.items()), flip)
                    if quant == "bf16":
                        _values_drift(f"{tag} B={BATCH}", args, kw, True, ref, mag, flip)
                else:
                    k_ms, _, b_ms, b_by = _values_turns(
                        f"{tag} B={BATCH} K={idx.shape[1]} bm={bm}", args, kw, True, BATCH)
                p_ms = _cuda_ms(lambda: rh._hier_parts_plain(*args, **kw), 2)
                print(f"{tag} B={BATCH} K={idx.shape[1]} bm={bm}: plain {p_ms:.3f} ms")
                if quant == "bf16" and geo:  # the default RANGE+ request's launch
                    report["hier_parts_plain"] = dict(
                        max_abs_err=max(e for e, _ in errs),
                        err_over_tol=max(r for _, r in errs), ms=k_ms, plain_ms=p_ms,
                        bound_ms=b_ms, bound_by=b_by)
                else:
                    report["hier_parts_plain"]["max_abs_err"] = max(
                        report["hier_parts_plain"]["max_abs_err"], *(e for e, _ in errs))
                    report["hier_parts_plain"]["err_over_tol"] = max(
                        report["hier_parts_plain"]["err_over_tol"], *(r for _, r in errs))

        # ---- 19. kernel 14's plain, lr and rr shapes, sem and geo; kernel 16 rg=0
        idx_f = {False: rh.select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real,
                                        k_tiles=k_tiles, bm=bm, n_valid=BATCH, j_sem=j_sem,
                                        j_geo=cfg.j_geo, mode="range")[0],
                 True: rh.select_tiles(m_g, s_g, m_s, s_s, t_real=hb.t_real, k_tiles=k_geo,
                                       bm=bm, n_valid=BATCH, j_sem=cfg.j_geo, j_geo=j_sem,
                                       mode="range")[0]}
        rg0_parts = {}
        for shape in ("plain", "lr", "rr"):
            key = f"hier_parts_family_{shape}"
            tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, errs=[])
            for geo in (False, True):
                fam = "geo" if geo else "sem"
                hbq = hb if shape == "plain" else hv
                lr = shape == "lr"
                vw = ((hbq.g_geo_vw_lr if geo else hbq.g_sem_vw_lr) if lr
                      else (hbq.g_geo_vw if geo else hbq.g_sem_vw))
                z = (hbq.z_geo if geo else hbq.z_sem) if shape == "rr" else None
                lrr = (hbq.lr_geo if geo else hbq.lr_rank) if lr else Dv
                idx = idx_f[geo]
                args = (q_cat, hbq.k_cat, hbq.mask_neg, idx,
                        hbq.g_geo_cat if geo else hbq.g_sem_cat, vw, z)
                kw = dict(sem_d=sem_d, bm=bm, bn=hbq.bn, gpt=gpt_g if geo else gpt_s, geo=geo,
                          lrr=lrr, lr=lr, values=hbq.values, scale=hbq.value_scale)
                tag = f"hier_parts_family[{shape}, {fam}]"
                # the rr shape as serving launches it: the geo family's
                # logits over the k16 step of its 9 real columns
                ckw = dict(kw, geo_cols=GEO_COLS if geo and shape == "rr" else None)
                got = rh._hier_parts_family_call(*args, **ckw)
                ref = rh._hier_parts_family_plain(*args, **kw)
                mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
                cols = {"acc": slice(0, Dv), "d": slice(Dv, Dv + 1)}
                if shape != "plain":
                    cols["alr" if lr else "az"] = slice(Dv + 128, None)
                tot["errs"] += [_compare_terms(f"{tag} {n}", got[:, c], ref[:, c], mag[:, c],
                                               flip, rows_off_max=rows_off)
                                for n, c in cols.items()]
                if got[:, Dv + 1:Dv + 128].abs().max().item() != 0.0:
                    raise AssertionError(f"{tag}: the pad columns not zero")
                if shape == "rr" and geo:
                    rg0_parts["pg"] = got
                f_plain = _cuda_ms(lambda: rh._hier_parts_family_plain(*args, **kw), 2)
                if shape == "rr":  # on the Hopper kernel, beside the mma.sync body
                    n_bytes, flops, n_exp = _rr_work(hbq, idx, bm, geo, BATCH, lr=False)
                    b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
                    f_ms, _ = _parts_times(f"{tag} B={BATCH} K={idx.shape[1]}", args, ckw, b_ms,
                                           b_by, n_exp)
                else:  # on the Hopper values kernel, beside the mma.sync body
                    def request(b, args=args, kw=kw, geo=geo):
                        qc, bm_b, _, fam_b = selection(b)
                        return (qc,) + args[1:3] + (fam_b[geo],) + args[4:], dict(kw, bm=bm_b)

                    f_ms, _, b_ms, b_by, _ = _values_batches(
                        tag, request, False,
                        lambda a, k, m: rh._hier_parts_family_plain(*a, **k, magnitude=m),
                        list(cols.items()), flip)
                print(f"{tag} B={BATCH} K={idx.shape[1]}: kernel {f_ms:.3f} ms, plain "
                      f"{f_plain:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
                tot["ms"] += f_ms
                tot["plain_ms"] += f_plain
                tot["bound_ms"] += b_ms
            report[key] = dict(max_abs_err=max(e for e, _ in tot["errs"]),
                               err_over_tol=max(r for _, r in tot["errs"]), ms=tot["ms"],
                               plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
                               bound_by=b_by)

        # kernel 16 without lr_geo: the sem family's rr + lr parts, the geo
        # family's rr shape, the mixed scan's tails (the lr + rr bank's path)
        ps = rh._hier_parts_family_call(
            q_cat, hv.k_cat, hv.mask_neg, idx_f[False], hv.g_sem_cat, hv.g_sem_vw_lr,
            hv.z_sem, sem_d=sem_d, bm=bm, bn=hv.bn, gpt=gpt_s, geo=False, lrr=hv.lr_rank)
        q_srt = torch.nn.functional.pad(q, (0, 0, 0, q_cat.shape[0] - BATCH)).contiguous()
        rrp, Ws = hv.z_sem.shape[1], hv.g_sem_vw_lr.shape[1]
        ck = dict(Ws=Ws, r=hv.lr_rank, rrp=rrp, Dv=Dv, beta=0.5, rg=0, Wg=hb.g_geo_vw.shape[1])
        c_args = (ps, rg0_parts["pg"], scans["mixed"][4], q_srt, hv.w_sem, hv.u_sem,
                  hv.w_geo, None)
        # the Hopper body beside the f32 body at B = 10,000 and, on its
        # first rows (a combine's rows are independent), at 1, 37 and 1,000
        for b in REQUESTS:
            rows = -(-b // bm) * bm
            res = _combine_turns(f"combine_cat[rg=0] B={b} (Bp {rows})",
                                 tuple(t[:rows] for t in c_args[:4]) + c_args[4:], ck, b)
        plain_ms = _cuda_ms(lambda: rh._combine_cat_plain(*c_args, **ck), 10)
        print(f"combine_cat[rg=0] B={BATCH}: plain {plain_ms:.3f} ms")
        err, ratio, ms, b_ms, b_by = res["new"]
        report["combine_cat_rg0"] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

        # kernel 13 and the segment-sum scan over a tail_super bank without
        # lr_rank: the full-width supergroup operand and dvw (W = 1,152)
        ht = banks["ts"]
        sup_r = ht.tail_super // ht.gsz_sem
        args = (q_cat, ht.g_sem_cat, ht.g_geo_cat, ht.g_sem_ts_vw, ht.g_geo_vw)
        kw = dict(gpt_s=gpt_s, gpt_g=gpt_g, sup_r=sup_r)
        got = rh._hier_scan_call(*args, **kw)
        ref = rh._hier_scan_plain(*args, **kw)
        mag = rh._hier_scan_plain(q_cat, ht.g_sem_cat, ht.g_geo_cat, ht.g_sem_ts_vw.abs(),
                                  ht.g_geo_vw.abs(), **kw)[4]
        Ws = ht.g_sem_ts_vw.shape[1]
        tag = f"hier_scan[sup_r={sup_r}, wide]"
        errs = [_compare(f"{tag} m_s", got[0], ref[0], 1e-4, 0.0,
                         "f32 sums of the same bf16 products in another order"),
                _compare(f"{tag} s_s", got[1], ref[1], 0.0, 1e-4,
                         "f32 sums of f32 exp2 in another order"),
                _compare_terms(f"{tag} tails[sem]", got[4][:, :Ws], ref[4][:, :Ws],
                               mag[:, :Ws], flip),
                _compare_terms(f"{tag} tails[geo]", got[4][:, Ws:], ref[4][:, Ws:],
                               mag[:, Ws:], flip)]
        for key in ("hier_scan_sup", "hier_scan_wide"):
            report[key]["max_abs_err"] = max(report[key]["max_abs_err"], *(e for e, _ in errs))
            report[key]["err_over_tol"] = max(report[key]["err_over_tol"],
                                              *(r for _, r in errs))
        Gs, Gg = ht.t_real * gpt_s, ht.t_real * gpt_g
        ws, wg, Wg = ht.g_sem_cat.shape[1], ht.g_geo_cat.shape[1], ht.g_geo_vw.shape[1]
        # the work needed: group logits over sem_d (and the 9 geo) columns,
        # the sem tail over Gs / sup_r supergroup rows of Dv + the count, the
        # geo tail over Dv + the count
        flops = 2 * BATCH * (Gs * sem_d + Gs // sup_r * (Dv + 1) + Gg * (GEO_COLS + Dv + 1))
        n_bytes = (BATCH * (ws + wg) * 2 + (Gs * ws + Gs // sup_r * Ws + Gg * (wg + Wg)) * 2
                   + 4 * BATCH * ht.t_pad * 4 + BATCH * (Ws + Wg) * 4)
        _scan_times(f"{tag} B={BATCH}", args, kw, *_bound(n_bytes, flops, BF16_FLOPS),
                    BATCH * (Gs + Gg))
        print(f"{tag} B={BATCH}: plain {_cuda_ms(lambda: rh._hier_scan_plain(*args, **kw), 2):.3f}"
              " ms")
        m_s, s_s, m_g, s_g, _ = got
        idx_sm, _ = rh.select_tiles(m_s, s_s, m_g, s_g, t_real=ht.t_real,
                                    k_tiles=k_tiles + TS_M_CORR, bm=bm, n_valid=BATCH,
                                    j_sem=j_sem, j_geo=cfg.j_geo, mode="range")
        cargs, ckw = (q_cat, idx_sm, ht.g_sem_cat, ht.g_sem_ts_dvw), dict(bm=bm, gpt=gpt_s)
        nB, M = idx_sm.shape
        tag = f"hier_corr[wide] B={BATCH} K+m_corr={M} bm={bm}"
        err, ratio = _compare_terms(
            tag, rh._hier_corr_call(*cargs, **ckw), rh._hier_corr_plain(*cargs, **ckw),
            rh._hier_corr_plain(*cargs, **ckw, magnitude=True),
            "bf16 weights of f32 logits summed in another order: one ulp of one term",
            rows_off_max=rows_off)
        ms = _cuda_ms(lambda: rh._hier_corr_call(*cargs, **ckw), 10)
        plain_ms = _cuda_ms(lambda: rh._hier_corr_plain(*cargs, **ckw), 2)
        W = ht.g_sem_ts_dvw.shape[1]
        U = int(torch.unique(idx_sm).numel())
        groups = (_block_queries(nB, bm, dev) * M).sum().item() * gpt_s
        # group logits over sem_d columns and the product over Dv + the count
        b_ms, b_by = _bound(BATCH * sem_d * 2 + U * gpt_s * (ws + W) * 2 + BATCH * W * 4,
                            2 * groups * (sem_d + Dv + 1), BF16_FLOPS)
        print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by})")
        report["hier_corr_wide"] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    # ---- 20. serving through load_model at the defaults, int8, each subset
    wide = {"siren_tower": 1, "hier_scan": 1, "hier_scan_wide": 1}
    plus = {**wide, "hier_parts": 1, "hier_parts_plain": 1}
    encs = {"RANGE+": (enc, plus),
            "RANGE": (load_model("RANGE", db_path=hb, retrieval="hier", device="cuda"),
                      {**plus, "hier_scan_stats": 1})}
    requests = [_random_coords(b, gen, dev) for b in REQUESTS]
    launches = {}
    answers = {}
    for name, (e, want) in encs.items():
        for c in requests:
            out, got = _drive(f"{name} defaults B={c.shape[0]}: (bm, K, k_geo, j_sem) = "
                              f"{e.model.config.hier_plan(c.shape[0])}",
                              lambda: _send(e, c), want)
            if out.shape != (c.shape[0], Dv + 256) or not torch.isfinite(out).all():
                raise AssertionError(f"{name} defaults B={c.shape[0]}: shape or non-finite")
            launches = {k: launches.get(k, 0) + n for k, n in got.items()}
            answers[name] = out
    subsets = (
        ("lr", banks["lr"], {}, {**wide, "hier_parts": 1}),
        ("rr", banks["rr"], {}, {**wide, "hier_parts_family_rr": 2}),
        ("lr+rr without lr_geo", banks["lr_rr"], {},
         {**wide, "hier_parts_family": 1, "hier_parts_family_rr": 1, "combine_cat": 1,
          "combine_cat_rg0": 1}),
        ("k_geo=8 without rr", hb, dict(k_geo=8), {**wide, "hier_parts_family_plain": 2}),
        # kernel 14's lr shape, both families (the tails 384 and 512 wide)
        ("lr+lr_geo, k_geo=8", banks["lr_lrg"], dict(k_geo=8),
         {"siren_tower": 1, "hier_scan": 1, "hier_parts_family_lr": 2}),
        (f"tail_super={TAIL_SUPER} without lr_rank, k_geo=8, m_corr={TS_M_CORR}",
         banks["ts"], dict(k_geo=8, tail_super=TAIL_SUPER, m_corr=TS_M_CORR),
         {**wide, "hier_scan_sup": 1, "hier_corr": 1, "hier_corr_wide": 1,
          "hier_parts_family_plain": 2}))
    c = requests[-1]
    for name, hbq, kw, want in subsets:
        e = load_model("RANGE+", db_path=hbq, retrieval="hier", device="cuda",
                       lr_rank=hbq.lr_rank or None, res_rank=hbq.res_rank or None,
                       lr_geo=hbq.lr_geo or None, **kw)
        out, got = _drive(f"RANGE+ {name} B={BATCH}", lambda: e(c), want)
        launches = {k: launches.get(k, 0) + n for k, n in got.items()}
        answers[name] = out
    for name in ("RANGE+", "RANGE"):
        e = load_model(name, db_path=banks["int8"], retrieval="hier", value_quant="int8",
                       device="cuda")
        out, got = _drive(f"{name} defaults int8 B={BATCH}", lambda: e(c), encs[name][1])
        launches = {k: launches.get(k, 0) + n for k, n in got.items()}
        ref16 = answers[name][:, :Dv]
        rel = (out[:, :Dv] - ref16).abs() / ref16.abs().clamp_min(0.1)
        print(f"{name} defaults int8 vs bf16 HierBank B={BATCH}: relerr mean "
              f"{rel.mean().item():.5f} (bar < 0.01, tests/test_hier.py:139-149), p99 "
              f"{torch.quantile(rel.flatten()[::4], 0.99).item():.5f}")
        if not torch.isfinite(out).all() or rel.mean().item() >= 0.01:
            raise AssertionError(f"{name} defaults int8 against bf16 outside its bar")
    print(f"general one-level path launches: {launches}")
    for k in ("hier_scan_wide", "hier_parts_plain", "hier_parts_family_plain",
              "hier_parts_family_lr", "hier_parts_family_rr", "combine_cat_rg0",
              "hier_corr_wide"):
        report[k]["launches"] = launches[k]
    for k in ("hier_scan", "hier_parts", "hier_scan_stats", "hier_parts_family",
              "combine_cat", "hier_scan_sup", "hier_corr"):
        report[k]["launches"] += launches[k]

    # ---- 21. fidelity at B=10,000 against the exact f32 retrieve
    with torch.no_grad():
        unit = answers["RANGE+"][:, Dv:]
        refs = {"range+": retrieval.retrieve(unit, lonlat_deg_to_xyz(c), hb.bank,
                                             sem_temp=12.0, beta=0.5),
                "range": retrieval.retrieve(answers["RANGE"][:, Dv:], None, hb.bank,
                                            sem_temp=15.0, mode="range")}
    for name, bar in (("RANGE+", 0.12), ("RANGE", 0.10), ("lr", 0.12), ("rr", 0.12),
                      ("lr+rr without lr_geo", 0.12), ("k_geo=8 without rr", 0.12),
                      ("lr+lr_geo, k_geo=8", 0.12),
                      (f"tail_super={TAIL_SUPER} without lr_rank, k_geo=8, m_corr={TS_M_CORR}",
                       0.12)):
        ref = refs["range" if name == "RANGE" else "range+"]
        rel = (answers[name][:, :Dv] - ref).abs() / ref.abs().clamp_min(0.1)
        mean, p99 = rel.mean().item(), torch.quantile(rel.flatten()[::4], 0.99).item()
        src = "tests/test_hier.py:136" if name == "RANGE" else "tests/test_hier.py:167"
        print(f"{name if name in ('RANGE', 'RANGE+') else 'RANGE+ ' + name} B={BATCH} relerr "
              f"vs exact f32 retrieve: mean {mean:.5f} (bar {bar}, {src}), p99 {p99:.5f} "
              "(every 4th element)")
        if mean > bar:
            raise AssertionError(f"{name}: relerr mean {mean:.5f} over its bar {bar}")

    e2e = {b.shape[0]: _host_ms(lambda: enc(b), 5) for b in requests[1:]}
    print("RANGE+ defaults end to end (coords already on the card), median of 5 calls: "
          + ", ".join(f"B={b} {ms:.3f} ms" for b, ms in e2e.items()))
    print(f"RANGE defaults end to end B={BATCH}: "
          f"{_host_ms(lambda: encs['RANGE'][0](c), 5):.3f} ms")
    _trace(lambda: enc(c), 3, f"RANGE+ defaults B={BATCH}")
    return e2e[BATCH]


def gsz4_phases(dev, gen, report, bank) -> dict:
    """Banks of groups of 4 rows at bn 512: 128 groups a tile (the card's
    parts kernels walk a tile's groups 64 at a time).  At the JAX defaults
    otherwise (`tools/r3_parity2.py:69-70`: load_model(..., retrieval="hier",
    gsz_sem=4)), RANGE+ and RANGE at B = 10,000 through kernel 15 (the
    merged parts kernel's plain variant) at gpt 128, relerr mean <= 0.12 /
    0.10 (the defaults bank's bars); with the flagship's lr_rank, res_rank
    and lr_geo, RANGE+ through kernel 14's rr + lr shape at gpt 128 (bar
    0.12); kernel 15's plain variant and kernel 14's rr + lr and lr shapes at
    gpt 128 held against their plain versions.  Each request's launches
    counted.  Returns the requests' end-to-end ms."""
    from range_tpu_torch import load_model
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    # ---- 21b. the HierBanks, built on the card
    knobs = dict(lr_rank=256, res_rank=128, lr_geo=384)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc = load_model("RANGE+", db_path=bank, retrieval="hier", gsz_sem=4, device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    hk = rh.build_hier_bank(bank, bn=512, gsz_sem=4, gsz_geo=64, **knobs)
    torch.cuda.synchronize()
    hb = enc.model.bank
    gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
    print(f"gsz_sem=4 HierBanks (bn {hb.bn}, {gpt_s} sem groups a tile): load_model at the "
          f"defaults {t1 - t0:.2f} s, build_hier_bank with {knobs} {time.perf_counter() - t1:.2f} s")
    wide = {"siren_tower": 1, "hier_scan": 1, "hier_scan_wide": 1}
    plus = {**wide, "hier_parts": 1, "hier_parts_plain": 1}
    encs = {"RANGE+": (enc, plus, 0.12),
            "RANGE": (load_model("RANGE", db_path=hb, retrieval="hier", gsz_sem=4, device=dev),
                      {**plus, "hier_scan_stats": 1}, 0.10),
            "RANGE+ lr+rr+lr_geo": (load_model("RANGE+", db_path=hk, retrieval="hier",
                                               gsz_sem=4, device=dev, **knobs),
                                    {"siren_tower": 1, "hier_scan": 1, "hier_parts_family": 2,
                                     "combine_cat": 1}, 0.12)}
    c = _random_coords(BATCH, gen, dev)
    x = lonlat_deg_to_xyz(c)
    launches, e2e = {}, {}
    for name, (e, want, bar) in encs.items():
        out, got = _drive(f"gsz_sem=4 {name} B={BATCH}", lambda: e(c), want)
        launches = {k: launches.get(k, 0) + n for k, n in got.items()}
        Dv = hb.value_dim
        with torch.no_grad():
            ref = (retrieval.retrieve(out[:, Dv:], None, hb.bank, sem_temp=15.0, mode="range")
                   if name == "RANGE" else
                   retrieval.retrieve(out[:, Dv:], x, hb.bank, sem_temp=12.0, beta=0.5))
        rel = _rel(out, ref, Dv)
        mean, p99 = rel.mean().item(), torch.quantile(rel.flatten()[::4], 0.99).item()
        e2e[f"gsz_sem=4 {name}"] = _host_ms(lambda: e(c), 5)
        print(f"gsz_sem=4 {name} B={BATCH} relerr vs exact f32 retrieve: mean {mean:.5f} (bar "
              f"{bar}, tests/test_hier.py:{136 if bar == 0.10 else 167}), p99 {p99:.5f}; end "
              f"to end {e2e[f'gsz_sem=4 {name}']:.3f} ms")
        if not torch.isfinite(out).all() or mean > bar:
            raise AssertionError(f"gsz_sem=4 {name}: relerr mean {mean:.5f} over its bar {bar}")
    print(f"gsz_sem=4 path launches: {launches}")
    _tally(report, launches)

    # ---- 21c. kernels 15 and 14 at 128 groups a tile against their plain versions
    cfg = encs["RANGE+ lr+rr+lr_geo"][0].model.config
    bm, k_tiles, _, j_sem = cfg.hier_plan(BATCH)
    k_geo = max(8, k_tiles // 2)
    rows_off = max(2, BATCH // 100)
    why = ("bf16 weights (p, e, e - ps/cnt) can round the other way where the logits' f32 "
           "summation order moves them across a bf16 boundary: one ulp of one term")
    with torch.no_grad():
        q = enc.model.query_embedding(c)
        q_s, q_x = rh._pad_queries(q, x, bm)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[
            rh._hybrid_order(q_x, BATCH)].contiguous()
        st = rh._hier_scan_stats_call(q_cat, hk.g_sem_cat, hk.g_geo_cat, gpt_s=gpt_s,
                                      gpt_g=gpt_g)
        idx_s, _ = rh.select_tiles(*st, t_real=hk.t_real, k_tiles=k_tiles, bm=bm,
                                   n_valid=BATCH, j_sem=j_sem, j_geo=cfg.j_geo, mode="range")
        idx_g, _ = rh.select_tiles(st[2], st[3], st[0], st[1], t_real=hk.t_real,
                                   k_tiles=k_geo, bm=bm, n_valid=BATCH, j_sem=cfg.j_geo,
                                   j_geo=j_sem, mode="range")
        Dv = hb.value_dim
        margs = (q_cat, hb.k_cat, hb.values, None, hb.mask_neg, idx_s, hb.g_sem_cat,
                 hb.g_geo_cat, hb.g_sem_vw, hb.g_geo_vw)
        mkw = dict(sem_d=hb.sem_d, bm=bm, bn=hb.bn, gpt_s=gpt_s, gpt_g=gpt_g, lr=False)
        got = rh._hier_parts_call(*margs, **mkw)
        ref = rh._hier_parts_plain(*margs, **mkw)
        mag = rh._hier_parts_plain(*margs, **mkw, magnitude=True)
        for seg, cols in (("acc", slice(0, 2 * Dv)), ("d", slice(2 * Dv, 2 * Dv + 2))):
            _compare_terms(f"hier_parts[plain, gpt {gpt_s}] B={BATCH} {seg}", got[:, cols],
                           ref[:, cols], mag[:, cols], why, rows_off_max=rows_off)
        print(f"hier_parts[plain, gpt {gpt_s}] B={BATCH}: kernel "
              f"{_cuda_ms(lambda: rh._hier_parts_call(*margs, **mkw), 10):.3f} ms")
        _rr_families(f"gpt {gpt_s} B={BATCH}", hk, q_cat, idx_s, idx_g, bm, BATCH, why,
                     body=False)
        hv = dataclasses.replace(hk, res_rank=0, z_sem=None, z_geo=None, w_sem=None, w_geo=None)
        args = (q_cat, hv.k_cat, hv.mask_neg, idx_s, hv.g_sem_cat, hv.g_sem_vw_lr, None)
        kw = dict(sem_d=hv.sem_d, bm=bm, bn=hv.bn, gpt=gpt_s, geo=False, lrr=hv.lr_rank,
                  values=hv.values, scale=None)
        _family_check(f"hier_parts_family[lr, gpt {gpt_s}] B={BATCH}", args, kw,
                      (("acc", slice(0, Dv)), ("d", slice(Dv, Dv + 1)),
                       ("alr", slice(Dv + 128, None))), why, rows_off)
    return e2e


def _banks_phase(dev, gen, report, bank, specs, title: str) -> dict:
    """Banks of ``specs`` (bn, gsz_sem, gsz_geo), built on the card from
    ``bank`` with the flagship's lr_rank / res_rank / lr_geo, each
    through `load_model("RANGE+" | "RANGE", retrieval="hier")` at B = 1,000
    and 10,000 (RANGE+: kernel 14's rr + lr shape for both families), with
    k_tiles scaled so that the selected tiles hold as many rows as the
    defaults' 16 tiles of 512 (85 of 96, 21 of 384: the relerr bars assume
    that coverage), relerr mean <= 0.12 / 0.10 against the exact f32
    retrieve (the defaults bank's bars), each request's launches counted;
    and kernel 14's rr + lr
    shape at each bank's selection held against its plain version and
    timed (the mma.sync body took neither).  Returns the requests'
    end-to-end ms."""
    from range_tpu_torch import load_model
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    knobs = dict(lr_rank=256, res_rank=128, lr_geo=384)
    why = ("bf16 weights (p, e, e - ps/cnt) can round the other way where the logits' f32 "
           "summation order moves them across a bf16 boundary: one ulp of one term")
    e2e, launches = {}, {}
    for bn, gsz, gsz_geo in specs:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hb = rh.build_hier_bank(bank, bn=bn, gsz_sem=gsz, gsz_geo=gsz_geo, **knobs)
        torch.cuda.synchronize()
        gpt_s, gpt_g = bn // gsz, bn // gsz_geo
        name = f"bn {bn} gsz_sem {gsz}"
        print(f"{name} HierBank ({gpt_s} sem, {gpt_g} geo groups a tile, t_real {hb.t_real}): "
              f"build_hier_bank with {knobs} {time.perf_counter() - t0:.2f} s")
        kw = dict(retrieval="hier", hier_bn=bn, gsz_sem=gsz, gsz_geo=gsz_geo, device=dev,
                  k_tiles=16 * 512 // bn, **knobs)
        encs = {"RANGE+": (load_model("RANGE+", db_path=hb, **kw),
                           {"siren_tower": 1, "hier_scan": 1, "hier_parts_family": 2,
                            "combine_cat": 1}, 0.12),
                "RANGE": (load_model("RANGE", db_path=hb, **kw),
                          {"siren_tower": 1, "hier_scan_stats": 1, "hier_scan": 1,
                           "hier_parts": 1}, 0.10)}
        for mode, (enc, want, bar) in encs.items():
            for b in (SMALL_BATCH, BATCH):
                c = _random_coords(b, gen, dev)
                out, got = _drive(f"{name} {mode} B={b}", lambda: enc(c), want)
                launches = {k: launches.get(k, 0) + n for k, n in got.items()}
                Dv = hb.value_dim
                with torch.no_grad():
                    ref = (retrieval.retrieve(out[:, Dv:], None, hb.bank, sem_temp=15.0,
                                              mode="range") if mode == "RANGE" else
                           retrieval.retrieve(out[:, Dv:], lonlat_deg_to_xyz(c), hb.bank,
                                              sem_temp=12.0, beta=0.5))
                mean = _rel(out, ref, Dv).mean().item()
                tag = f"{name} {mode} B={b}"
                e2e[tag] = _host_ms(lambda: enc(c), 5)
                print(f"{tag} relerr vs exact f32 retrieve: mean {mean:.5f} (bar {bar}); end "
                      f"to end {e2e[tag]:.3f} ms")
                if not torch.isfinite(out).all() or mean > bar:
                    raise AssertionError(f"{tag}: relerr mean {mean:.5f} over its bar {bar}")
        # ---- kernel 14's rr + lr shape at this bank's selection, B = 10,000
        enc = encs["RANGE+"][0]
        cfg = enc.model.config
        bm, k_tiles, _, j_sem = cfg.hier_plan(BATCH)
        k_geo = max(8, k_tiles // 2)
        c = _random_coords(BATCH, gen, dev)
        x = lonlat_deg_to_xyz(c)
        with torch.no_grad():
            q_s, q_x = rh._pad_queries(enc.model.query_embedding(c), x, bm)
            q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[
                rh._hybrid_order(q_x, BATCH)].contiguous()
            st = rh._hier_scan_stats_call(q_cat, hb.g_sem_cat, hb.g_geo_cat, gpt_s=gpt_s,
                                          gpt_g=gpt_g)
            idx_s, _ = rh.select_tiles(*st, t_real=hb.t_real, k_tiles=k_tiles, bm=bm,
                                       n_valid=BATCH, j_sem=j_sem, j_geo=cfg.j_geo,
                                       mode="range")
            idx_g, _ = rh.select_tiles(st[2], st[3], st[0], st[1], t_real=hb.t_real,
                                       k_tiles=k_geo, bm=bm, n_valid=BATCH, j_sem=cfg.j_geo,
                                       j_geo=j_sem, mode="range")
            for fam, gpt, idx, g_cat, vw, z, lrr in (
                    ("sem", gpt_s, idx_s, hb.g_sem_cat, hb.g_sem_vw_lr, hb.z_sem, hb.lr_rank),
                    ("geo", gpt_g, idx_g, hb.g_geo_cat, hb.g_geo_vw_lr, hb.z_geo, hb.lr_geo)):
                sh = rh._parts_shapes(q_cat, hb.k_cat, hb.mask_neg, idx, g_cat, vw, z,
                                      sem_d=hb.sem_d, bm=bm, bn=bn, gpt=gpt, geo=fam == "geo",
                                      lrr=lrr, lr=True, sel=False,
                                      geo_cols=GEO_COLS if fam == "geo" else None)
                print(f"{name} {fam} family's plan: " + str(rh._parts_plan(
                    q_cat.shape[0], idx.shape[1], bn, gpt, sh["kf"], sh["gwe"], sh["share"],
                    z.shape[1], sh["acols"], sh["out_w"])))
            # groups of one row: the sem family's alr is rounding residue
            # (`_rr_turn`'s ``residue``)
            _rr_families(f"{name} B={BATCH}", hb, q_cat, idx_s, idx_g, bm, BATCH, why,
                         body=False, residue=gsz == 1)
    print(f"{title}' launches: {launches}")
    _tally(report, launches)
    return e2e


def step_banks_phases(dev, gen, report) -> dict:
    """Banks of a masked last step or one-row units (`_banks_phase`, a
    20,000-row informative bank): 96-row tiles of 12-row groups in both
    families (a masked last 64-row step), and 384-row tiles of 3-row sem
    groups (128 a tile: the DIRECT walk) with 48-row geo groups."""
    from range_tpu_torch import GeoBank

    bank = GeoBank.synthetic_informative(7, 20_000, pad_to=384, value_dtype=torch.bfloat16,
                                         device=dev)
    return _banks_phase(dev, gen, report, bank, ((96, 12, 12), (384, 3, 48)), "step banks")


def odd_banks_phases(dev, gen, report) -> dict:
    """Banks of a short last chunk (`_banks_phase`, a 20,000-row
    informative bank padded to whole tiles of each): odd group sizes at an
    odd multiple of 32 sem groups a tile,
    288-row tiles of 3-row groups (96 a tile), 96-row tiles of 1-row
    groups (96 a tile) and 480-row tiles of 3-row groups (160 a tile), each
    with 8 geo groups a tile: a tile's last chunk of 32 groups ends in its
    masked last step."""
    from range_tpu_torch import GeoBank

    bank = GeoBank.synthetic_informative(7, 20_000, pad_to=1440, value_dtype=torch.bfloat16,
                                         device=dev)
    return _banks_phase(dev, gen, report, bank, ((288, 3, 36), (96, 1, 12), (480, 3, 60)),
                        "odd-group banks")


def _rel(out, ref, Dv):
    """Per-element relerr |out - ref| / max(|ref|, 0.1) of the retrieved part."""
    return (out[:, :Dv] - ref).abs() / ref.abs().clamp_min(0.1)


def _pads(idx) -> int:
    """List entries equal to the one before them: `_dedup_union`'s padding."""
    return int((idx[:, 1:] == idx[:, :-1]).sum())


def _family_check(tag, args, kw, segs, why, rows_off_max):
    """One family parts call against its plain version, segment by segment
    (`_compare_terms`), and both timed.  Returns (max abs error, error over
    tolerance, kernel ms, plain ms)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    got = rh._hier_parts_family_call(*args, **kw)
    ref = rh._hier_parts_family_plain(*args, **kw)
    mag = rh._hier_parts_family_plain(*args, **kw, magnitude=True)
    errs = [_compare_terms(f"{tag} {name}", got[:, cols], ref[:, cols], mag[:, cols], why,
                           rows_off_max=rows_off_max) for name, cols in segs]
    ms = _cuda_ms(lambda: rh._hier_parts_family_call(*args, **kw), 10)
    plain_ms = _cuda_ms(lambda: rh._hier_parts_family_plain(*args, **kw), 2)
    print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return max(e for e, _ in errs), max(r for _, r in errs), ms, plain_ms


def _serve(tag, enc, requests, want):
    """Drive enc on each request with its launches counted (`_drive`);
    returns (the answers, the launches summed over the requests)."""
    answers, launches = [], {}
    for c in requests:
        out, got = _drive(f"{tag} B={c.shape[0]}: (bm, K, k_geo, j_sem) = "
                          f"{enc.model.config.hier_plan(c.shape[0])}", lambda: _send(enc, c),
                          want)
        if out.shape != (c.shape[0], 1280) or not torch.isfinite(out).all():
            raise AssertionError(f"{tag} B={c.shape[0]}: shape or non-finite")
        answers.append(out)
        launches = {k: launches.get(k, 0) + n for k, n in got.items()}
    return answers, launches


def knob_phases(dev, gen, report, bank, hb, enc, hb_ts, hb2) -> dict:
    """The rest of hierarchical serving, at full width over the informative
    100,000-row bank with the tower's queries:

      * sel_lr: load_model("RANGE+", profile="flagship", sel_lr=64,
        topk_lr=64) builds its HierBank on the card (`tools/r5_sellr.py`);
        kernel 14's sel form against its plain version in the rr + lr
        shape (hier_parts_family.cu) and, over the bank without res_rank,
        the lr shape (hier_parts.cu); requests at B = 1, 37, 1,000,
        10,000, and one of the lr shape at 10,000;
      * topk_lr: hier_topk(k_tiles=48), k = 1, 8, over that bank's rank-64
        sketch of the topk_gsz operand (`tools/r5_topklr.py`), recall@1
        pooled over five batches against the same bank without it;
      * dedup: the flagship with dedup=2 (k_union automatic: 48) at
        B = 10,000 (`tools/r5_dedup.py`), and the lr shape's; the
        dedup_pad form in both sources against its plain version on
        merged lists with pad repeats;
      * the rescue: adaptive_frac=0.05, adaptive_mult=3 (`tools/
        r4_rescue.py`) on the flagship and the tail_super flagship;
      * the two-level feature path: load_model("RANGE+" | "RANGE",
        retrieval="hier", gsz_super=64) over the JAX-defaults bank's
        two-level HierBank (M = 48), B = 1, 37, 1,000, 10,000; the refine
        kernel's has_parts form against its plain version.

    Returns each path's end-to-end ms at B=10,000."""
    from range_tpu_torch import load_model
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    Dv, sem_d = hb.value_dim, hb.sem_d
    rows_off = max(2, BATCH // 100)
    tallied = {}

    def tally(got):
        for k, n in got.items():
            tallied[k] = tallied.get(k, 0) + n

    why = ("bf16(p) and bf16(e - ps/cnt) (or bf16(e)) can round the other way where the "
           "logits' f32 summation order moves them across a bf16 boundary: one ulp of one "
           "term")
    requests = [_random_coords(b, gen, dev) for b in REQUESTS]
    c = requests[-1]
    x = lonlat_deg_to_xyz(c)
    with torch.no_grad():
        q = enc.model.query_embedding(c).float()
        ref = retrieval.retrieve(q, x, hb.bank, sem_temp=12.0, beta=0.5)
    base = enc(c)  # the flagship, rescue off, on the same coordinates
    rel_f = _rel(base, ref, Dv)
    flag_mean = rel_f.mean().item()
    print(f"flagship B={BATCH} (this phase's coordinates) relerr mean {flag_mean:.5f}, p99 "
          f"{torch.quantile(rel_f.flatten()[::4], 0.99).item():.5f}")
    e2e = {"flagship": _host_ms(lambda: enc(c), 5)}
    flagship = {"siren_tower": 1, "hier_scan": 1, "hier_parts_family": 2, "combine_cat": 1}
    no_rr = dict(res_rank=0, z_sem=None, z_geo=None, w_sem=None, w_geo=None)

    # ---- 22. sel_lr (and topk_lr): the HierBank built by load_model on the card
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc_s = load_model("RANGE+", db_path=bank, profile="flagship", sel_lr=64, topk_lr=64,
                       device=dev)
    torch.cuda.synchronize()
    hbs = enc_s.model.bank
    print(f"load_model(profile='flagship', sel_lr=64, topk_lr=64) with its HierBank build: "
          f"{time.perf_counter() - t0:.2f} s; g_sem_sel {tuple(hbs.g_sem_sel.shape)}, "
          f"g_topk_lr {tuple(hbs.g_topk_lr.shape)}")
    cfg = enc_s.model.config
    bm, k_tiles, k_geo, j_sem = cfg.hier_plan(BATCH)
    gpt_s, gpt_g = hbs.bn // hbs.gsz_sem, hbs.bn // hbs.gsz_geo
    with torch.no_grad():
        q_s, q_x = rh._pad_queries(q, x, bm)
        order = rh._hybrid_order(q_x, BATCH)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hbs.tier)[order].contiguous()
        q_sel = (q_cat[:, :sem_d].float() @ hbs.p_sel.T).to(q_cat.dtype)
        q_wide = torch.cat([q_cat, q_sel], 1).contiguous()
        stats = rh._hier_scan_stats_call(torch.cat([q_sel, q_cat[:, sem_d:]], 1),
                                         hbs.g_sem_sel, hbs.g_geo_cat, gpt_s=gpt_s,
                                         gpt_g=gpt_g)
        for stat, a, b in zip(("m_s", "s_s"), stats, rh._hier_scan_stats_plain(
                torch.cat([q_sel, q_cat[:, sem_d:]], 1), hbs.g_sem_sel, hbs.g_geo_cat,
                gpt_s=gpt_s, gpt_g=gpt_g)):
            _compare(f"hier_scan_stats[g_sem_sel, 64 columns] {stat}", a, b, *(
                (1e-4, 0.0, "f32 sums of the same bf16 products in another order")
                if stat[0] == "m" else (0.0, 1e-4, "f32 sums of f32 exp2 in another order")))
        idx_s, _ = rh.select_tiles(*stats, t_real=hbs.t_real, k_tiles=k_tiles, bm=bm,
                                   n_valid=BATCH, j_sem=j_sem, j_geo=cfg.j_geo, mode="range")
        K, rrp, W = idx_s.shape[1], hbs.z_sem.shape[1], hbs.g_sem_vw_lr.shape[1]
        U = int(torch.unique(idx_s).numel())
        gw = hbs.g_sem_sel.shape[1]
        # the rr + lr sel form (the sem family): its group logits over the 64
        # sketch columns past the keys'
        args = (q_wide, hbs.k_cat, hbs.mask_neg, idx_s, hbs.g_sem_sel, hbs.g_sem_vw_lr,
                hbs.z_sem)
        kw = dict(sem_d=sem_d, bm=bm, bn=hbs.bn, gpt=gpt_s, geo=False, lrr=hbs.lr_rank,
                  sel=True)
        _, errs, ms, _, plain_ms, n_bytes, flops, _ = _rr_turn(
            f"hier_parts_family[sel, rr + lr] B={BATCH} K={K}", hbs, args, kw, BATCH, why, gw=gw,
            plain_time=True)
        b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
        report["hier_parts_family_sel_rr"] = dict(max_abs_err=max(e for e, _ in errs),
                                                  err_over_tol=max(r for _, r in errs), ms=ms,
                                                  plain_ms=plain_ms, bound_ms=b_ms,
                                                  bound_by=b_by)
        # the lr shape's sel form (hier_parts.cu): the values instead of z
        args = (q_wide, hbs.k_cat, hbs.mask_neg, idx_s, hbs.g_sem_sel, hbs.g_sem_vw_lr, None)
        kw = dict(kw, values=hbs.values, scale=None)

        def sel_request(b, kw=kw):
            """A B = b sel_lr request's launch of the lr shape: the first b
            of this phase's queries, b's own plan and selection."""
            bm_b, k_b, _, j_b = cfg.hier_plan(b)
            q_sb, q_xb = rh._pad_queries(q[:b], x[:b], bm_b)
            qc = rf.pack_queries(q_sb, q_xb, 12.0, 40.0, hbs.tier)[
                rh._hybrid_order(q_xb, b)].contiguous()
            qs_b = (qc[:, :sem_d].float() @ hbs.p_sel.T).to(qc.dtype)
            st = rh._hier_scan_stats_call(torch.cat([qs_b, qc[:, sem_d:]], 1), hbs.g_sem_sel,
                                          hbs.g_geo_cat, gpt_s=gpt_s, gpt_g=gpt_g)
            i_s = rh.select_tiles(*st, t_real=hbs.t_real, k_tiles=k_b, bm=bm_b, n_valid=b,
                                  j_sem=j_b, j_geo=cfg.j_geo, mode="range")[0]
            return ((torch.cat([qc, qs_b], 1).contiguous(), hbs.k_cat, hbs.mask_neg, i_s,
                     hbs.g_sem_sel, hbs.g_sem_vw_lr, None), dict(kw, bm=bm_b))

        ms, _, b_ms, b_by, (err, ratio) = _values_batches(
            "hier_parts_family[sel, lr]", sel_request, False,
            lambda a, k, m: rh._hier_parts_family_plain(*a, **k, magnitude=m),
            (("acc", slice(0, Dv)), ("d", slice(Dv, Dv + 1)), ("alr", slice(Dv + 128, None))),
            why)
        plain_ms = _cuda_ms(lambda: rh._hier_parts_family_plain(*args, **kw), 2)
        report["hier_parts_family_sel"] = dict(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

    sel_req = [*requests[:-1], c]
    answers, launches = _serve("sel_lr flagship", enc_s, sel_req,
                               {**flagship, "hier_parts_family_sel": 1,
                                "hier_parts_family_sel_rr": 1})
    rel = _rel(answers[-1], ref, Dv)
    mean, p99 = rel.mean().item(), torch.quantile(rel.flatten()[::4], 0.99).item()
    print(f"sel_lr=64 flagship B={BATCH} relerr vs exact f32 retrieve: mean {mean:.5f} (bar: "
          f"the flagship's {flag_mean:.5f} + 0.02, tests/test_hier.py:1090), p99 {p99:.5f}")
    if mean > flag_mean + 0.02:
        raise AssertionError("sel_lr flagship fidelity outside its bar")
    e2e["sel_lr"] = _host_ms(lambda: enc_s(c), 5)
    _trace(lambda: enc_s(c), 3, f"sel_lr flagship B={BATCH}")
    hbs_v = dataclasses.replace(hbs, **no_rr)
    enc_sv = load_model("RANGE+", db_path=hbs_v, profile="flagship", res_rank=0, sel_lr=64,
                        topk_lr=64, device=dev)
    out, got = _drive(f"sel_lr flagship without res_rank B={BATCH}", lambda: enc_sv(c),
                      {"siren_tower": 1, "hier_scan": 1, "hier_parts_family_lr": 2,
                       "hier_parts_family_sel": 1})
    rel_v = _rel(out, ref, Dv).mean().item()
    print(f"sel_lr=64 flagship without res_rank (kernel 14's lr shape) B={BATCH}: relerr mean "
          f"{rel_v:.5f}")
    if not torch.isfinite(out).all() or rel_v > 0.12:
        raise AssertionError("sel_lr without res_rank outside the knob subsets' bar 0.12")
    tally(launches)
    tally(got)

    # ---- 23. topk_lr: hier_topk over the rank-64 sketch, recall@1
    full = dataclasses.replace(hbs, topk_lr=0, g_topk_lr=None, p_topk=None)
    for k in (1, 8):
        rows, got = _drive(f"topk_lr=64 hier_topk k={k} B={BATCH} K={TOPK_K}",
                           lambda: rh.hier_topk(q, x, hbs, k=k, k_tiles=TOPK_K),
                           {"hier_scan_stats": 1, ("hier_argmax" if k == 1 else "hier_topk"): 1})
        if rows.dtype != torch.int32 or rows.shape != ((BATCH,) if k == 1 else (BATCH, k)):
            raise AssertionError(f"topk_lr hier_topk k={k}: rows {tuple(rows.shape)}")
        tally(got)
    table = []
    for seed in range(5):  # this phase's batch and four more (seeds 11-14)
        if seed:
            cb = _random_coords(BATCH, torch.Generator(device=dev).manual_seed(10 + seed), dev)
            with torch.no_grad():
                qb = enc.model.query_embedding(cb).float()
            xb = lonlat_deg_to_xyz(cb)
        else:
            qb, xb = q, x
        true = retrieval.exact_nn(qb, hbs.bank)
        table.append([(rh.hier_topk(qb, xb, b, k_tiles=TOPK_K) == true).float().mean().item()
                      for b in (hbs, full)])
    lr_rec, full_rec = (sum(col) / len(table) for col in zip(*table))
    print(f"recall@1 vs f32 exact_nn, K={TOPK_K}, B={BATCH} batches 0-4 (topk_lr=64 / the "
          "full topk_gsz operand, same bank): "
          + "; ".join(" / ".join(f"{r:.5f}" for r in row) for row in table)
          + f"; pooled: {lr_rec:.5f} / {full_rec:.5f} (bar: the full operand's - 0.02, "
          "tests/test_hier.py:1050)")
    if lr_rec < full_rec - 0.02:
        raise AssertionError("topk_lr recall@1 below its bar")
    e2e["topk_lr hier_topk"] = _host_ms(lambda: rh.hier_topk(q, x, hbs, k_tiles=TOPK_K), 5)
    e2e["hier_topk, full operand"] = _host_ms(lambda: rh.hier_topk(q, x, full,
                                                                   k_tiles=TOPK_K), 5)
    del enc_s, enc_sv, hbs, hbs_v, full

    # ---- 24. dedup: merged tile lists with pad repeats, the dedup_pad form
    bm, k_tiles, k_geo, j_sem = enc.model.config.hier_plan(BATCH)
    ku = k_tiles + k_tiles // 2  # the automatic k_union at dedup=2
    ku_g = ku * k_geo // k_tiles
    with torch.no_grad():
        q_s, q_x = rh._pad_queries(q, x, 2 * bm)
        order = rh._hybrid_order(q_x, BATCH)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[order].contiguous()
        m_s, s_s, m_g, s_g = rh._hier_scan_stats_call(q_cat, hb.g_sem_cat, hb.g_geo_cat,
                                                      gpt_s=gpt_s, gpt_g=gpt_g)
        idx_s, _ = rh.select_tiles(m_s, s_s, m_g, s_g, t_real=hb.t_real, k_tiles=k_tiles,
                                   bm=bm, n_valid=BATCH, j_sem=j_sem, mode="range")
        idx_g, _ = rh.select_tiles(m_g, s_g, m_s, s_s, t_real=hb.t_real, k_tiles=k_geo,
                                   bm=bm, n_valid=BATCH, j_sem=2, j_geo=j_sem, mode="range")
        u_s, u_g = rh._dedup_union(idx_s, 2, ku), rh._dedup_union(idx_g, 2, ku_g)
        print(f"dedup=2 B={BATCH} (bm {bm} -> {2 * bm}): sem lists {tuple(idx_s.shape)} -> "
              f"{tuple(u_s.shape)} with {_pads(u_s)} pad slots, geo {tuple(idx_g.shape)} -> "
              f"{tuple(u_g.shape)} with {_pads(u_g)} pad slots")
        if not _pads(u_s) or not _pads(u_g):
            raise AssertionError("dedup: no pad slot in the merged lists, the dedup_pad skip "
                                 "is not exercised")
        hb_v = dataclasses.replace(hb, **no_rr)
        nS = u_s.shape[0]
        merged_lists = {}

        def dedup_lists(b):
            """A B = b dedup=2 request's packed queries and merged lists:
            the first b of this phase's queries, b's own plan, k_union and
            the geo count as `_hier_partials` takes them: (q_cat, 2 bm,
            {geo: the family's list})."""
            if b not in merged_lists:
                bm_b, k_b, kg_b, j_b = enc.model.config.hier_plan(b)
                q_sb, q_xb = rh._pad_queries(q[:b], x[:b], 2 * bm_b)
                qc = rf.pack_queries(q_sb, q_xb, 12.0, 40.0, hb.tier)[
                    rh._hybrid_order(q_xb, b)].contiguous()
                st = rh._hier_scan_stats_call(qc, hb.g_sem_cat, hb.g_geo_cat, gpt_s=gpt_s,
                                              gpt_g=gpt_g)
                at = dict(t_real=hb.t_real, bm=bm_b, n_valid=b, mode="range")
                i_s = rh.select_tiles(*st, k_tiles=k_b, j_sem=j_b, **at)[0]
                i_g = rh.select_tiles(st[2], st[3], st[0], st[1], k_tiles=kg_b, j_sem=2,
                                      j_geo=j_b, **at)[0]
                ku_b = min(k_b + k_b // 2, 2 * i_s.shape[1])
                ku_gb = min(max(1, ku_b * max(kg_b, 1) // max(k_b, 1)), 2 * i_g.shape[1])
                merged_lists[b] = (qc, 2 * bm_b, {False: rh._dedup_union(i_s, 2, ku_b),
                                                  True: rh._dedup_union(i_g, 2, ku_gb)})
            return merged_lists[b]

        qs2 = _block_queries(nS, 2 * bm, dev)
        for shape, hbq in (("rr", hb), ("v", hb_v)):
            tot = [0.0, 0.0, 0.0, 0.0]
            flops = n_bytes = 0.0
            for fam, u, g_cat, vw, z, gpt, lrr in (
                    ("sem", u_s, hbq.g_sem_cat, hbq.g_sem_vw_lr, hbq.z_sem, gpt_s,
                     hbq.lr_rank),
                    ("geo", u_g, hbq.g_geo_cat, hbq.g_geo_vw_lr, hbq.z_geo, gpt_g,
                     hbq.lr_geo)):
                geo = fam == "geo"
                args = (q_cat, hbq.k_cat, hbq.mask_neg, u, g_cat, vw, z)
                kw = dict(sem_d=sem_d, bm=2 * bm, bn=hbq.bn, gpt=gpt, geo=geo, lrr=lrr,
                          dedup_pad=True, values=hbq.values, scale=None)
                W = vw.shape[1]
                a0 = z.shape[1] if z is not None else Dv
                tag = f"hier_parts_family[dedup, {'rr + lr' if z is not None else 'lr'}, {fam}]"
                if z is not None:  # on the Hopper kernel, beside the mma.sync body
                    kw = {k: v for k, v in kw.items() if k not in ("values", "scale")}
                    kw["geo_cols"] = GEO_COLS if geo else None
                    _, errs, ms, _, plain_ms, *_ = _rr_turn(
                        f"{tag} B={BATCH} k_union={u.shape[1]}", hbq, args, kw, BATCH, why,
                        plain_time=True)
                    res = (max(e for e, _ in errs), max(r for _, r in errs), ms, plain_ms)
                else:  # on the Hopper values kernel, beside the mma.sync body
                    def request(b, args=args, kw=kw, geo=geo):
                        qc, bm2, lists = dedup_lists(b)
                        return (qc,) + args[1:3] + (lists[geo],) + args[4:], dict(kw, bm=bm2)

                    ms, _, _, _, (e, r) = _values_batches(
                        tag, request, False,
                        lambda a, k, m: rh._hier_parts_family_plain(*a, **k, magnitude=m),
                        (("acc", slice(0, Dv)), ("d", slice(Dv, Dv + 1)),
                         ("alr", slice(Dv + 128, None))), why)
                    res = (e, r, ms,
                           _cuda_ms(lambda: rh._hier_parts_family_plain(*args, **kw), 2))
                tot = [max(tot[0], res[0]), max(tot[1], res[1]), tot[2] + res[2],
                       tot[3] + res[3]]
                # the work needed: each merged block's distinct tiles once
                # for its real queries: row logits over the family's real
                # columns, az or the value product per valid row, group
                # logits and alr per group
                real, kf = (GEO_COLS, hbq.cat_d - sem_d) if geo else (sem_d, sem_d)
                distinct = (u.shape[1] - (u[:, 1:] == u[:, :-1]).sum(dim=1)).double()
                pairs = (qs2 * distinct).sum().item()
                U = int(torch.unique(u).numel())
                flops += 2 * pairs * (hbq.bn * (real + a0 if z is not None else real + Dv)
                                      + gpt * (real + lrr + 1))
                row_b = (kf + (a0 if z is not None else Dv)) * 2 + 4
                n_bytes += (BATCH * kf * 2 + U * hbq.bn * row_b + U * gpt * (g_cat.shape[1] + W) * 2
                            + BATCH * (a0 + 128 + W) * 4)
            b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
            report["hier_parts_family_dedup" + ("_rr" if shape == "rr" else "")] = dict(
                max_abs_err=tot[0], err_over_tol=tot[1], ms=tot[2], plain_ms=tot[3],
                bound_ms=b_ms, bound_by=b_by)
    enc_d = load_model("RANGE+", db_path=hb, profile="flagship", dedup=2, device=dev)
    (out_d,), launches = _serve("dedup=2 flagship", enc_d, [c],
                                {**flagship, "hier_parts_family_dedup": 2,
                                 "hier_parts_family_dedup_rr": 2})
    enc_dv = load_model("RANGE+", db_path=hb_v, profile="flagship", res_rank=0, dedup=2,
                        device=dev)
    out_dv, got = _drive(f"dedup=2 flagship without res_rank B={BATCH}", lambda: enc_dv(c),
                         {"siren_tower": 1, "hier_scan": 1, "hier_parts_family_lr": 2,
                          "hier_parts_family_dedup": 2})
    tally(launches)
    tally(got)
    mean = _rel(out_d, ref, Dv).mean().item()
    base_v = load_model("RANGE+", db_path=hb_v, profile="flagship", res_rank=0,
                        device=dev)(c)
    mean_v, base_vm = (_rel(o, ref, Dv).mean().item() for o in (out_dv, base_v))
    print(f"dedup=2 flagship B={BATCH} relerr mean {mean:.5f} (bar: the flagship's "
          f"{flag_mean:.5f} x 1.02 + 1e-6, tests/test_hier.py:904); without res_rank "
          f"{mean_v:.5f} (dedup off {base_vm:.5f})")
    if mean > flag_mean * 1.02 + 1e-6 or mean_v > base_vm * 1.02 + 1e-6:
        raise AssertionError("dedup fidelity outside its bar")
    e2e["dedup"] = _host_ms(lambda: enc_d(c), 5)
    _trace(lambda: enc_d(c), 3, f"dedup=2 flagship B={BATCH}")
    del enc_d, enc_dv, hb_v

    # ---- 25. the rescue on the flagship and on the tail_super flagship
    # its re-run of kernel 14 on the flagship: the R queries covered least,
    # budgets x 3 (j + 4), blocks of 128 (`_hier_partials`)
    with torch.no_grad():
        cfg = enc.model.config
        bm, k_tiles, k_geo, j_sem = cfg.hier_plan(BATCH)
        q_s, q_x = rh._pad_queries(q, x, bm)
        qc = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[
            rh._hybrid_order(q_x, BATCH)].contiguous()
        m_s, s_s, m_g, s_g, _ = rh._hier_scan_call(qc, hb.g_sem_cat, hb.g_geo_cat,
                                                   hb.g_sem_vw_lr, hb.g_geo_vw_lr,
                                                   gpt_s=gpt_s, gpt_g=gpt_g)
        sel = dict(t_real=hb.t_real, n_valid=BATCH, mode="range")
        _, sel_s = rh.select_tiles(m_s, s_s, m_g, s_g, k_tiles=k_tiles, bm=bm, j_sem=j_sem,
                                   j_geo=cfg.j_geo, **sel)
        _, sel_g = rh.select_tiles(m_g, s_g, m_s, s_s, k_tiles=k_geo, bm=bm, j_sem=cfg.j_geo,
                                   j_geo=j_sem, **sel)
        R = int(0.05 * qc.shape[0]) // 128 * 128
        w = rh._rescue_queries(s_s, sel_s, s_g, sel_g, bm=bm, n_valid=BATCH, R=R)
        st_s, st_g = (m_s[w], s_s[w]), (m_g[w], s_g[w])
        sel.update(n_valid=R, bm=128)
        idx_s2, _ = rh.select_tiles(*st_s, *st_g, k_tiles=min(3 * k_tiles, hb.t_real),
                                    j_sem=j_sem + 4, j_geo=cfg.j_geo, **sel)
        idx_g2, _ = rh.select_tiles(*st_g, *st_s, k_tiles=min(3 * k_geo, hb.t_real),
                                    j_sem=cfg.j_geo + 4, j_geo=j_sem, **sel)
        _rr_families(f"the rescue's re-run (R={R})", hb, qc[w].contiguous(), idx_s2, idx_g2,
                     128, R, why)
    ts_kw = dict(tail_super=TAIL_SUPER, m_corr=M_CORR)
    for name, hbq, kw, want in (
            ("flagship", hb, {}, {**flagship, "hier_parts_family": 4}),
            (f"tail_super={TAIL_SUPER} flagship", hb_ts, ts_kw,
             {**flagship, "hier_parts_family": 4, "hier_scan_sup": 1, "hier_corr": 2})):
        e0 = load_model("RANGE+", db_path=hbq, profile="flagship", device=dev, **kw)
        e1 = load_model("RANGE+", db_path=hbq, profile="flagship", device=dev,
                        adaptive_frac=0.05, adaptive_mult=3, **kw)
        out0 = e0(c)
        out1, got = _drive(f"rescue (0.05, x3) {name} B={BATCH}", lambda: e1(c), want)
        tally(got)
        Bp = -(-BATCH // bm) * bm
        R = int(0.05 * Bp) // 128 * 128
        changed = (out1 != out0).any(dim=1)
        e_b, e_r = (_rel(o, ref, Dv).amax(dim=1) for o in (out0, out1))
        p99_b, p99_r = (torch.quantile(e, 0.99).item() for e in (e_b, e_r))
        print(f"rescue {name} B={BATCH}: R = {R} of {Bp} padded queries, {int(changed.sum())} "
              f"rows changed, the others bit-identical to the rescue-off output; per-query "
              f"max relerr p99 {p99_r:.5f} (off {p99_b:.5f}), max {e_r.max().item():.5f} (off "
              f"{e_b.max().item():.5f}), the rescued rows' mean {e_r[changed].mean().item():.5f} "
              f"(off {e_b[changed].mean().item():.5f})")
        # held: the substitution is surgical and the rescue caps the
        # per-query max (what the TPU history measured it for, PERF.md);
        # reported: the p99 and the rescued rows' mean, which the res_rank
        # truncation and the 128-query rescue blocks of scattered queries
        # can move either way on this bank (`tests/test_hier.py:750-761`
        # holds them on a 8,000-row bank)
        print(f"rescue {name}: p99 {'met' if p99_r <= p99_b * 1.001 else 'MISSED'} (<= off x "
              f"1.001), rescued rows' mean "
              f"{'met' if e_r[changed].mean() < e_b[changed].mean() else 'MISSED'} (lower)")
        if not 0 < int(changed.sum()) <= R or e_r.max() > e_b.max() * 1.001:
            raise AssertionError(f"rescue {name}: rows outside the rescue changed, or the "
                                 "per-query max error grew")
        e2e[f"rescue {name}"] = _host_ms(lambda: e1(c), 5)
        e2e[f"{name} (rescue off)"] = _host_ms(lambda: e0(c), 5)
    _trace(lambda: e1(c), 3, f"rescue tail_super flagship B={BATCH}")
    del e0, e1

    # ---- 26. the two-level feature path over the JAX-defaults bank + gsz_super
    one = dataclasses.replace(hb2, gsz_super=0, g_sup_cat=None, g_sup_vw=None)
    encs = {name: (load_model(name, db_path=hb2, retrieval="hier", gsz_super=hb2.gsz_super,
                              device=dev),
                   load_model(name, db_path=one, retrieval="hier", device=dev))
            for name in ("RANGE+", "RANGE")}
    cfg = encs["RANGE+"][0].model.config
    bm, k_tiles, _, j_sem = cfg.hier_plan(BATCH)
    M = min(max(32, 3 * k_tiles), hb2.t_real)
    gpt_f, gpt_sup, gpt_g = hb2.bn // hb2.gsz_sem, hb2.bn // hb2.gsz_super, hb2.bn // hb2.gsz_geo
    with torch.no_grad():
        q_s, q_x = rh._pad_queries(q, x, bm)
        order = rh._hybrid_order(q_x, BATCH)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb2.tier)[order].contiguous()
        stats = rh._hier_scan_stats_call(q_cat, hb2.g_sup_cat, hb2.g_geo_cat, gpt_s=gpt_sup,
                                         gpt_g=gpt_g)
        idx_m, _ = rh.select_tiles(*stats, t_real=hb2.t_real, k_tiles=M, bm=bm,
                                   n_valid=BATCH, j_sem=j_sem, j_geo=cfg.j_geo)
        rargs = (q_cat, idx_m, hb2.g_sem_cat, hb2.g_sup_cat, hb2.g_sem_vw, hb2.g_sup_vw)
        rkw = dict(bm=bm, gpt_f=gpt_f, gpt_sup=gpt_sup)
        pkw = dict(bm=bm, gpt_f=gpt_f, g_sup_cat=hb2.g_sup_cat, g_sem_vw=hb2.g_sem_vw,
                   g_sup_vw=hb2.g_sup_vw, gpt_sup=gpt_sup)
        got = rh._hier_refine_call(*rargs, **rkw)
        ref_p = rh._hier_refine_plain(q_cat, idx_m, hb2.g_sem_cat, **pkw)
        mag = rh._hier_refine_plain(q_cat, idx_m, hb2.g_sem_cat, **pkw, magnitude=True)[2]
        tag = f"hier_refine[has_parts] B={BATCH} M={M} gpt {gpt_f} / {gpt_sup} bm={bm}"
        errs = [_compare(f"{tag} m_f", got[0], ref_p[0], 1e-4, 0.0,
                         "f32 sums of the same bf16 products in another order, |l| < 60"),
                _compare(f"{tag} s_f", got[1], ref_p[1], 0.0, 1e-4,
                         "f32 sums of f32 exp2 in another order"),
                _compare_terms(f"{tag} parts", got[2], ref_p[2], mag,
                               "bf16 weights of f32 logits summed in another order: one "
                               "ulp of one term", rows_off_max=rows_off)]
        ms = _cuda_ms(lambda: rh._hier_refine_call(*rargs, **rkw), 10)
        plain_ms = _cuda_ms(lambda: rh._hier_refine_plain(q_cat, idx_m, hb2.g_sem_cat,
                                                          **pkw), 2)
        nB = idx_m.shape[0]
        W, U = hb2.g_sem_vw.shape[1], int(torch.unique(idx_m).numel())
        tiles = (_block_queries(nB, bm, dev) * M).sum().item()
        # the work needed: the fine and the supergroup logits over sem_d
        # columns and both products over Dv + the count, for each real
        # query's listed tiles; the listed tiles' centroid and value-sum
        # rows read once, the stats and the partials written once
        b_ms, b_by = _bound(BATCH * sem_d * 2 + U * (gpt_f + gpt_sup) * (sem_d + W) * 2
                            + 2 * BATCH * M * 4 + BATCH * W * 4,
                            2 * tiles * (gpt_f + gpt_sup) * (sem_d + Dv + 1), BF16_FLOPS)
        print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); {U} distinct tiles listed")
        report["hier_refine_parts"] = dict(max_abs_err=max(e for e, _ in errs),
                                           err_over_tol=max(r for _, r in errs), ms=ms,
                                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    two = {"siren_tower": 1, "hier_scan": 1, "hier_scan_wide": 1, "hier_refine": 1,
           "hier_refine_parts": 1, "hier_parts": 1, "hier_parts_plain": 1}
    with torch.no_grad():
        refs = {"RANGE+": ref, "RANGE": retrieval.retrieve(q, None, hb2.bank, sem_temp=15.0,
                                                           mode="range")}
    for name, bar in (("RANGE+", 0.12), ("RANGE", 0.10)):
        e2, e1 = encs[name]
        want = {**two, "hier_scan_stats": 1} if name == "RANGE" else two
        answers, got = _serve(f"two-level {name}", e2, requests, want)
        tally(got)
        rel2, rel1 = (_rel(o, refs[name], Dv) for o in (answers[-1], e1(c)))
        mean = rel2.mean().item()
        ms2, ms1 = _host_ms(lambda: e2(c), 5), _host_ms(lambda: e1(c), 5)
        e2e[f"two-level {name}"] = ms2
        print(f"two-level {name} B={BATCH} (M={M}, K={k_tiles}) relerr vs exact f32 retrieve: "
              f"mean {mean:.5f} (bar {bar}, tests/test_hier.py:{136 if bar == 0.10 else 167}), "
              f"p99 {torch.quantile(rel2.flatten()[::4], 0.99).item():.5f}; the one-level path "
              f"over the same rows: mean {rel1.mean().item():.5f}, p99 "
              f"{torch.quantile(rel1.flatten()[::4], 0.99).item():.5f}; end to end {ms2:.3f} ms "
              f"(one-level {ms1:.3f} ms)")
        if mean > bar:
            raise AssertionError(f"two-level {name}: relerr mean {mean:.5f} over its bar {bar}")
    # every request's launches: the new forms' rows take them (the rows of
    # hier_parts.cu's forms the difference of the counters, _counters),
    # the other rows add them
    for form in ("sel", "dedup"):
        rr = f"hier_parts_family_{form}_rr"
        report[rr]["launches"] = tallied[rr]
        report[f"hier_parts_family_{form}"]["launches"] = (
            tallied[f"hier_parts_family_{form}"] - tallied[rr])
    report["hier_refine_parts"]["launches"] = tallied["hier_refine_parts"]
    _tally(report, {k: n for k, n in tallied.items()
                    if k not in ("hier_refine_parts", "hier_parts_family_sel",
                                 "hier_parts_family_sel_rr", "hier_parts_family_dedup",
                                 "hier_parts_family_dedup_rr")})
    _trace(lambda: encs["RANGE+"][0](c), 3, f"two-level RANGE+ B={BATCH}")
    print("knob paths end to end B=10,000 (coords on the card), median of 5 calls: "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in e2e.items()))
    return e2e


def _parts_check(tag, q_cat, k_cat, values, mask, scale, sem_d, rows_off_max):
    """Kernel 5 against its plain version: each family's accumulators by the
    terms rule, the sums d within 1e-5 relative, the pad exactly zero.
    Returns (max abs error, error over tolerance, kernel ms, plain ms)."""
    from range_tpu_torch.ops import retrieval_fused as rf

    def kernel():
        return rf.retrieve_fused_parts(q_cat, k_cat, values, mask, scale, sem_d=sem_d)

    def plain():
        return rf._retrieve_fused_parts_plain(q_cat, k_cat, values, mask, scale,
                                              sem_d=sem_d)

    got, ref = kernel(), plain()
    mag = rf._retrieve_fused_parts_plain(q_cat, k_cat, values.abs(), mask, scale,
                                         sem_d=sem_d)
    err, ratio = _parts_hold(tag, got, ref, mag, values.shape[1], rows_off_max)
    ms = _cuda_ms(kernel, 5)
    plain_ms = _cuda_ms(plain, 3)
    print(f"{tag}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return err, ratio, ms, plain_ms


def _parts_hold(tag, got, ref, mag, Dv, rows_off_max):
    """Kernel 5's partials against its plain version's: each family's
    accumulators by the terms rule, the sums d within 1e-5 relative, the
    pad exactly zero.  Returns (max abs error, error over tolerance)."""
    flip = ("the dense kernel's rule: an exp2 within the logits' f32 difference of a "
            "bf16 boundary rounds the other way, one ulp of one term")
    errs = [_compare_terms(f"{tag} acc_s", got[:, :Dv], ref[:, :Dv], mag[:, :Dv], flip,
                           rows_off_max=rows_off_max),
            _compare_terms(f"{tag} acc_g", got[:, Dv:2 * Dv], ref[:, Dv:2 * Dv],
                           mag[:, Dv:2 * Dv], flip, rows_off_max=rows_off_max),
            _compare(f"{tag} d_s, d_g", got[:, 2 * Dv:2 * Dv + 2], ref[:, 2 * Dv:2 * Dv + 2],
                     0.0, 1e-5, "f32 sums of the same exponentials in another order")]
    if (got[:, 2 * Dv + 2:] != 0).any():
        raise AssertionError(f"{tag}: nonzero pad columns")
    return max(e[0] for e in errs), max(e[1] for e in errs)


def mesh_phases(dev, gen, report) -> float:
    """The multi-device dense path on one card: a world-size-1 NCCL process
    group (a FileStore in a temporary directory, no network), a (1, 1)
    mesh, `load_model("RANGE+" | "RANGE", db_path="synthetic:100000",
    mesh=...)` (bf16 values, and RANGE+ with value_quant="int8") at
    B=10,000 through kernel 5, each request held within 1e-3 x row max of
    the single-device model at the same seed (kernels 2, 3); kernel 5 (bf16
    and int8) against its plain version over the 102,400 rows, and the sum
    of its partials over 4 row slabs of 25,600, normalized, against kernel
    2 over the whole bank (the cross-shard combine).  Returns the RANGE+
    mesh end-to-end ms."""
    import tempfile

    import torch.distributed as dist

    from range_tpu_torch import load_model
    from range_tpu_torch.bank import dequantize_values
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.parallel.mesh import make_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            mesh = make_mesh((1, 1))
            coords = _random_coords(BATCH, gen, dev)
            e2e = {}
            for name, quant in (("RANGE+", None), ("RANGE+", "int8"), ("RANGE", None)):
                kw = dict(db_path=f"synthetic:{BANK_ROWS}", value_quant=quant)
                enc = load_model(name, mesh=mesh, **kw)
                one = load_model(name, **kw)
                tag = f"mesh (1, 1) {name}{' int8' if quant else ''} B={BATCH}"
                kernel = "fused_parts_i8" if quant else "fused_parts"
                out, got = _drive(tag, lambda: enc(coords), {"siren_tower": 1, kernel: 1})
                report.setdefault(kernel, {})["launches"] = (
                    report.get(kernel, {}).get("launches", 0) + got[kernel])
                with torch.no_grad():
                    ref = one(coords)
                err = (out - ref).abs()
                ratio = (err / (1e-3 * ref.abs().amax(dim=1, keepdim=True))).max().item()
                print(f"{tag} vs the single-device model: max_abs_err "
                      f"{err.max().item():.3e}, err/tol {ratio:.3e} (tolerance 1e-3 x row "
                      "max: the same tiles and weights, the division and blend in torch)")
                if ratio > 1.0 or out.shape != (BATCH, 1280):
                    raise AssertionError(f"{tag}: {ratio:.3f}x its tolerance")
                e2e[tag] = _host_ms(lambda: enc(coords), 5)
                print(f"{tag} end to end: {e2e[tag]:.3f} ms (single device "
                      f"{_host_ms(lambda: one(coords), 5):.3f} ms)")
                if quant:
                    bank8 = enc.model.bank
                else:
                    bank = enc.model.bank
                del enc, one
        finally:
            dist.destroy_process_group()

    # ---- kernel 5 against its plain version, B=10,000 over the 102,400 rows
    with torch.no_grad():
        q = torch.nn.functional.normalize(
            torch.randn(BATCH, bank.key_dim, generator=gen, device=dev), dim=1)
        x = lonlat_deg_to_xyz(coords)
        q_cat = rf.pack_queries(q, x, 12.0, 40.0, "fast")
        k_cat = rf.pack_bank(bank.keys_sem, bank.xyz, "fast")
        sem_d = bank.key_dim
        mask = (rf.NEG * (1.0 - bank.row_mask()))[None, :]
        vb = rf._serving_values(bank.values)
        n, Dv, cat_d = bank.n_valid, bank.value_dim, k_cat.shape[1]
        flops = 2 * BATCH * n * (sem_d + GEO_COLS) + 2 * 2 * BATCH * n * Dv
        out_bytes = BATCH * (2 * Dv + rf.PARTS_PAD) * 4
        for kernel, values, scale, row_bytes in (
                ("fused_parts", vb, None, Dv * 2 + 4),
                ("fused_parts_i8", bank8.values, bank8.value_scale, Dv + 4 + 4)):
            err, ratio, ms, plain_ms = _parts_check(
                f"{kernel} B={BATCH} N={bank.num_rows}", q_cat, k_cat, values, mask, scale,
                sem_d, max(2, BATCH // 100))
            b_ms, b_by = _bound(BATCH * cat_d * 2 + n * (cat_d * 2 + row_bytes) + out_bytes,
                                flops, BF16_FLOPS)
            report[kernel].update(max_abs_err=err, err_over_tol=ratio, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)

        # ---- the cross-shard combine: 4 slabs of partials against kernel 2
        N = bank.num_rows
        for tag, values, scale in (("bf16", vb, None),
                                   ("int8", bank8.values, bank8.value_scale)):
            parts = sum(rf.retrieve_fused_parts(
                q_cat, k_cat[r].contiguous(), values[r].contiguous(),
                mask[:, r].contiguous(), None if scale is None else scale[:, r].contiguous(),
                sem_d=sem_d) for r in (slice(i * N // 4, (i + 1) * N // 4) for i in range(4)))
            got = 0.5 * (parts[:, :Dv] / parts[:, 2 * Dv:2 * Dv + 1].clamp_min(1e-30)
                         + parts[:, Dv:2 * Dv] / parts[:, 2 * Dv + 1:2 * Dv + 2].clamp_min(1e-30))
            ref = rf.retrieve_fused(q_cat, k_cat, values, mask, 0.5, scale, sem_d=sem_d)
            vmax = (dequantize_values(bank8) if scale is not None else vb).abs().max().item()
            _compare(f"4 x {N // 4}-row slabs of {tag} partials, added and normalized, vs "
                     f"kernel {'3' if scale is not None else '2'} over {N} rows", got, ref,
                     1e-5 * vmax, 1e-5, "the same tiles and weights; the tile sums "
                     "re-associated across slabs (f32)")
    return e2e[f"mesh (1, 1) RANGE+ B={BATCH}"]


def _plan_bound(cnt_rows, q_rows, C, Dv, kept_rows, B, row_bytes):
    """Kernel 6's least time over the kept tiles: sum over query tiles of
    their real queries x the valid rows of their kept tiles x (2C + 2Dv)
    operations; the queries, the union of kept rows and the output moved
    once."""
    flops = 2 * (C + Dv) * float((cnt_rows * q_rows).sum())
    return _bound(B * C * 2 + kept_rows * (C * 2 + row_bytes) + B * Dv * 4, flops,
                  BF16_FLOPS)


def pruned_phases(dev, gen, report, bank) -> dict:
    """Pruned and hybrid dense retrieval over the clustered informative bank
    (`tools/tpu_batch9.py`: cluster_bank(bn=1024, pack="pad") of the 100k
    bank, B=10,000 tower queries, bm=256): the keep fractions, kernels 6
    (both families) and 7 against their plain versions, retrieve_pruned
    (RANGE+, RANGE) and retrieve_hybrid through their launches, each held
    to |d| / max(|ref|, 0.1) < 5e-3 of the dense kernel over the same rows;
    one int8 request at bm=64, bn=512 (`tools/tpu_batch1.py:52-55`) for
    kernel 6's int8 form; traces.  Returns each path's ms."""
    from range_tpu_torch import GeoBank, load_model
    from range_tpu_torch.bank import quantize_values
    from range_tpu_torch.bank.clustered import (cluster_bank, compute_keep_mask,
                                                compute_tile_plan)
    from range_tpu_torch.geometry import geo_sort_order, lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval_fused as rf

    BM_P, BN_P = 256, 1024
    t0 = time.perf_counter()
    cb, st = cluster_bank(bank, bn=BN_P)
    torch.cuda.synchronize()
    T = cb.num_rows // BN_P
    print(f"cluster_bank(informative:{BANK_ROWS}, bn={BN_P}, pack='pad') on the card: "
          f"{time.perf_counter() - t0:.2f} s, {cb.num_rows} rows ({T} tiles, "
          f"{cb.n_valid} valid)")
    enc = load_model("RANGE+", db_path=cb)  # the seed-0 tower; dense yardstick
    coords = _random_coords(BATCH, gen, dev)
    with torch.no_grad():
        q = enc.model.query_embedding(coords).float()
        x = lonlat_deg_to_xyz(coords)
    valid_t = cb.row_mask().reshape(T, BN_P).sum(dim=1)  # valid rows a tile
    out = {}
    with torch.no_grad():
        # ---- the plans, on the geo-sorted batch as retrieve_pruned makes them
        order = geo_sort_order(x)
        qs, xs = q[order], x[order]
        plans = {fam: compute_tile_plan(fq, c, r, temp=temp, bm=BM_P) for fam, fq, c, r, temp in (
            ("sem", qs, st.sem_centroid, st.sem_radius, 12.0),
            ("geo", xs, st.geo_centroid, st.geo_radius, 40.0))}
        for fam, (idx, cnt) in plans.items():
            print(f"tile-plan keep fraction (bm={BM_P}): {fam} "
                  f"{cnt.float().mean().item() / T:.4f} of {T} tiles")
        flags = compute_keep_mask(xs, st.geo_centroid, st.geo_radius, temp=40.0,
                                  bm=BM_P).to(torch.int32)
        print(f"hybrid geo flags: {flags.float().mean().item():.4f} of the "
              f"(query tile, bank tile) pairs")

        # ---- kernel 6 (both families of a RANGE+ request) and 7 against plain
        q_cat = rf.pack_queries(qs, xs, 12.0, 40.0, "fast")
        k_cat = rf.pack_bank(cb.keys_sem, cb.xyz, "fast")
        mask = (rf.NEG * (1.0 - cb.row_mask()))[None, :]
        vb, Dv = cb.values, cb.value_dim
        q_rows = torch.clamp(BATCH - torch.arange(0, BATCH, BM_P, device=dev), max=BM_P)
        why = ("the dense kernel's rule: an exp2 within the logits' f32 difference of a "
               "bf16 boundary rounds the other way, one ulp of one term")
        errs, ms, plain_ms, flops_ms = [], 0.0, 0.0, []
        for fam, cols, C in (("sem", slice(0, 256), 256), ("geo", slice(256, 272), GEO_COLS)):
            idx, cnt = plans[fam]
            args = (q_cat[:, cols], k_cat[:, cols], vb, mask, idx, cnt)

            def kernel():
                return rf._family_pruned_call(*args, bm=BM_P, bn=BN_P)

            def plain():
                return rf._family_pruned_plain(*args, bm=BM_P, bn=BN_P)

            mag = rf._family_pruned_plain(q_cat[:, cols], k_cat[:, cols], vb.abs(), mask,
                                          idx, cnt, bm=BM_P, bn=BN_P)
            errs.append(_compare_terms(f"family_pruned[{fam}] B={BATCH} T={T}", kernel(),
                                       plain(), mag, why, rows_off_max=BATCH // 100))
            k_ms, p_ms = _cuda_ms(kernel, 5), _cuda_ms(plain, 3)
            print(f"family_pruned[{fam}] B={BATCH}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
            ms, plain_ms = ms + k_ms, plain_ms + p_ms
            g = torch.arange(T, device=dev)[None, :] < cnt[:, None]
            kept = torch.zeros(T, dtype=torch.bool, device=dev)
            kept[idx[g].long()] = True
            rows_i = (valid_t[idx.long()] * g).sum(dim=1)  # valid rows a query tile visits
            flops_ms.append(_plan_bound(rows_i, q_rows, C, Dv, valid_t[kept].sum().item(),
                                        BATCH, Dv * 2 + 4))
        report["family_pruned"] = dict(
            max_abs_err=max(e[0] for e in errs), err_over_tol=max(e[1] for e in errs),
            ms=ms, plain_ms=plain_ms, bound_ms=sum(b for b, _ in flops_ms),
            bound_by=flops_ms[0][1])

        def kernel7():
            return rf.retrieve_fused_hybrid(q_cat, k_cat, vb, mask, 0.5, flags, sem_d=256,
                                            bm=BM_P, bn=BN_P)

        def plain7():
            return rf._retrieve_fused_hybrid_plain(q_cat, k_cat, vb, mask, 0.5, flags,
                                                   sem_d=256, bm=BM_P, bn=BN_P)

        mag = rf._retrieve_fused_hybrid_plain(q_cat, k_cat, vb.abs(), mask, 0.5, flags,
                                              sem_d=256, bm=BM_P, bn=BN_P)
        err, ratio = _compare_terms(f"fused_hybrid B={BATCH} T={T}", kernel7(), plain7(), mag,
                                    why, rows_off_max=BATCH // 100)
        k_ms, p_ms = _cuda_ms(kernel7, 5), _cuda_ms(plain7, 3)
        print(f"fused_hybrid B={BATCH}: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms")
        n = cb.n_valid
        geo_pairs = float((flags.float() * q_rows[:, None] * valid_t[None, :]).sum())
        flops = 2 * BATCH * n * (256 + Dv) + 2 * geo_pairs * (GEO_COLS + Dv)
        b_ms, b_by = _bound(BATCH * q_cat.shape[1] * 2 + n * (k_cat.shape[1] * 2 + Dv * 2 + 4)
                            + BATCH * Dv * 4, flops, BF16_FLOPS)
        report["fused_hybrid"] = dict(max_abs_err=err, err_over_tol=ratio, ms=k_ms,
                                      plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)

    # ---- the paths, each request's launches counted, against the dense kernel
    launches = {"family_pruned": 0, "fused_hybrid": 0}
    for tag, fn, mode, want in (
            ("retrieve_pruned RANGE+", lambda: rf.retrieve_pruned(
                q, x, cb, st, bm=BM_P, bn=BN_P), "range+", {"family_pruned": 2}),
            ("retrieve_pruned RANGE", lambda: rf.retrieve_pruned(
                q, None, cb, st, sem_temp=15.0, mode="range", bm=BM_P, bn=BN_P), "range",
             {"family_pruned": 1}),
            ("retrieve_hybrid RANGE+", lambda: rf.retrieve_hybrid(
                q, x, cb, st, bm=BM_P, bn=BN_P), "range+", {"fused_hybrid": 1})):
        got, n_l = _drive(f"{tag} B={BATCH}", fn, want)
        for k in launches:
            launches[k] += n_l[k]
        with torch.no_grad():
            ref = rf.retrieve_pallas(q, x, cb, sem_temp=12.0 if mode == "range+" else 15.0,
                                     mode=mode)
        rel = ((got - ref).abs() / ref.abs().clamp_min(0.1)).max().item()
        print(f"{tag} B={BATCH} vs the dense kernel over the same rows: max |d| / "
              f"max(|ref|, 0.1) = {rel:.3e} (bar 5e-3, tests/test_pruned.py:87)")
        if rel >= 5e-3 or not torch.isfinite(got).all():
            raise AssertionError(f"{tag}: relerr {rel:.3e} over 5e-3")
        out[tag] = _host_ms(fn, 5)
        print(f"{tag} B={BATCH} end to end (plans included): {out[tag]:.3f} ms")
    out["dense kernel over the clustered bank"] = _host_ms(
        lambda: rf.retrieve_pallas(q, x, cb), 5)
    print(f"retrieve_pallas RANGE+ over the clustered bank ({cb.num_rows} rows): "
          f"{out['dense kernel over the clustered bank']:.3f} ms")
    report["family_pruned"]["launches"] = launches["family_pruned"]
    report["fused_hybrid"]["launches"] = launches["fused_hybrid"]

    # ---- kernel 6's int8 form: one small request (tools/tpu_batch1.py:52-55)
    small = GeoBank.synthetic(3, 3000, key_dim=256, value_dim=128, pad_to=2048, device=dev)
    cb8, st8 = cluster_bank(quantize_values(small), n_clusters=8, bn=512)
    fb, _ = cluster_bank(small, n_clusters=8, bn=512)
    q64 = torch.nn.functional.normalize(torch.randn(64, 256, generator=gen, device=dev), dim=1)
    x64 = torch.nn.functional.normalize(torch.randn(64, 3, generator=gen, device=dev), dim=1)
    got, n_l = _drive("retrieve_pruned int8 B=64 (bm=64, bn=512)", lambda: rf.retrieve_pruned(
        q64, x64, cb8, st8, bm=64, bn=512), {"family_pruned_i8": 2})
    ref = rf.retrieve_pruned(q64, x64, fb, st8, bm=64, bn=512)
    rel = ((got - ref).abs() / ref.abs().clamp_min(0.1)).max().item()
    print(f"retrieve_pruned int8 vs bf16 values: max relerr {rel:.3e} (bar 0.05, "
          "tools/tpu_batch1.py:60)")
    if rel >= 0.05:
        raise AssertionError(f"pruned int8: relerr {rel:.3e}")
    with torch.no_grad():
        q_cat8 = rf.pack_queries(q64, x64, 12.0, 40.0, "fast")
        k_cat8 = rf.pack_bank(cb8.keys_sem, cb8.xyz, "fast")
        mask8 = (rf.NEG * (1.0 - cb8.row_mask()))[None, :]
        idx8, cnt8 = compute_tile_plan(q64, st8.sem_centroid, st8.sem_radius, temp=12.0, bm=64)
        args = (q_cat8[:, :256], k_cat8[:, :256], cb8.values, mask8, idx8, cnt8,
                cb8.value_scale)

        def kernel8():
            return rf._family_pruned_call(*args, bm=64, bn=512)

        def plain8():
            return rf._family_pruned_plain(*args, bm=64, bn=512)

        mag = rf._family_pruned_plain(q_cat8[:, :256], k_cat8[:, :256], cb8.values.abs(),
                                      mask8, idx8, cnt8, cb8.value_scale, bm=64, bn=512)
        err, ratio = _compare_terms("family_pruned_i8[sem] B=64", kernel8(), plain8(), mag,
                                    "the dense kernel's rule (the weight p x its row's scale)",
                                    rows_off_max=2)
        k_ms, p_ms = _cuda_ms(kernel8, 20), _cuda_ms(plain8, 5)
        print(f"family_pruned_i8[sem] B=64: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        T8 = cb8.num_rows // 512
        valid8 = cb8.row_mask().reshape(T8, 512).sum(dim=1)
        g8 = torch.arange(T8, device=dev)[None, :] < cnt8[:, None]
        kept8 = torch.zeros(T8, dtype=torch.bool, device=dev)
        kept8[idx8[g8].long()] = True
        b_ms, b_by = _plan_bound((valid8[idx8.long()] * g8).sum(dim=1),
                                 torch.full((1,), 64.0, device=dev), 256, 128,
                                 valid8[kept8].sum().item(), 64, 128 + 4 + 4)
        report["family_pruned_i8"] = dict(max_abs_err=err, err_over_tol=ratio, ms=k_ms,
                                          plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                                          launches=n_l["family_pruned_i8"])
    _trace(lambda: rf.retrieve_pruned(q, x, cb, st, bm=BM_P, bn=BN_P), 3,
           f"retrieve_pruned RANGE+ B={BATCH}")
    _trace(lambda: rf.retrieve_hybrid(q, x, cb, st, bm=BM_P, bn=BN_P), 3,
           f"retrieve_hybrid B={BATCH}")
    return out


def _kind(name: str) -> str:
    """A device kernel's share of a training step: convolutions (cuDNN's
    implicit GEMMs, and its FFT convolutions: the transforms and their
    complex products), the SH-times kernel, the optimizer (the foreach clip
    and AdamW), matrix products, or the rest (batch norm, ReLU, pools, the
    loss)."""
    n = name.lower()
    if "sh_times" in n:
        return "sh_times (#4)"
    if any(k in n for k in ("conv", "xmma", "implicit", "wgrad", "dgrad", "fprop",
                            "winograd", "cudnn", "fft", "complex")):
        return "convolutions"
    if any(k in n for k in ("multi_tensor", "foreach", "adam")):
        return "optimizer"
    if any(k in n for k in ("gemm", "cutlass", "gemv")):
        return "matmuls"
    return "elementwise, norms, pools, loss"


def train_phases(dev, report) -> float:
    """The SatCLIP training slice: the SH-times kernel (#4) against its plain
    version at B=10,000 and B=512, the gradients of the two autograd
    Functions against the plain compose, two optimizer steps of the
    full-width SatCLIP-ResNet18-L40 dual tower (512 x 16 samples each,
    dropout on) with their launches counted, one micro-step by the kernel
    route against the plain route, and a profiler trace of one micro-step
    with its optimizer update.  Returns the steady optimizer-step seconds."""
    from range_tpu_torch.models.resnet_std import StdResNetConfig
    from range_tpu_torch.models.satclip import SatClipLocationConfig
    from range_tpu_torch.ops import sh
    from range_tpu_torch.ops.nets import SirenNet
    from range_tpu_torch.train import satclip as tr

    # read through both of PyTorch's TF32 APIs: after the earlier phases set
    # the switches through both, `torch.get_float32_matmul_precision()`
    # raises (ROADMAP Queue 3, "TF32 switches"), the per-backend reads do not
    print(f"TF32 settings of this run: torch.backends.cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}; fp32_precision: cuda matmul "
          f"{torch.backends.cuda.matmul.fp32_precision!r}, cudnn conv "
          f"{torch.backends.cudnn.conv.fp32_precision!r}")
    gen = torch.Generator(device=dev).manual_seed(5)

    # ---- 14. kernel #4 against its plain version, the paths' shapes
    net = SirenNet(L * L, WIDTH, WIDTH, 2, device=dev, generator=gen)
    w0 = net.layers[0].weight.detach().T  # [1600, 256], the SIREN init's scale
    errs = []
    for b in (BATCH, TRAIN_MICRO):
        coords = _random_coords(b, gen, dev)
        for md in (None, torch.bfloat16):
            tag = f"sh_times[{'f32' if md is None else 'bf16'}] B={b}"

            def kernel():
                return sh.spherical_harmonics_times_fused(coords, L, w0, matmul_dtype=md)

            def plain():
                return sh._sh_times_plain(coords, L, w0, matmul_dtype=md)

            if md is None:
                errs.append(_compare(tag, kernel(), plain(), 1e-4 / 30, 0.0,
                                     "the tower rule (atol 1e-4 on sin(30 h)) carried back "
                                     "to h: the same f32 math in another summation order"))
            else:
                mag = sh._sh_times_plain(coords, L, w0, matmul_dtype=md, magnitude=True)
                errs.append(_compare_terms(tag, kernel(), plain(), mag,
                                           "the same bf16 operand rounding points; an f32 "
                                           "sum near a bf16 tie rounds the other way: one "
                                           "ulp of one term"))
            ms = _cuda_ms(kernel, 20)
            plain_ms = _cuda_ms(plain, 20)
            # the work the function needs, as the tower's bound counts it:
            # the basis (~5 operations an entry) and basis @ W0, not the
            # kernel's Fourier synthesis; coordinates, W0 and the output
            flops = 2 * b * L * L * WIDTH + 5 * b * L * L
            b_ms, b_by = _bound(b * 2 * 4 + L * L * WIDTH * 4 + b * WIDTH * 4, flops,
                                F32_FLOPS)
            print(f"{tag}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by})")
            if b == TRAIN_MICRO and md is None:  # the training path's launch
                report["sh_times"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by=b_by)
            if md is None:
                _sh_times_plans(coords, L, w0, plain())
    report["sh_times"].update(max_abs_err=max(e for e, _ in errs),
                              err_over_tol=max(r for _, r in errs))

    # ---- 15. both Functions' gradients against the plain compose
    coords = _random_coords(TRAIN_MICRO, gen, dev)
    g = torch.randn(TRAIN_MICRO, WIDTH, generator=gen, device=dev)
    w = w0.clone().requires_grad_(True)
    checks = [("sh_times d/dW0", torch.autograd.grad(
                   sh.spherical_harmonics_times_fused(coords, L, w), w, g),
               torch.autograd.grad(sh.spherical_harmonics_times(coords, L, w), w, g))]
    leaves = dict(net.named_parameters())
    checks.append(("siren_tower", torch.autograd.grad(
        sh.siren_tower(coords, L, net.tower_params()), list(leaves.values()), g),
        torch.autograd.grad(sh._siren_tower_ref(coords, L, net.tower_params()),
                            list(leaves.values()), g)))
    for tag, got, ref in checks:
        names = ["W0"] if len(got) == 1 else list(leaves)
        for name, a, b in zip(names, got, ref):
            err = (a - b).abs().max().item()
            scale = b.abs().max().item()
            print(f"{tag} gradient {name}: max_abs_err {err:.3e}, max |ref| {scale:.3e} "
                  f"(tolerance 1e-4 x max |ref|: the backward is that compose)")
            if not torch.isfinite(a).all() or err > 1e-4 * scale:
                raise AssertionError(f"{tag} gradient {name} off the plain compose")

    # ---- 16. two optimizer steps of the full-width dual tower
    cfg = tr.SatClipConfig(
        vision=StdResNetConfig(layers=(2, 2, 2, 2), block="basic", width=64,
                               in_channels=IMAGE[0], output_dim=256),
        location=SatClipLocationConfig(embed_dim=256, legendre_polys=L, capacity=WIDTH,
                                       num_hidden_layers=2, pe_type="siren"))
    model = tr.SatClipModel(cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    n = TRAIN_MICRO * TRAIN_ACCUM
    dgen = torch.Generator(device=dev).manual_seed(1)
    batch = {"image": torch.randn((n, *IMAGE), generator=dgen, device=dev),
             "point": torch.stack([torch.rand(n, generator=dgen, device=dev) * 360.0 - 180.0,
                                   torch.rand(n, generator=dgen, device=dev) * 180.0 - 90.0], 1)}
    n_params = sum(p.numel() for p in model.parameters())
    print(f"SatCLIP-ResNet18-L40: {n_params} parameters; batch {TRAIN_ACCUM} x {TRAIN_MICRO} "
          f"samples of {IMAGE} f32 ({batch['image'].numel() * 4 / 1e9:.3f} GB on the card)")
    step = tr.make_train_step(model, tr.make_optimizer(1e-4, 0.01, 1.0),
                              accum_steps=TRAIN_ACCUM)
    drop = torch.Generator(device=dev).manual_seed(2)  # the dropout masks
    losses, seconds, per_step = [], [], []

    def train():
        for i in range(TRAIN_STEPS):
            before = sh.spherical_harmonics_times_fused.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(batch, drop)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            losses.append(loss.item())
            per_step.append(sh.spherical_harmonics_times_fused.launches - before)
            print(f"train step {i}: loss {losses[-1]:.6f}, {seconds[-1]:.3f} s, "
                  f"{n / seconds[-1]:.1f} samples/s, sh_times launches {per_step[-1]}")

    torch.cuda.reset_peak_memory_stats()
    _drive(f"SatCLIP training, {TRAIN_STEPS} optimizer steps of {TRAIN_ACCUM} x {TRAIN_MICRO}",
           train, {"sh_times": TRAIN_STEPS * TRAIN_ACCUM})
    report["sh_times"]["launches"] = sum(per_step)
    print(f"training peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if not all(map(math.isfinite, losses)) or losses[-1] >= losses[0] \
            or per_step != [TRAIN_ACCUM] * TRAIN_STEPS:
        raise AssertionError(f"training: losses {losses} not finite or not falling, or "
                             f"sh_times launches per step {per_step} != {TRAIN_ACCUM}")
    steady = statistics.mean(seconds[1:])
    print(f"training step (steps 1-{TRAIN_STEPS - 1}): {steady:.3f} s, "
          f"{n / steady:.1f} samples/s")

    # ---- 17. one micro-step by the kernel route against the plain route
    images, points = batch["image"][:TRAIN_MICRO], batch["point"][:TRAIN_MICRO]
    enc = model.location
    w0p = enc.nnet.layers[0].weight

    def micro(route):
        model.zero_grad(set_to_none=True)
        drop = torch.Generator(device=dev).manual_seed(3)
        if route == "kernel":
            loc = model.encode_location(points, training=True, generator=drop)
        else:
            pre = sh._sh_times_plain(points, L, w0p.T, enc.posenc.convention)
            loc = enc.nnet(None, training=True, generator=drop,
                           first_preact=pre + enc.nnet.layers[0].bias)
        loss = tr.clip_loss(*tr._logits(model.encode_image(images), loc, model.logit_scale))
        loss.backward()
        return loss.item(), w0p.grad.clone()

    (lk, gk), (lp, gp) = micro("kernel"), micro("plain")
    rel = abs(lk - lp) / abs(lp)
    gerr, gscale = (gk - gp).abs().max().item(), gp.abs().max().item()
    print(f"route check, one micro-step: loss kernel {lk:.7f} plain {lp:.7f} (rel {rel:.3e}, "
          f"bar 1e-5); W0 gradient max_abs_err {gerr:.3e}, max |ref| {gscale:.3e} (bar 1e-3 "
          f"x max |ref|)")
    if rel > 1e-5 or gerr > 1e-3 * gscale:
        raise AssertionError("the kernel route's micro-step is off the plain route's")

    # ---- 18. where a micro-step's device time goes (with its optimizer update)
    one = tr.make_train_step(model, tr.make_optimizer(1e-4, 0.01, 1.0), accum_steps=1)
    by_name = _trace(lambda: one({"image": images, "point": points}, drop), 1,
                     f"one training micro-step B={TRAIN_MICRO} with its update")
    kinds = {}
    for name, ms in by_name.items():
        kinds[_kind(name)] = kinds.get(_kind(name), 0.0) + ms
    busy = sum(kinds.values()) or 1.0
    print("micro-step device time by kind: " + ", ".join(
        f"{k} {ms:.3f} ms ({100 * ms / busy:.2f}%)"
        for k, ms in sorted(kinds.items(), key=lambda kv: -kv[1])))
    return steady


def _trace(fn, calls: int, tag: str) -> dict:
    """torch.profiler over `calls` calls after a warm-up: the device's busy
    time (the sum of its kernels' and copies' spans; one stream, so they do
    not overlap), the host span of the window, the idle share 1 - busy /
    span, and the kernels with the most device time.  Returns the device
    ms of each kernel name over the window."""
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
            dur = (e.time_range.end - e.time_range.start) / 1e3
            by_name[e.name] = by_name.get(e.name, 0.0) + dur
    busy = sum(by_name.values())
    if not busy:
        print(f"trace {tag}: the profiler recorded no device time (not measured)")
        return by_name
    print(f"trace {tag}: {calls} calls, host span {span:.3f} ms, device busy "
          f"{busy:.3f} ms, idle share {1 - busy / span:.4f}")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"  {ms / calls:9.3f} ms/call  {100 * ms / busy:6.2f}%  {name[:90]}")
    return by_name


def _hold_cores(name: str, got, ref, mag, exact_sum: bool, b: int, why: str):
    """An f32 form's product (every rounding point f32) within 1e-4 of the
    sum of its terms' magnitudes, + 1e-6: the f32 logits in another
    summation order move p by ~1e-5 of itself at |l| <= 86 (an f32-class
    bound).  A product after a bf16 rounding point by `_compare_terms`, a
    flip of one dominant term in at most max(2, b / 100) rows.  Returns
    (max abs error, the largest error over its tolerance)."""
    if not exact_sum:
        return _compare_terms(name, got, ref, mag, why, rows_off_max=max(2, b // 100))
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: shape {tuple(got.shape)} or non-finite")
    err = (got - ref).abs()
    ratio = (err / (1e-4 * mag + 1e-6)).max().item()
    print(f"{name}: max_abs_err {err.max().item():.3e}  err/tol {ratio:.3e}  (tolerance "
          f"1e-4 x sum |terms| + 1e-6: f32 products, f32 logits in another summation order)")
    if ratio > 1.0:
        raise AssertionError(f"{name}: error {ratio:.3f}x its tolerance")
    return err.max().item(), ratio


def _cores_row(report, name, errs, call, plain, flops, n_bytes, f32: bool, reps: int = 3,
               bf16_flops: int = 0):
    """Time one CUDA-core form beside its plain version (CUDA events, the
    median of reps) and write its report row (launches come from the
    drives): the bound counts ``flops`` at the f32 rate for f32 products,
    bf16's for bf16, and ``bf16_flops`` (an f32 form's bf16 products: the
    value products against bf16 values) at bf16's, as row 2e does."""
    ms, plain_ms = _cuda_ms(call, reps), _cuda_ms(plain, reps)
    rate = F32_FLOPS if f32 else BF16_FLOPS
    b_ms, b_by = _bound(n_bytes, flops + bf16_flops * rate / BF16_FLOPS, rate)
    print(f"{name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
          f"({b_by}), share {b_ms / ms:.4f}")
    report[name] = dict(max_abs_err=max(e for e, _ in errs),
                        err_over_tol=max(r for _, r in errs), ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, launches=0)


def _tier_kernels(tier, form, hb, hb_ts, hb2, q, x, report, cfg) -> None:
    """Each CUDA-core form of kernels 8, 9 and 12-15 (at `high`, kernels 14
    and 15 on their Hopper bodies' deep chains, then timed beside the
    CUDA-core body: `_deep_parts_turns`) against its plain
    version at its path's shapes (B = 10,000): the flagship's scan and
    kernel 14's rr + lr shape (both families), kernel 15 lr at the RANGE
    flagship's selection, the stats scan at hier_topk's (the topk_gsz
    operand), kernel 13 at the tail_super bank's and kernel 12 (stats,
    parts) at the two-level bank's; times, bounds."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    f32 = tier == "exact"
    el = 4 if f32 else 2  # bytes of a packed element (the group operands too)
    geo_real = rf.geo_real_cols(tier)
    flip = ("a weight within the logits' f32 difference of a bf16 boundary rounds the "
            "other way: one ulp of one term")
    bm, k_tiles, k_geo, j_sem = cfg.hier_plan(BATCH)
    q_s, q_x = rh._pad_queries(q, x, bm)
    order = rh._hybrid_order(q_x, BATCH)

    def packed(h):
        return rf.pack_queries(q_s, q_x, 12.0, 40.0, h.tier)[order].contiguous()

    q_cat = packed(hb)
    Bp, cat_d, sem_d = q_cat.shape[0], q_cat.shape[1], hb.sem_d
    gpt_s, gpt_g = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo
    Gs, Gg, Dv = hb.t_real * gpt_s, hb.t_real * gpt_g, hb.value_dim

    # kernel 8: the flagship's scan
    sa = (q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw_lr)
    skw = dict(gpt_s=gpt_s, gpt_g=gpt_g)
    got, ref = rh._hier_scan_call(*sa, **skw), rh._hier_scan_plain(*sa, **skw)
    mag = rh._hier_scan_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat, hb.g_sem_vw_lr.abs(),
                              hb.g_geo_vw_lr.abs(), **skw)[4]
    Ws, Wg = hb.g_sem_vw_lr.shape[1], hb.g_geo_vw_lr.shape[1]
    errs = [_compare(f"hier_scan_{form} m_s", got[0], ref[0], 1e-4, 0.0, "f32 logits"),
            _compare(f"hier_scan_{form} s_s", got[1], ref[1], 0.0, 1e-4, "f32 sums"),
            _compare(f"hier_scan_{form} m_g", got[2], ref[2], 1e-4, 0.0, "f32 logits"),
            _compare(f"hier_scan_{form} s_g", got[3], ref[3], 0.0, 1e-4, "f32 sums"),
            _hold_cores(f"hier_scan_{form} tails", got[4], ref[4], mag, f32, BATCH, flip)]
    m_s, s_s, m_g, s_g, _ = ref
    flops = 2 * BATCH * (Gs * (sem_d + hb.lr_rank + 1) + Gg * (geo_real + hb.lr_geo + 1))
    n_bytes = (Bp * cat_d * el + (Gs * (sem_d + Ws) + Gg * (cat_d - sem_d + Wg)) * el
               + 4 * Bp * hb.t_pad * 4 + Bp * (Ws + Wg) * 4)
    _cores_row(report, f"hier_scan_{form}", errs, lambda: rh._hier_scan_call(*sa, **skw),
               lambda: rh._hier_scan_plain(*sa, **skw), flops, n_bytes, f32)
    # the scan's sem group pass taken apart, at the wrapper's segments: the
    # logits and stats over one 64-column piece and over every column, and
    # with the tail product (what the time goes to: PERF.md section 5)
    st = [torch.empty((Bp, hb.t_pad), dtype=torch.float32, device=q_cat.device)
          for _ in range(2)]
    out = torch.empty((Bp, Ws), dtype=torch.float32, device=q_cat.device)
    n_seg = rh._cores_segments(Bp, -(-Ws // rh.CORES_NC), hb.t_pad)
    part = dict(gpt=gpt_s, n_tiles=hb.t_pad, stats=st, n_seg=n_seg)
    one = _cuda_ms(lambda: rh._cores_groups(q_cat, hb.g_sem_cat, wk=64, **part), 3)
    full = _cuda_ms(lambda: rh._cores_groups(q_cat, hb.g_sem_cat, wk=sem_d, **part), 3)
    tail = _cuda_ms(lambda: rh._cores_groups(q_cat, hb.g_sem_cat, wk=sem_d, vw=hb.g_sem_vw_lr,
                                             nvc=Ws, out=out, **part), 3)
    print(f"hier_scan_{form} sem pass ({n_seg} segments, {hb.g_sem_cat.shape[0] // 32} "
          f"chunks of 32 groups a 64 queries): logits + stats {full:.3f} ms (over one "
          f"64-column piece {one:.3f}), + the {Ws}-column tail {tail:.3f} ms")

    # kernel 14, the rr + lr shape of both families (the flagship's)
    sel = dict(t_real=hb.t_real, bm=bm, n_valid=BATCH, mode="range")
    idx_s, _ = rh.select_tiles(m_s, s_s, m_g, s_g, k_tiles=k_tiles, j_sem=j_sem,
                               j_geo=cfg.j_geo, **sel)
    idx_g, _ = rh.select_tiles(m_g, s_g, m_s, s_s, k_tiles=k_geo, j_sem=cfg.j_geo,
                               j_geo=j_sem, **sel)
    fams = []
    for geo, idx, g_cat, vw, z, lrr in ((False, idx_s, hb.g_sem_cat, hb.g_sem_vw_lr, hb.z_sem,
                                         hb.lr_rank),
                                        (True, idx_g, hb.g_geo_cat, hb.g_geo_vw_lr, hb.z_geo,
                                         hb.lr_geo)):
        args = (q_cat, hb.k_cat, hb.mask_neg, idx, g_cat, vw, z)
        kw = dict(sem_d=sem_d, bm=bm, bn=hb.bn, gpt=gpt_g if geo else gpt_s, geo=geo, lrr=lrr)
        fams.append((args, kw, dict(geo_cols=geo_real)))
    errs = []
    for args, kw, cut in fams:
        got = rh._hier_parts_family_call(*args, **kw, **cut)
        errs.append(_hold_cores(f"hier_parts_family_{form}[{'geo' if kw['geo'] else 'sem'}]",
                                got, rh._hier_parts_family_plain(*args, **kw),
                                rh._hier_parts_family_plain(*args, **kw, magnitude=True), f32,
                                BATCH, flip))
    flops = n_bytes = 0
    for args, kw, _ in fams:
        idx, K, gpt = args[3], args[3].shape[1], kw["gpt"]
        kf = geo_real if kw["geo"] else sem_d
        rows = idx.unique().numel() * hb.bn
        W = args[5].shape[1]
        flops += 2 * BATCH * K * (hb.bn * (kf + hb.res_rank) + gpt * (kf + kw["lrr"] + 1))
        n_bytes += (rows * (cat_d * el + args[6].shape[1] * el + 4)
                    + rows // hb.bn * gpt * (args[4].shape[1] + W) * el
                    + Bp * (cat_d * el + (args[6].shape[1] + 128 + W) * 4))
    _cores_row(report, f"hier_parts_family_{form}", errs,
               lambda: [rh._hier_parts_family_call(*a, **k, **c) for a, k, c in fams],
               lambda: [rh._hier_parts_family_plain(*a, **k) for a, k, _ in fams],
               flops, n_bytes, f32)

    # kernel 15 lr at the RANGE flagship's selection (the sem family; geo skipped)
    idx_r, _ = rh.select_tiles(m_s, s_s, None, None, k_tiles=k_tiles, j_sem=j_sem,
                               j_geo=cfg.j_geo, **sel)
    ma = (q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx_r, hb.g_sem_cat,
          hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw)
    mkw = dict(sem_d=sem_d, bm=bm, bn=hb.bn, gpt_s=gpt_s, gpt_g=gpt_g, lr=True, geo=False)
    got, ref = rh._hier_parts_call(*ma, **mkw), rh._hier_parts_plain(*ma, **mkw)
    mag = rh._hier_parts_plain(*ma, **mkw, magnitude=True)
    exact_sum = f32 and hb.values.dtype == torch.float32
    errs = [_hold_cores(f"hier_parts_{form} acc_s", got[:, :Dv], ref[:, :Dv], mag[:, :Dv],
                        exact_sum, BATCH, flip),
            _hold_cores(f"hier_parts_{form} d_s, alr", got[:, 2 * Dv:], ref[:, 2 * Dv:],
                        mag[:, 2 * Dv:], f32, BATCH, flip)]
    K = idx_r.shape[1]
    rows = idx_r.unique().numel() * hb.bn
    flops = 2 * BATCH * K * (hb.bn * sem_d + gpt_s * (sem_d + hb.lr_rank + 1))
    pv = 2 * BATCH * K * hb.bn * Dv  # p @ V: bf16 on the tensor cores unless V is f32
    n_bytes = (rows * (sem_d * el + Dv * hb.values.element_size() + 4)
               + rows // hb.bn * gpt_s * (sem_d + Ws) * el + Bp * sem_d * el
               + Bp * (2 * Dv + 128 + Ws) * 4)
    _cores_row(report, f"hier_parts_{form}", errs, lambda: rh._hier_parts_call(*ma, **mkw),
               lambda: rh._hier_parts_plain(*ma, **mkw), flops + (pv if exact_sum else 0),
               n_bytes, f32, bf16_flops=0 if exact_sum else pv)

    # kernel 9 at hier_topk's shape (the fine topk_gsz operand)
    gpt_t = hb.bn // hb.topk_gsz
    ta = (q_cat, hb.g_topk_cat, hb.g_geo_cat)
    tkw = dict(gpt_s=gpt_t, gpt_g=gpt_g)
    got, ref = rh._hier_scan_stats_call(*ta, **tkw), rh._hier_scan_stats_plain(*ta, **tkw)
    errs = [_compare(f"hier_scan_stats_{form} {n}", got[i], ref[i], *(
        (1e-4, 0.0, "f32 logits") if n[0] == "m" else (0.0, 1e-4, "f32 sums")))
        for i, n in enumerate(("m_s", "s_s", "m_g", "s_g"))]
    Gt = hb.t_real * gpt_t
    flops = 2 * BATCH * (Gt * sem_d + Gg * geo_real)
    n_bytes = Bp * cat_d * el + (Gt * sem_d + Gg * (cat_d - sem_d)) * el + 4 * Bp * hb.t_pad * 4
    _cores_row(report, f"hier_scan_stats_{form}", errs,
               lambda: rh._hier_scan_stats_call(*ta, **tkw),
               lambda: rh._hier_scan_stats_plain(*ta, **tkw), flops, n_bytes, f32)

    # kernel 13 at the tail_super bank's selection (K + m_corr tiles)
    q_ts = packed(hb_ts)
    st = rh._hier_scan_stats_plain(q_ts, hb_ts.g_sem_cat, hb_ts.g_geo_cat,
                                   gpt_s=hb_ts.bn // hb_ts.gsz_sem,
                                   gpt_g=hb_ts.bn // hb_ts.gsz_geo)
    idx_c, _ = rh.select_tiles(*st, t_real=hb_ts.t_real, k_tiles=k_tiles + M_CORR, bm=bm,
                               n_valid=BATCH, j_sem=j_sem, j_geo=cfg.j_geo, mode="range")
    gpt_c = hb_ts.bn // hb_ts.gsz_sem
    ca = (q_ts, idx_c, hb_ts.g_sem_cat, hb_ts.g_sem_ts_dvw)
    got, ref = rh._hier_corr_call(*ca, bm=bm, gpt=gpt_c), rh._hier_corr_plain(*ca, bm=bm,
                                                                               gpt=gpt_c)
    errs = [_hold_cores(f"hier_corr_{form}", got, ref,
                        rh._hier_corr_plain(*ca, bm=bm, gpt=gpt_c, magnitude=True), f32, BATCH,
                        flip)]
    M, Wc = idx_c.shape[1], hb_ts.g_sem_ts_dvw.shape[1]
    groups = idx_c.unique().numel() * gpt_c
    flops = 2 * BATCH * M * gpt_c * (sem_d + hb_ts.lr_rank + 1)
    n_bytes = Bp * sem_d * el + groups * (sem_d + Wc) * el + Bp * Wc * 4
    _cores_row(report, f"hier_corr_{form}", errs, lambda: rh._hier_corr_call(
        *ca, bm=bm, gpt=gpt_c), lambda: rh._hier_corr_plain(*ca, bm=bm, gpt=gpt_c), flops,
        n_bytes, f32)

    # kernel 12 at the two-level bank's M coarse tiles (stats, and has_parts)
    q_2 = packed(hb2)
    gpt_f, gpt_u = hb2.bn // hb2.gsz_sem, hb2.bn // hb2.gsz_super
    st = rh._hier_scan_stats_plain(q_2, hb2.g_sup_cat, hb2.g_geo_cat, gpt_s=gpt_u,
                                   gpt_g=hb2.bn // hb2.gsz_geo)
    idx_m, _ = rh.select_tiles(*st, t_real=hb2.t_real, k_tiles=TOPK_M, bm=bm, n_valid=BATCH,
                               j_sem=j_sem, j_geo=cfg.j_geo, mode="range")
    ra = (q_2, idx_m, hb2.g_sem_cat, hb2.g_sup_cat, hb2.g_sem_vw, hb2.g_sup_vw)
    rkw = dict(bm=bm, gpt_f=gpt_f)
    pkw = dict(rkw, g_sup_cat=hb2.g_sup_cat, g_sem_vw=hb2.g_sem_vw, g_sup_vw=hb2.g_sup_vw,
               gpt_sup=gpt_u)
    errs = []
    for stats_only in (True, False):
        got = rh._hier_refine_call(*ra, bm=bm, gpt_f=gpt_f, gpt_sup=gpt_u,
                                   stats_only=stats_only)
        ref = rh._hier_refine_plain(q_2, idx_m, hb2.g_sem_cat, **(rkw if stats_only else pkw))
        errs += [_compare(f"hier_refine_{form} m_f", got[0], ref[0], 1e-4, 0.0, "f32 logits"),
                 _compare(f"hier_refine_{form} s_f", got[1], ref[1], 0.0, 1e-4, "f32 sums")]
        if not stats_only:
            mag = rh._hier_refine_plain(q_2, idx_m, hb2.g_sem_cat, **pkw, magnitude=True)[2]
            errs.append(_hold_cores(f"hier_refine_{form} parts", got[2], ref[2], mag, f32,
                                    BATCH, flip))
    M, W2 = idx_m.shape[1], hb2.g_sem_vw.shape[1]
    tiles = idx_m.unique().numel()
    # the timed call is the has_parts form alone: each level's groups once
    flops = 2 * BATCH * M * (gpt_f + gpt_u) * (sem_d + Dv + 1)
    n_bytes = (Bp * sem_d * el + tiles * (gpt_f + gpt_u) * (sem_d + W2) * el
               + Bp * (2 * M + W2) * 4)
    _cores_row(report, f"hier_refine_{form}", errs, lambda: rh._hier_refine_call(
        *ra, bm=bm, gpt_f=gpt_f, gpt_sup=gpt_u),
        lambda: rh._hier_refine_plain(q_2, idx_m, hb2.g_sem_cat, **pkw), flops, n_bytes, f32)
    if form == "deep":  # kernels 14 and 15's Hopper bodies beside the CUDA-core body
        _deep_parts_turns(hb, q, x, cfg)


def _deep_parts_turns(hb, q, x, cfg) -> None:
    """Kernels 14 (the flagship's rr + lr shape, both families) and 15 (lr
    at RANGE's selection, the sem family) at the `high` tier on their Hopper
    bodies' deep chains (`_hier_parts_family_call` / `_hier_parts_call`:
    768 logit columns in passes of 256), in turns beside the CUDA-core
    body's deep form (`_parts_family_cores` / `_parts_cores`, csrc/
    hier_cores.cu, which only this yardstick launches), cores, Hopper,
    Hopper, cores on CUDA events (`_turns_ms`; nothing counted), at B = 1,
    37, 1,000 and 10,000, each batch its own request (the first b queries,
    its plan's bm and budgets, tiles selected from the plain stats).  Each
    held against the plain version over its b real rows (the padded rows,
    sorted last, are dropped by the path): the terms rule, flips in at most
    max(2, b / 100) rows; bound and share as the rows 14x / 15x count them.
    At each batch the other `high` forms are held too (`_deep_forms`)."""
    from range_tpu_torch.ops import retrieval_fused as rf
    from range_tpu_torch.ops import retrieval_hier as rh

    flip = ("a weight within the logits' f32 difference of a bf16 boundary rounds the "
            "other way: one ulp of one term")
    geo_real = rf.geo_real_cols(hb.tier)
    gpt_s, gpt_g, Dv, sem_d = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo, hb.value_dim, hb.sem_d
    Ws = hb.g_sem_vw_lr.shape[1]
    # an int8 bank's values: each row's codes and scale (its max / 127)
    row_max = hb.values.float().abs().amax(1).clamp_min(1e-8) / 127
    codes = ((hb.values.float() / row_max[:, None]).round().clamp(-127, 127).to(torch.int8),
             row_max[None, :].contiguous())
    for b in REQUESTS:
        bm, k_tiles, k_geo, j_sem = cfg.hier_plan(b)
        q_s, q_x = rh._pad_queries(q[:b], x[:b], bm)
        order = rh._hybrid_order(q_x, b)
        q_cat = rf.pack_queries(q_s, q_x, 12.0, 40.0, hb.tier)[order].contiguous()
        Bp, cat_d = q_cat.shape
        m_s, s_s, m_g, s_g = rh._hier_scan_stats_plain(q_cat, hb.g_sem_cat, hb.g_geo_cat,
                                                       gpt_s=gpt_s, gpt_g=gpt_g)
        sel = dict(t_real=hb.t_real, bm=bm, n_valid=b, mode="range")
        idx_s = rh.select_tiles(m_s, s_s, m_g, s_g, k_tiles=k_tiles, j_sem=j_sem,
                                j_geo=cfg.j_geo, **sel)[0]
        idx_g = rh.select_tiles(m_g, s_g, m_s, s_s, k_tiles=k_geo, j_sem=cfg.j_geo,
                                j_geo=j_sem, **sel)[0]
        idx_r = rh.select_tiles(m_s, s_s, None, None, k_tiles=k_tiles, j_sem=j_sem,
                                j_geo=cfg.j_geo, **sel)[0]

        # kernel 14, both families
        fams = [((q_cat, hb.k_cat, hb.mask_neg, idx, g_cat, vw, z),
                 dict(sem_d=sem_d, bm=bm, bn=hb.bn, gpt=gpt_g if geo else gpt_s, geo=geo,
                      lrr=lrr))
                for geo, idx, g_cat, vw, z, lrr in (
                    (False, idx_s, hb.g_sem_cat, hb.g_sem_vw_lr, hb.z_sem, hb.lr_rank),
                    (True, idx_g, hb.g_geo_cat, hb.g_geo_vw_lr, hb.z_geo, hb.lr_geo))]
        for a, k in fams:
            got = rh._hier_parts_family_call(*a, **k, geo_cols=geo_real)
            ref = rh._hier_parts_family_plain(*a, **k)
            mag = rh._hier_parts_family_plain(*a, **k, magnitude=True)
            _compare_terms(f"hier_parts_family_deep B={b} [{'geo' if k['geo'] else 'sem'}] "
                           "vs plain", got[:b], ref[:b], mag[:b], flip,
                           rows_off_max=max(2, b // 100))
        cores_kw = dict(lr=True, values=None, scale=None, sel=False, dedup_pad=False,
                        geo_cols=geo_real)
        t = _turns_ms((
            ("cores", lambda: [rh._parts_family_cores(*a, **k, **cores_kw) for a, k in fams]),
            ("hopper", lambda: [rh._hier_parts_family_call(*a, **k, geo_cols=geo_real)
                                for a, k in fams]),
            ("hopper", lambda: [rh._hier_parts_family_call(*a, **k, geo_cols=geo_real)
                                for a, k in fams]),
            ("cores", lambda: [rh._parts_family_cores(*a, **k, **cores_kw) for a, k in fams])), 3)
        flops = n_bytes = 0
        for a, k in fams:
            idx, K, gpt = a[3], a[3].shape[1], k["gpt"]
            kf = geo_real if k["geo"] else sem_d
            rows = idx.unique().numel() * hb.bn
            W = a[5].shape[1]
            flops += 2 * b * K * (hb.bn * (kf + hb.res_rank) + gpt * (kf + k["lrr"] + 1))
            n_bytes += (rows * (cat_d * 2 + a[6].shape[1] * 2 + 4)
                        + rows // hb.bn * gpt * (a[4].shape[1] + W) * 2
                        + Bp * (cat_d * 2 + (a[6].shape[1] + 128 + W) * 4))
        b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
        print(f"hier_parts_family_deep B={b} K={idx_s.shape[1]} / {idx_g.shape[1]} bm={bm}: "
              f"Hopper bodies {t['hopper']:.4f} ms, hier_cores.cu deep form {t['cores']:.4f} "
              f"ms (CUDA events, turns cores, Hopper, Hopper, cores; "
              f"{t['cores'] / t['hopper']:.2f}x); bound {b_ms:.4f} ms ({b_by}), share "
              f"{b_ms / t['hopper']:.4f}")

        # kernel 15 lr, the sem family
        ma = (q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx_r, hb.g_sem_cat,
              hb.g_geo_cat, hb.g_sem_vw_lr, hb.g_geo_vw)
        mkw = dict(sem_d=sem_d, bm=bm, bn=hb.bn, gpt_s=gpt_s, gpt_g=gpt_g, lr=True, geo=False)
        got = rh._hier_parts_call(*ma, **mkw)
        ref = rh._hier_parts_plain(*ma, **mkw)
        mag = rh._hier_parts_plain(*ma, **mkw, magnitude=True)
        for name, c in (("acc_s", slice(0, Dv)), ("d_s", slice(2 * Dv, 2 * Dv + 1)),
                        ("alr", slice(2 * Dv + 128, None))):
            _compare_terms(f"hier_parts_deep B={b} {name} vs plain", got[:b, c], ref[:b, c],
                           mag[:b, c], flip, rows_off_max=max(2, b // 100))
        t = _turns_ms((("cores", lambda: rh._parts_cores(*ma, **mkw)),
                       ("hopper", lambda: rh._hier_parts_call(*ma, **mkw)),
                       ("hopper", lambda: rh._hier_parts_call(*ma, **mkw)),
                       ("cores", lambda: rh._parts_cores(*ma, **mkw))), 3)
        _deep_forms(hb, b, q_cat, idx_s, idx_r, codes, flip)
        K = idx_r.shape[1]
        rows = idx_r.unique().numel() * hb.bn
        flops = 2 * b * K * (hb.bn * (sem_d + Dv) + gpt_s * (sem_d + hb.lr_rank + 1))
        n_bytes = (rows * (sem_d * 2 + Dv * hb.values.element_size() + 4)
                   + rows // hb.bn * gpt_s * (sem_d + Ws) * 2 + Bp * sem_d * 2
                   + Bp * (2 * Dv + 128 + Ws) * 4)
        b_ms, b_by = _bound(n_bytes, flops, BF16_FLOPS)
        print(f"hier_parts_deep B={b} K={K} bm={bm}: Hopper body {t['hopper']:.4f} ms, "
              f"hier_cores.cu deep form {t['cores']:.4f} ms (CUDA events, turns cores, "
              f"Hopper, Hopper, cores; {t['cores'] / t['hopper']:.2f}x); bound {b_ms:.4f} ms "
              f"({b_by}), share {b_ms / t['hopper']:.4f}")


def _deep_forms(hb, b, q_cat, idx_s, idx_r, codes, flip) -> None:
    """The `high` forms of kernels 14 and 15 beside the flagship's, at one
    request's selection (the sem family, over its b real rows), each on its
    Hopper body against the plain version (the terms rule, flips in at
    most max(2, b / 100) rows): kernel 14's rr alone (the full-width sums),
    rr + lr with each list's first entry repeated (dedup_pad) and over a
    64-column sel sketch (the query's first 64 sem columns against the
    centroids'), its value shapes (lr, plain); kernel 15 plain with the geo
    family (the JAX defaults' launch) and lr over int8 codes of the bank's
    values (``codes``: codes and row scales)."""
    from range_tpu_torch.ops import retrieval_hier as rh

    gpt_s, gpt_g, Dv, sem_d = hb.bn // hb.gsz_sem, hb.bn // hb.gsz_geo, hb.value_dim, hb.sem_d
    bm = q_cat.shape[0] // idx_s.shape[0]
    fam = dict(sem_d=sem_d, bm=bm, bn=hb.bn, gpt=gpt_s, geo=False)
    rr = (q_cat, hb.k_cat, hb.mask_neg)
    idx_d = torch.cat([idx_s[:, :1], idx_s[:, :-1]], 1).contiguous()
    q_sel = torch.cat([q_cat, q_cat[:, :64]], 1).contiguous()
    whole = [("", slice(None))]
    merged = [("acc_s", slice(0, Dv)), ("acc_g", slice(Dv, 2 * Dv)),
              ("d", slice(2 * Dv, 2 * Dv + 2)), ("alr", slice(2 * Dv + 128, None))]
    value = [("acc", slice(0, Dv)), ("d", slice(Dv, Dv + 1)), ("alr", slice(Dv + 128, None))]
    forms = (
        ("hier_parts_family_deep rr", rh._hier_parts_family_call, rh._hier_parts_family_plain,
         (*rr, idx_s, hb.g_sem_cat, hb.g_sem_vw, hb.z_sem), dict(fam, lrr=Dv, lr=False), whole),
        ("hier_parts_family_deep rr + lr dedup_pad", rh._hier_parts_family_call,
         rh._hier_parts_family_plain,
         (*rr, idx_d, hb.g_sem_cat, hb.g_sem_vw_lr, hb.z_sem),
         dict(fam, lrr=hb.lr_rank, dedup_pad=True), whole),
        ("hier_parts_family_deep rr + lr sel", rh._hier_parts_family_call,
         rh._hier_parts_family_plain,
         (q_sel, hb.k_cat, hb.mask_neg, idx_s, hb.g_sem_cat[:, :64].contiguous(),
          hb.g_sem_vw_lr, hb.z_sem), dict(fam, lrr=hb.lr_rank, sel=True), whole),
        ("hier_parts_family_deep values lr", rh._hier_parts_family_call,
         rh._hier_parts_family_plain,
         (*rr, idx_s, hb.g_sem_cat, hb.g_sem_vw_lr, None),
         dict(fam, lrr=0, lr=True, values=hb.values, scale=hb.value_scale), value),
        ("hier_parts_family_deep values plain", rh._hier_parts_family_call,
         rh._hier_parts_family_plain,
         (*rr, idx_s, hb.g_sem_cat, hb.g_sem_vw, None),
         dict(fam, lrr=0, lr=False, values=hb.values, scale=hb.value_scale), value[:2]),
        ("hier_parts_deep plain + geo", rh._hier_parts_call, rh._hier_parts_plain,
         (q_cat, hb.k_cat, hb.values, hb.value_scale, hb.mask_neg, idx_r, hb.g_sem_cat,
          hb.g_geo_cat, hb.g_sem_vw, hb.g_geo_vw),
         dict(sem_d=sem_d, bm=bm, bn=hb.bn, gpt_s=gpt_s, gpt_g=gpt_g, lr=False, geo=True),
         merged[:3]),
        ("hier_parts_deep lr int8", rh._hier_parts_call, rh._hier_parts_plain,
         (q_cat, hb.k_cat, *codes, hb.mask_neg, idx_r, hb.g_sem_cat, hb.g_geo_cat,
          hb.g_sem_vw_lr, hb.g_geo_vw),
         dict(sem_d=sem_d, bm=bm, bn=hb.bn, gpt_s=gpt_s, gpt_g=gpt_g, lr=True, geo=False),
         [merged[0], ("d_s", slice(2 * Dv, 2 * Dv + 1)), merged[3]]))
    for tag, call, plain, args, kw, segs in forms:
        got = call(*args, **kw)
        ref, mag = plain(*args, **kw), plain(*args, **kw, magnitude=True)
        for name, c in segs:
            _compare_terms(f"{tag} B={b} {name} vs plain".replace("  ", " "), got[:b, c],
                           ref[:b, c], mag[:b, c], flip, rows_off_max=max(2, b // 100))


def _tier_fidelity(tag, out, coords, bank, mode, bar_mean, bar_p99=None):
    """relerr (floor 0.1) of a served batch against the exact f32 retrieve."""
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval

    Dv = bank.value_dim
    if out.shape != (coords.shape[0], Dv + 256) or not torch.isfinite(out).all():
        raise AssertionError(f"{tag}: shape {tuple(out.shape)} or non-finite")
    with torch.no_grad():
        ref = (retrieval.retrieve(out[:, Dv:], lonlat_deg_to_xyz(coords), bank, sem_temp=12.0)
               if mode == "range+" else
               retrieval.retrieve(out[:, Dv:], None, bank, sem_temp=15.0, mode="range"))
    rel = (out[:, :Dv] - ref).abs() / ref.abs().clamp_min(0.1)
    mean, p99 = rel.mean().item(), torch.quantile(rel.flatten()[::4], 0.99).item()
    print(f"{tag} relerr vs exact f32 retrieve: mean {mean:.5f} (bar {bar_mean}), p99 "
          f"{p99:.5f}" + (f" (bar {bar_p99}; every 4th element)" if bar_p99 else ""))
    if mean > bar_mean or (bar_p99 is not None and p99 > bar_p99):
        raise AssertionError(f"{tag}: fidelity outside its bars")


def wide_keys_phases(dev, gen, report) -> dict:
    """`hier_topk` over keys wider than 256 columns (kernels 10 and 11,
    passes of 128 columns a step): a 20,000-row informative bank of 512-d keys
    (`GeoBank.synthetic_informative(key_dim=512)`; bn 512, gsz_sem 16,
    gsz_geo 64, topk_gsz 8, built on the card), queries near its rows (a
    row's key plus noise 0.3, its place jittered 3 degrees: the regional
    batches the endpoint serves), k = 1 and 8 at B = 1,000 and 10,000,
    each request's launches counted (the stats scan's 512 columns on its
    deep form); the kernel's lists at each request held against the plain
    version (`_compare_klist`, 1e-5, rows off only at near-ties) and timed
    with their bound, recall@1 against exact_nn printed.  Adds the
    launches to rows 10 and 11; returns each request's end-to-end ms."""
    from range_tpu_torch import GeoBank
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_hier as rh

    t0 = time.perf_counter()
    bank = GeoBank.synthetic_informative(11, WIDE_ROWS, key_dim=WIDE_KEY_DIM, pad_to=512,
                                         device=dev)
    hb = rh.build_hier_bank(bank, bn=512, gsz_sem=16, gsz_geo=64, topk_gsz=8)
    torch.cuda.synchronize()
    print(f"wide keys: build_hier_bank ({WIDE_ROWS} rows, {WIDE_KEY_DIM}-d keys): "
          f"{time.perf_counter() - t0:.2f} s")
    rows = torch.randint(0, WIDE_ROWS, (BATCH,), generator=gen, device=dev)
    q = torch.nn.functional.normalize(bank.keys_sem[rows].float() + 0.3 * torch.randn(
        BATCH, WIDE_KEY_DIM, generator=gen, device=dev), dim=1)
    ll = bank.locs_lonlat[rows].float() + 3.0 * torch.randn(BATCH, 2, generator=gen, device=dev)
    x = lonlat_deg_to_xyz(torch.stack([(ll[:, 0] + 180) % 360 - 180,
                                       ll[:, 1].clamp(-89.9, 89.9)], 1))
    why = ("hi/lo logits in another f32 order (passes of one chain): rows off only at "
           "near-ties")
    e2e, launches = {}, {"hier_argmax": 0, "hier_topk": 0}
    for b in (SMALL_BATCH, BATCH):
        true = retrieval.exact_nn(q[:b], hb.bank)
        args, kw = _klist_request(q, x, hb, b)
        K = args[4].shape[1]
        plan = rh._klist_plan(args[0].shape[0], kw["bm"], K, kw["bn"], kw["Dk"], 8)
        for k in (1, 8):
            name = "hier_argmax" if k == 1 else "hier_topk"
            tag = (f"wide keys {name} k={k} B={b} Dk={kw['Dk']} K={K} bm={kw['bm']} "
                   f"(plan {tuple(plan)})")
            _compare_klist(f"{tag} vs plain", rh._sort_klist(*_klist_launch(args, kw, k)),
                           rh._sort_klist(*rh._hier_klist_plain(*args, k=k, **kw)),
                           args[0], args[1], hb, 1e-5, why)
            ms = _cuda_ms(lambda: _klist_launch(args, kw, k), 5)
            b_ms, b_by = _klist_bound(args, kw, b, k)
            print(f"{tag}: kernel {ms:.4f} ms (CUDA events, with its fold), bound {b_ms:.4f} "
                  f"ms ({b_by}), share {b_ms / ms:.4f}")
            call = functools.partial(rh.hier_topk, q[:b], x[:b], hb, k_tiles=TOPK_K, k=k)
            out, got = _drive(f"wide keys hier_topk k={k} B={b}", call,
                              {"hier_scan_stats": 1, "hier_scan_stats_deep": 1, name: 1})
            launches[name] += got[name]
            top = out if k == 1 else out[:, 0]
            print(f"wide keys hier_topk k={k} B={b}: recall@1 against exact_nn "
                  f"{(top == true).float().mean().item():.5f}")
            e2e[f"wide keys hier_topk k={k} B={b}"] = _host_ms(call, 3)
    for name, n in launches.items():
        report[name]["launches"] += n
    return e2e


def tiers_phases(dev, gen, report, bank, enc) -> dict:
    """Hierarchical banks at the `exact` and `high` tiers, served by the
    CUDA-core body (`csrc/hier_cores.cu`; at `high` kernels 14 and 15 by
    their Hopper bodies' deep chains): for each tier the flagship,
    tail_super and two-level HierBanks of the informative bank, built on
    the card; each
    CUDA-core form against its plain version (`_tier_kernels`); RANGE+ and
    RANGE with profile="flagship" at B = 10,000 (the flagship bars: relerr
    mean <= 0.04, p99 <= 0.165; RANGE mean <= 0.10), hier_topk's recall@1
    pooled over five batches (>= 0.999), RANGE+ at the JAX defaults (the
    merged kernel's plain form, mean <= 0.12), the tail_super flagship
    (the bars), the two-level feature path (mean <= 0.12) and top-k
    (recall@1 >= 0.99: the coarse stage trails by design), each request's
    launches counted; at `exact`, JAX's exactness
    check on its test bank's shape (f32 values, every tile selected: max
    relerr under 1e-4 of the exact dense answer).  Returns each path's
    end-to-end ms at B = 10,000."""
    from range_tpu_torch import GeoBank, load_model
    from range_tpu_torch.api import SERVING_PROFILES
    from range_tpu_torch.geometry import lonlat_deg_to_xyz
    from range_tpu_torch.ops import retrieval
    from range_tpu_torch.ops import retrieval_hier as rh

    prof = SERVING_PROFILES["flagship"]
    knobs = dict(lr_rank=prof["lr_rank"], lr_geo=prof["lr_geo"], res_rank=prof["res_rank"])
    coords = _random_coords(BATCH, gen, dev)
    with torch.no_grad():
        q = enc.model.query_embedding(coords).float()
    x = lonlat_deg_to_xyz(coords)
    e2e = {}
    for form, tier in CORES_FORMS:
        t0 = time.perf_counter()
        hb = rh.build_hier_bank(bank, bn=512, gsz_sem=prof["gsz_sem"], gsz_geo=64,
                                topk_gsz=prof["topk_gsz"], tier=tier, **knobs)
        hb_ts = rh.build_hier_bank(bank, bn=512, gsz_sem=prof["gsz_sem"], gsz_geo=64,
                                   topk_gsz=prof["topk_gsz"], tail_super=TAIL_SUPER,
                                   tier=tier, **knobs)
        hb2 = rh.build_hier_bank(bank, bn=512, gsz_sem=8, gsz_geo=64, gsz_super=GSZ_SUPER,
                                 tier=tier)
        torch.cuda.synchronize()
        print(f"{tier} tier: build_hier_bank (flagship knobs, tail_super, two-level; "
              f"{BANK_ROWS} rows): {time.perf_counter() - t0:.2f} s; sem_d {hb.sem_d}, "
              f"k_cat {hb.k_cat.dtype}, values {hb.values.dtype}")
        true = retrieval.exact_nn(q, hb.bank)
        with torch.no_grad():
            _tier_kernels(tier, form, hb, hb_ts, hb2, q, x, report, enc.model.config)

        c, deep = f"_{form}", form == "deep"  # the CUDA-core counters of a request
        exact_c = {"combine_cat_exact": 1} if tier == "exact" else {}  # the f32 body
        scan = {"hier_scan": 1, "hier_scan" + c: 1}
        stats = {"hier_scan_stats": 1, "hier_scan_stats" + c: 1}
        # kernels 14 and 15: the CUDA-core body at exact; at high their Hopper
        # bodies' deep chains, counted as at fast (the rr + lr shape, plain)
        fam2 = {"hier_parts_family": 2} if deep else {"hier_parts_family" + c: 2}

        def parts(plain: bool) -> dict:
            return ({"hier_parts": 1, **({"hier_parts_plain": 1} if plain else {})} if deep
                    else {"hier_parts": 1, "hier_parts" + c: 1})
        drives = {}
        plus = load_model("RANGE+", db_path=hb, profile="flagship", tier=tier)
        rng = load_model("RANGE", db_path=hb, profile="flagship", tier=tier)
        requests = {
            "flagship": (plus, {"siren_tower": 1, "siren_tower_bf16": 1, **scan, **fam2,
                                "combine_cat": 1, **exact_c}),
            "RANGE flagship": (rng, {"siren_tower": 1, **stats, **scan, **parts(False)})}
        for name, (enc_t, want) in requests.items():
            out, drives[name] = _drive(f"{tier} {name} B={BATCH}", lambda: enc_t(coords), want)
            if name == "flagship":
                _tier_fidelity(f"{tier} flagship B={BATCH}", out, coords, bank, "range+",
                               0.04, 0.165)
            else:
                _tier_fidelity(f"{tier} RANGE flagship B={BATCH}", out, coords, bank, "range",
                               0.10)
            e2e[f"{tier} {name}"] = _host_ms(lambda: enc_t(coords), 3)
        rows, drives["hier_topk"] = _drive(
            f"{tier} hier_topk B={BATCH}", lambda: rh.hier_topk(q, x, hb, k_tiles=TOPK_K),
            {**stats, "hier_argmax": 1})
        recall = [(rows == true).float().mean().item()]
        for seed in range(1, 5):
            cs = _random_coords(BATCH, torch.Generator(device=dev).manual_seed(seed), dev)
            with torch.no_grad():
                qs = enc.model.query_embedding(cs).float()
            recall.append((rh.hier_topk(qs, lonlat_deg_to_xyz(cs), hb, k_tiles=TOPK_K)
                           == retrieval.exact_nn(qs, hb.bank)).float().mean().item())
        pooled = statistics.mean(recall)
        print(f"{tier} hier_topk recall@1 K={TOPK_K}: batches "
              + " ".join(f"{r:.5f}" for r in recall) + f", pooled {pooled:.5f} (bar "
              f"{RECALL_BAR})")
        if pooled < RECALL_BAR:
            raise AssertionError(f"{tier} hier_topk recall@1 {pooled:.5f} < {RECALL_BAR}")
        e2e[f"{tier} hier_topk"] = _host_ms(lambda: rh.hier_topk(q, x, hb, k_tiles=TOPK_K), 3)
        del plus, rng

        # the JAX defaults, tail_super, the two-level paths
        cs = _random_coords(BATCH, gen, dev)
        dflt = load_model("RANGE+", db_path=bank, retrieval="hier", tier=tier)
        out, drives["defaults"] = _drive(
            f"{tier} RANGE+ at the JAX defaults B={BATCH}", lambda: dflt(cs),
            {"siren_tower": 1, **scan, **parts(True)})
        _tier_fidelity(f"{tier} RANGE+ at the JAX defaults", out, cs, bank, "range+", 0.12)
        e2e[f"{tier} RANGE+ at the JAX defaults"] = _host_ms(lambda: dflt(cs), 3)
        ts = load_model("RANGE+", db_path=hb_ts, profile="flagship", tail_super=TAIL_SUPER,
                        m_corr=M_CORR, tier=tier)
        out, drives["tail_super"] = _drive(
            f"{tier} tail_super flagship B={BATCH}", lambda: ts(cs),
            {"siren_tower": 1, **scan, **fam2, "hier_corr": 1, "hier_corr" + c: 1,
             "combine_cat": 1, **exact_c})
        _tier_fidelity(f"{tier} tail_super flagship", out, cs, bank, "range+", 0.04, 0.165)
        two = load_model("RANGE+", db_path=hb2, retrieval="hier", gsz_super=GSZ_SUPER,
                         tier=tier)
        out, drives["two_level"] = _drive(
            f"{tier} two-level feature path B={BATCH}", lambda: two(cs),
            {"siren_tower": 1, **scan, "hier_refine": 1, "hier_refine" + c: 1, **parts(True)})
        _tier_fidelity(f"{tier} two-level feature path", out, cs, bank, "range+", 0.12)
        with torch.no_grad():
            qs = two.model.query_embedding(cs).float()
        rows, drives["two_level_topk"] = _drive(
            f"{tier} two-level hier_topk B={BATCH}",
            lambda: rh.hier_topk(qs, lonlat_deg_to_xyz(cs), hb2, k_tiles=TOPK_K,
                                 m_tiles=TOPK_M),
            {**stats, "hier_refine": 1, "hier_refine" + c: 1, "hier_argmax": 1})
        rec2 = (rows == retrieval.exact_nn(qs, hb2.bank)).float().mean().item()
        print(f"{tier} two-level hier_topk recall@1 (M={TOPK_M}): {rec2:.5f}")
        if rec2 < 0.99:
            raise AssertionError(f"{tier} two-level hier_topk recall@1 {rec2:.5f} < 0.99")
        del dflt, ts, two
        for k in CORES_ROWS:
            # kernels 14 and 15 at high: their Hopper bodies' launches in these drives
            key = k[0] if deep and k[0] in ("hier_parts_family", "hier_parts") else k[0] + c
            report[f"{k[0]}{c}"]["launches"] = sum(d.get(key, 0) for d in drives.values())
        report["combine_cat_exact"]["launches"] += sum(d["combine_cat_exact"]
                                                       for d in drives.values())
        del hb, hb_ts, hb2
        torch.cuda.empty_cache()

    # JAX's exactness check (tests/test_hier.py:73-80) at its bank's shape
    eb = GeoBank.synthetic_informative(0, 6000, pad_to=512, device=dev)
    ehb = rh.build_hier_bank(eb, bn=128, gsz_sem=8, gsz_geo=16, tier="exact",
                             value_dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(3)
    rows = torch.randint(0, 6000, (8,), generator=g, device=dev).repeat_interleave(64)
    qe = torch.nn.functional.normalize(eb.keys_sem[rows].float() + 0.3 * torch.randn(
        512, eb.key_dim, generator=g, device=dev), dim=1)
    ll = eb.locs_lonlat[rows].float() + 3.0 * torch.randn(512, 2, generator=g, device=dev)
    ll = torch.stack([(ll[:, 0] + 180) % 360 - 180, ll[:, 1].clamp(-89.9, 89.9)], 1)
    xe = lonlat_deg_to_xyz(ll)
    ref = retrieval.retrieve(qe, xe, eb, chunk=512)
    out, _ = _drive("exact tier, f32 values, every tile selected (6,000 rows, B=512)",
                    lambda: rh.retrieve_hier(qe, xe, ehb, k_tiles=ehb.t_real, bm=128),
                    {"hier_scan": 1, "hier_scan_f32": 1, "hier_parts": 1,
                     "hier_parts_f32": 1})
    rel = ((out - ref).abs() / ref.abs().clamp_min(0.1)).max().item()
    print(f"exact tier with f32 values, all {ehb.t_real} tiles: max relerr {rel:.3e} against "
          "the exact dense answer (bar 1e-4; JAX's own check holds 5e-3)")
    if not rel < 1e-4:
        raise AssertionError(f"exact tier all-tiles max relerr {rel:.3e} >= 1e-4")
    return e2e


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import range_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    build = _start_build()  # ---- 2. (awaited below)

    # ---- 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)  # the card's name and power limit, as nvidia-smi gives them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    seconds = {}  # host seconds of each group of phases

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    timed("build", _build_all, *build)
    report = {}
    dense_ms = timed("dense", dense_phases, dev, gen, report)
    mesh_ms = timed("mesh", mesh_phases, dev, gen, report)
    hier_ms, hb, enc, bank = timed("hier", hier_phases, dev, gen, report)
    topk_ms = timed("topk", topk_phases, dev, gen, report, hb, enc)
    range_ms = timed("range", range_phases, dev, gen, report, hb, enc, bank)
    ts_ms, hb_ts = timed("tail_super", tail_super_phases, dev, gen, report, bank, enc)
    topk2_ms, hb2 = timed("two_level", two_level_topk_phases, dev, gen, report, bank, enc)
    general_ms = timed("general", general_phases, dev, gen, report, bank)
    gsz4_ms = timed("gsz4", gsz4_phases, dev, gen, report, bank)
    step_ms = timed("step_banks", step_banks_phases, dev, gen, report)
    odd_ms = timed("odd_banks", odd_banks_phases, dev, gen, report)
    knob_ms = timed("knobs", knob_phases, dev, gen, report, bank, hb, enc, hb_ts, hb2)
    del hb_ts, hb2
    pruned_ms = timed("pruned", pruned_phases, dev, gen, report, bank)
    del hb
    torch.cuda.empty_cache()
    wide_ms = timed("wide_keys", wide_keys_phases, dev, gen, report)
    tiers_ms = timed("tiers", tiers_phases, dev, gen, report, bank, enc)
    del enc, bank
    torch.cuda.empty_cache()
    step_s = timed("train", train_phases, dev, report)
    print("seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    print(f"end to end B={BATCH}: flagship {hier_ms:.3f} ms, dense {dense_ms:.3f} ms, "
          f"hier_topk {topk_ms:.3f} ms, RANGE flagship {range_ms:.3f} ms, tail_super "
          f"flagship {ts_ms:.3f} ms, two-level hier_topk {topk2_ms:.3f} ms, RANGE+ at the "
          f"JAX defaults {general_ms:.3f} ms, RANGE+ on a (1, 1) mesh {mesh_ms:.3f} ms, "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in {**knob_ms, **gsz4_ms, **step_ms,
                                                        **odd_ms}.items()) + ", "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in pruned_ms.items()) + ", "
          + ", ".join(f"{k} {ms:.3f} ms" for k, ms in {**tiers_ms, **wide_ms}.items())
          + f"; SatCLIP training step ({TRAIN_ACCUM} x {TRAIN_MICRO}) {step_s:.3f} s")

    kernels = [dict(name=k, route="cuda", source=f"range_tpu_torch/csrc/{src}.cu",
                    replaces=replaces, launches=report[k]["launches"],
                    max_abs_err=report[k]["max_abs_err"],
                    err_over_tol=report[k]["err_over_tol"], ms=report[k]["ms"],
                    plain_ms=report[k]["plain_ms"], bound_ms=report[k]["bound_ms"],
                    bound_by=report[k]["bound_by"], library_ms=None)
               for k, src, replaces in KERNELS]
    print(json.dumps({"kernels": kernels}))
    # the run drives one card
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
