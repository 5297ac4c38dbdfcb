"""The parts kernels (TPU kernels 14 and 15) at the flagships' shapes, for
comparing two checkouts on one card.

Times, on CUDA events (the median of 7 runs of 3 calls), over random
operands made from one seed (10,112 queries in 128-query selection blocks,
32 tiles of 512 rows and 32 groups a list over a 196-tile bank):
  * the values kernel (`range_tpu_torch/csrc/hier_parts_sm90.cu`: kernel
    15 and kernel 14's value shapes) at the `fast` tier, 1,024 value
    columns and 256 lr columns: the merged lr launch with and without the
    geo family, the merged plain one with it, the sem family's plain value
    shape; each in bf16 and int8;
  * the rr kernel (`range_tpu_torch/csrc/hier_parts_family_sm90.cu`:
    kernel 14's residual-rank shapes), the RANGE+ flagship's sem family
    (rr + lr: 128 z and 256 lr columns) over 256 sem columns (`fast`) and
    768 (`high`, in passes).
The operands are made here, so two checkouts time the same inputs.  Run
it from each checkout's root in turns (A, B, B, A) in one sitting on the
card:

    PYTHONPATH=. python3 tools/torch_parts_ab.py A

Needs a CUDA card and nvcc; prints one line: the label, then each form's
milliseconds a call.
"""

import statistics
import sys

import numpy as np
import torch

BP, BM, BN, K, T, GPT_S, GPT_G, DV, W, SEM = 10112, 128, 512, 32, 196, 32, 8, 1024, 256, 256


def _operands(cuda, i8: bool) -> dict:
    """The flagship-shaped operands from seed 1: 256 sem + 128 geo packed
    columns (9 real geo ones), values [N, 1,024] (int8 codes and a row
    scale with ``i8``), the last 7 bank rows masked, each query block's
    list of 32 distinct tiles, the sem [G, 256] and geo [G, 128] centroids,
    lr coefficients and the full-width group sums (count in column 1,024)."""
    rng = np.random.default_rng(1)

    def bf(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
            cuda).bfloat16()

    N, Gs, Gg = T * BN, T * GPT_S, T * GPT_G
    q, k = bf((BP, SEM + 128), 0.35), bf((N, SEM + 128), 0.35)
    q[:, SEM + 9:] = 0
    k[:, SEM + 9:] = 0
    mask = torch.zeros(1, N, device=cuda)
    mask[0, -7:] = -1e30
    if i8:
        values = torch.from_numpy(rng.integers(-127, 128, (N, DV)).astype(np.int8)).to(cuda)
        scale = torch.from_numpy(rng.uniform(0.002, 0.01, (1, N)).astype(np.float32)).to(cuda)
    else:
        values, scale = bf((N, DV), 1.0), None
    idx = torch.from_numpy(np.stack([rng.permutation(T)[:K] for _ in range(BP // BM)]).astype(
        np.int32)).to(cuda)

    def sums(G, gpt):
        vw = bf((G, DV + 128), 1.0)
        vw[:, DV] = float(BN // gpt)
        vw[:, DV + 1:] = 0
        return vw

    g_sem, g_geo = bf((Gs, SEM), 0.35), bf((Gg, 128), 0.35)
    g_geo[:, 9:] = 0
    return dict(q=q, k=k, values=values, scale=scale, mask=mask, idx=idx, g_sem=g_sem,
                g_geo=g_geo, vw_lr=bf((Gs, W), 1.0), vw_sem=sums(Gs, GPT_S),
                vw_geo=sums(Gg, GPT_G))


def _rr_operands(cuda, sem: int):
    """The rr + lr launch's operands from seed 2: ``sem`` sem + 128 geo
    packed columns (the sem ones scaled so a logit's spread is the 256
    columns'), z [N, 128], vw [G, 384] (256 coefficients, the group's row
    count in column 256), the last 7 bank rows masked."""
    rng = np.random.default_rng(2)

    def bf(shape, scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).to(
            cuda).bfloat16()

    N, G, sc = T * BN, T * GPT_S, 0.35 * (256 / sem) ** 0.5
    q, k = bf((BP, sem + 128), sc), bf((N, sem + 128), sc)
    q[:, sem + 9:] = 0
    k[:, sem + 9:] = 0
    mask = torch.zeros(1, N, device=cuda)
    mask[0, -7:] = -1e30
    idx = torch.from_numpy(np.stack([rng.permutation(T)[:K] for _ in range(BP // BM)]).astype(
        np.int32)).to(cuda)
    vw = bf((G, 384), 1.0)
    vw[:, 256] = float(BN // GPT_S)
    vw[:, 257:] = 0
    return (q, k, mask, idx, bf((G, sem), sc), vw, bf((N, 128), 1.0)), dict(
        sem_d=sem, bm=BM, bn=BN, gpt=GPT_S, geo=False, lrr=256, lr=True)


def _launch(form: str, o: dict):
    """The wrapper and its arguments of one form."""
    from range_tpu_torch.ops import retrieval_hier as rh

    if form == "family_plain_sem":
        return rh._hier_parts_family_call, (
            o["q"], o["k"], o["mask"], o["idx"], o["g_sem"], o["vw_sem"], None), dict(
            sem_d=SEM, bm=BM, bn=BN, gpt=GPT_S, geo=False, lrr=0, lr=False,
            values=o["values"], scale=o["scale"], sel=False, dedup_pad=False)
    lr = "lr" in form
    return rh._hier_parts_call, (
        o["q"], o["k"], o["values"], o["scale"], o["mask"], o["idx"], o["g_sem"], o["g_geo"],
        o["vw_lr"] if lr else o["vw_sem"], o["vw_geo"]), dict(
        sem_d=SEM, bm=BM, bn=BN, gpt_s=GPT_S, gpt_g=GPT_G, lr=lr, geo=form.endswith("geo"))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_parts_ab: no CUDA device available", file=sys.stderr)
        return 1
    from range_tpu_torch.ops import retrieval_hier as rh

    cuda = torch.device("cuda")
    forms = [(f"{form}{'_i8' if i8 else ''}", form, i8)
             for form in ("merged_lr", "merged_lr_geo", "merged_plain_geo", "family_plain_sem")
             for i8 in (False, True)] + [(f"rr_lr_{sem}", "rr", sem) for sem in (256, 768)]
    out = []
    for tag, form, arg in forms:
        if form == "rr":
            call = rh._hier_parts_family_call
            args, kw = _rr_operands(cuda, arg)
        else:
            call, args, kw = _launch(form, _operands(cuda, arg))
        call(*args, **kw)
        torch.cuda.synchronize()
        times = []
        for _ in range(7):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                call(*args, **kw)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 3)
        out.append(f"{tag} {statistics.median(times):.4f}")
    print(sys.argv[1] if len(sys.argv) > 1 else "", " | ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
