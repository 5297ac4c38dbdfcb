"""Logits deeper than 256 columns on the port's Hopper bodies, the Python
around them on the CPU: the top-k kernel's (`csrc/hier_argmax_sm90.cu`,
TPU kernels 10 and 11) keys of 264 to 512 columns, the parts kernels'
(`csrc/hier_parts_family_sm90.cu`, `csrc/hier_parts_sm90.cu`, TPU kernels
14 and 15) 768 semantic columns of the `high` tier and wide-key banks',
up to 2,048.  Each takes a deep chain in passes of at most 256 columns
(the top-k kernel's of 128 past 256) with one accumulator carried from
pass to pass; the parts kernels' query boxes past those that fit beside
the ring stream with passes of 128 columns.

Held here: the plans (`_klist_plan`, `_parts_plan`, `_values_plan`) give
a layout within a block's shared memory at Dk = 264, 384, 512 and at 768
columns, the parts kernels' at every depth the CUDA-core body held (up to
1,280 columns) and at 2,048, and at up to 256 columns the plans and layouts of the one-pass
kernels (their rules written out below as they stood); a plain
pass-by-pass version of each chain (the top-k kernel's qh kh + qh kl +
ql kh over passes of 128 columns; the parts kernels' row and group
logits over passes of 256) against the one-pass plain version; and the
port's `hier_topk`
on the CPU over a bank of 512-d keys against JAX's `hier_topk` (Pallas in
interpret mode), row for row.

Tolerances: a chain summed pass by pass differs from one product in f32
order only: within 2^-20 of the sum of its terms' magnitudes.  The top-k
rows agree wherever the rival rows' logits are more than 2e-6 apart
(`tests/test_torch_topk.py`'s bar).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval_hier as jh
from range_tpu.ops.retrieval_pallas import _split_hilo as jax_split_hilo
from range_tpu_torch.ops import retrieval_hier as th

SMEM = 232_448  # a block's shared memory on the card
SMS = 132
GAP = 2e-6
ORDER = 2.0 ** -20  # f32 summation order, relative to the terms' magnitudes


# ---------------------------------------------------------------- the plans
# The one-pass rules as they stood before the passes: every column's boxes
# in each ring stage.


def _klist_smem_one_pass(bmb, Dk, S):
    box, kb = 64 * 128, -(-Dk // 64)
    return bmb // 64 * (kb * box + 4 * 2048) + S * (2 * kb * box + 256) + 8 * (1 + 2 * S) + 1024


def _klist_plan_one_pass(Bp, bm, K, bn, Dk):
    bmb = 128 if bm % 128 == 0 else 64
    S = next(S for S in (4, 3, 2) if _klist_smem_one_pass(bmb, Dk, S) <= SMEM)
    n_qb, spt = Bp // bmb, -(-bn // 64)

    def cost(n):
        return -(-n_qb * n // SMS) * (-(-K // n) * spt + 8)

    return bmb, min(range(1, K + 1), key=lambda n: (cost(n), n)), S


@pytest.mark.parametrize("Dk", [8, 48, 64, 200, 256])
@pytest.mark.parametrize("bm", [64, 128, 256])
@pytest.mark.parametrize("Bp,K", [(256, 1), (1024, 144), (10_240, 48)])
def test_klist_plan_up_to_256_is_the_one_pass_plan(Dk, bm, Bp, K):
    plan = th._klist_plan(Bp, bm, K, 512, Dk, 8)
    assert tuple(plan) == _klist_plan_one_pass(Bp, bm, K, 512, Dk)
    assert th._klist_smem(plan.bmb, Dk, plan.S) == _klist_smem_one_pass(plan.bmb, Dk, plan.S)


@pytest.mark.parametrize("Dk", [264, 384, 512])
@pytest.mark.parametrize("bm", [64, 128, 256])
@pytest.mark.parametrize("Bp,K,bn", [(256, 1, 512), (1024, 144, 96), (10_240, 48, 512)])
def test_klist_plan_wide_keys_fits(Dk, bm, Bp, K, bn):
    """Passes of 128 columns (3 at 264 and 384, 4 at 512): a stage holds
    one pass's kh and kl boxes (32 KB), the ql boxes stay resident; 128
    queries a block wherever bm allows it; every plan within a block's
    shared memory."""
    plan = th._klist_plan(Bp, bm, K, bn, Dk, 1)
    assert th._klist_passes(Dk) == -(-Dk // 128)
    assert plan.bmb in (64, 128) and bm % plan.bmb == 0 and 2 <= plan.S <= 4
    assert 1 <= plan.n_seg <= K
    assert th._klist_smem(plan.bmb, Dk, plan.S) <= SMEM
    # each stage one pass's two boxes of kh and of kl, not all of them
    assert (th._klist_smem(plan.bmb, Dk, 3) - th._klist_smem(plan.bmb, Dk, 2)
            == 2 * 2 * 8192 + 256 + 16)
    assert plan.bmb == (128 if bm % 128 == 0 else 64)


def test_klist_plan_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="no block holds"):
        th._klist_plan(1024, 128, 8, 512, 1024 + 64 * 8, 1)


def _parts_layout_one_pass(K, bn, gpt, kf, gwe, share, rrp, acols, seg_cap, S, direct=False,
                           dglob=False):
    box = 8192
    kb, kbg = -(-kf // 64), -(-gwe // 64)
    gsz = bn // gpt
    eg, ng = th._parts_groups(gpt, gsz)
    units = gsz % 64 and 64 % gsz and not direct
    kz = kb * box
    msk = kz + rrp // 64 * box
    stage = msk + 1024
    qg = kb * box
    ring = qg + (0 if share else kbg * box)
    p = ring + S * stage
    g = p + 2 * box
    e = g + kbg * eg * 128
    cnt = e + th._round_up(64 * (eg + 1) * 4, 16)
    us = th._round_up(cnt + eg * 4, 16)
    sm = th._round_up(us + (64 * (ng + 1) * 4 if units else 0), 1024)
    d = sm + (0 if direct else ng * 128)
    lst = d + (0 if dglob else seg_cap * th._round_up(gpt, 16) * 128)
    bars = lst + th._round_up(K * 4, 16)
    abox = -(-acols // 64)
    pb = -(-abox // -(-abox // 8))
    S2 = min(4, S * stage // ((pb + (1 if dglob else 0)) * 2048))
    total = bars + 8 * (6 + 2 * S + S2) + 16 + 1024
    return (eg, ng, pb, S2, stage, kz, msk, 0, qg, ring, p, g, e, cnt, us, sm, d, lst, bars,
            total, int(direct), int(dglob))


# (K, bn, gpt, kf, gwe, share, rrp, acols): the flagship's sem and geo
# families, the rr-only shape, sel, a 96-row tile, 128 groups
RR_SHAPES = [(32, 512, 32, 256, 256, True, 128, 384), (16, 512, 8, 16, 16, False, 128, 384),
             (32, 512, 64, 256, 256, True, 256, 1025), (32, 512, 32, 256, 64, False, 128, 384),
             (24, 96, 8, 128, 128, True, 128, 384), (12, 512, 128, 192, 192, True, 128, 384)]


@pytest.mark.parametrize("shape", RR_SHAPES)
def test_parts_layout_up_to_256_is_the_one_pass_layout(shape):
    K, bn, gpt, kf, gwe, share, rrp, acols = shape
    out_w = rrp + 128 + acols
    plan = th._parts_plan(1024, K, bn, gpt, kf, gwe, share, rrp, acols, out_w)
    assert plan.res is None
    for seg_cap, S in ((plan.seg_cap, plan.S), (1, 2), (K, 4)):
        lay = th._parts_layout(K, bn, gpt, kf, gwe, share, rrp, acols, seg_cap, S,
                               plan.direct, plan.dglob)
        assert tuple(lay)[:22] == _parts_layout_one_pass(
            K, bn, gpt, kf, gwe, share, rrp, acols, seg_cap, S, plan.direct, plan.dglob)
        # every query box resident, no streamed group query buffer
        assert lay.res == max(-(-kf // 64), -(-gwe // 64)) and lay.gqs == lay.e


# the `high` tier's sem family (rr + lr, rr alone, sel), and a wide-key
# bank's 384, 1,024 and 1,152 columns at `fast` (the `high` tier of 384-d
# keys), the flagship's grouping at 1,024 and 1,280 (the CUDA-core body's
# widest), groups of one row at 768
DEEP_RR = [(32, 512, 32, 768, 768, True, 128, 384), (32, 512, 64, 768, 768, True, 128, 1025),
           (32, 512, 32, 768, 64, False, 128, 384), (24, 512, 32, 384, 384, True, 256, 384),
           (16, 512, 16, 1024, 1024, True, 128, 384), (16, 96, 8, 768, 768, True, 128, 384),
           (32, 512, 32, 1024, 1024, True, 128, 384), (32, 512, 32, 1152, 1152, True, 128, 384),
           (32, 512, 32, 1280, 1280, True, 128, 1025), (8, 512, 512, 768, 768, True, 128, 384),
           (32, 512, 32, 1280, 768, False, 128, 384), (32, 512, 32, 2048, 2048, True, 128, 384)]


@pytest.mark.parametrize("Bp", [128, 1024, 10_112])
@pytest.mark.parametrize("shape", DEEP_RR)
def test_parts_plan_deep_fits(shape, Bp):
    """The rr kernel's deep layout: the query block over every column where
    a cut allows it (else its first `res` boxes, a multiple of 4), a stage
    of one pass's four key boxes (or two and their two query boxes, or the
    payload's z boxes) and the mask, a centroid buffer of one pass's boxes
    (and a streamed group pass's two query boxes past it); the plan's
    layout within a block's shared memory, its segments within the list."""
    K, bn, gpt, kf, gwe, share, rrp, acols = shape
    plan = th._parts_plan(Bp, K, bn, gpt, kf, gwe, share, rrp, acols, rrp + 128 + acols)
    lay = th._parts_layout(K, bn, gpt, kf, gwe, share, rrp, acols, plan.seg_cap, plan.S,
                           plan.direct, plan.dglob, plan.res)
    kb, kbg = -(-kf // 64), -(-gwe // 64)
    assert lay.total <= SMEM and lay.S2 >= 2 and 1 <= plan.n_seg <= K
    assert plan.seg_cap >= -(-K // plan.n_seg)
    assert lay.kz == 0 and lay.msk == max(4, rrp // 64) * 8192 and lay.stage == lay.msk + 1024
    res = max(kb, kbg) if plan.res is None else plan.res
    assert lay.res == res and (res == max(kb, kbg) or (res % 4 == 0 and 4 <= res < max(kb, kbg)))
    qres, gres = min(kb, res), min(kbg, res)
    assert lay.q == 0 and lay.qg == qres * 8192
    assert lay.ring == lay.qg + (0 if share else gres * 8192)
    assert lay.gqs - lay.g == min(4, kbg) * lay.EG * 128
    assert lay.e - lay.gqs == (2 * 8192 if gres < kbg else 0)
    # a streamed row pass's 2 key and 2 query boxes fit the stage before the mask
    assert lay.msk >= 4 * 8192


def test_parts_plan_keeps_every_query_box_where_a_cut_allows_it():
    """Streaming is the last resort: at the `high` tier's 768 columns the
    flagship's grouping keeps its one-pass-per-box plan (7 segments of 5
    tiles), and 1,024 columns at that grouping stream past 8 boxes."""
    flag = (32, 512, 32, 768, 768, True, 128, 384, 640)
    assert th._parts_plan(10_112, *flag) == th.PartsPlan(7, 5, 2, False, False, None)
    wide = th._parts_plan(10_112, 32, 512, 32, 1024, 1024, True, 128, 384, 640)
    assert wide.res == 8


def _values_layout_one_pass(K, bmb, kb, kbs, kbg, has_kg, egmax, S):
    box = 8192
    qgeo = kb * box
    qsel = qgeo + (2048 if has_kg else 0)
    qhalf = th._round_up(qsel + kbs * box, 1024)
    ring = bmb // 64 * qhalf
    kg = max(kb, kbg) * box
    aux = kg + (2048 if has_kg else 0)
    va = aux + 1024
    stage = va + 4 * box
    e = ring + S * stage
    etile = egmax // 16 * 2048
    lst = e + 2 * etile
    bars = lst + th._round_up(4 * K, 16)
    total = bars + 8 * (1 + 2 * S) + 16 + 1024
    return (bmb, S, qhalf, qgeo, qsel, ring, stage, kg, aux, va, e, etile, lst, bars, total)


# (kb, kbs, kbg, has_kg, two, egmax): RANGE's merged launch, a family
# launch, sel, the geo family alone
VALUE_SHAPES = [(4, 0, 4, True, True, 64), (4, 0, 4, False, False, 32), (4, 1, 1, False, False, 32),
                (0, 0, 0, True, False, 16), (2, 0, 2, True, True, 16)]


@pytest.mark.parametrize("shape", VALUE_SHAPES)
def test_values_layout_up_to_256_is_the_one_pass_layout(shape):
    kb, kbs, kbg, has_kg, two, egmax = shape
    for bmb in (64, 128):
        for S in (2, 3, 4):
            lay = th._values_layout(32, bmb, kb, kbs, kbg, has_kg, egmax, S)
            assert tuple(lay)[:15] == _values_layout_one_pass(32, bmb, kb, kbs, kbg, has_kg,
                                                              egmax, S)
            assert lay.qres == kb  # every sem box resident


@pytest.mark.parametrize("i8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("Bp", [128, 1024, 10_112])
@pytest.mark.parametrize("shape", [(12, 0, 12, True, True, 64), (12, 0, 12, False, False, 32),
                                   (12, 1, 1, False, False, 32), (6, 0, 6, True, True, 16),
                                   (16, 0, 16, False, False, 64), (18, 0, 18, True, True, 64),
                                   (20, 1, 1, False, False, 32), (32, 0, 32, False, False, 64)])
def test_values_plan_deep_fits(shape, Bp, i8):
    """The values kernel's deep layout: each query half over every sem
    column where it fits (else its first `qres` boxes, a multiple of 4:
    1,024 columns with int8 codes, and past 1,024), a stage of one pass's
    four boxes (or two and their two query boxes, or the payload's value
    boxes, va = 0; int8 codes in the 16 KB past them), the geo box and
    aux; 64 queries a block; within a block's shared memory."""
    kb, kbs, kbg, has_kg, two, egmax = shape
    plan = th._values_plan(Bp, 32, 512, 128, 1024, 384, two, kb, kbs, kbg, has_kg, egmax, i8)
    lay = th._values_layout(32, plan.bmb, kb, kbs, kbg, has_kg, egmax, plan.S, i8, plan.qres)
    assert lay.total <= SMEM and plan.bmb == 64 and 2 <= plan.S <= 4
    assert lay.qres == plan.qres and lay.qgeo == plan.qres * 8192
    assert plan.qres == kb or (plan.qres % 4 == 0 and 4 <= plan.qres < kb)
    # every box resident wherever that fits with two stages (bf16 up to
    # 1,024 or 1,152 columns), else streaming
    whole = th._values_layout(32, 64, kb, kbs, kbg, has_kg, egmax, 2, i8).total <= SMEM
    assert (plan.qres == kb) == whole
    assert whole == (kb <= 12 or (kb <= 16 and not i8) or (kb == 18 and not i8 and not two))
    # a one-family launch's block pairs two slices: 2 value + 1 alr blocks
    # a query block (4 + 2 slices of 256 columns), two families' 4 + 2
    blocks = Bp // 64 * (6 if two else 3)
    assert plan.n_seg == max(-(-32 // (th.PARTS_ROWS_MAX // 512)), min(32, -(-SMS // blocks)))
    assert lay.va == 0 and lay.kg == (6 if i8 else 4) * 8192 and lay.stage == lay.aux + 1024
    assert lay.qhalf >= plan.qres * 8192 + (2048 if has_kg else 0) + kbs * 8192


@pytest.mark.parametrize("i8", [False, True], ids=["bf16", "int8"])
def test_deep_plans_hold_what_the_cuda_core_body_held(i8):
    """Every logit depth the CUDA-core body took for kernels 14 and 15
    (`_cores_smem` within a block: bf16 logits up to 1,280 columns) plans
    on the Hopper bodies: the values kernel in each family layout (bf16
    values and int8 codes), the rr kernel at the flagship's grouping and
    at RANGE+'s 16 groups of 256-row tiles."""
    depths = [d for d in range(272, 2049, 16)
              if th._cores_smem(d, True, True, True, 32) <= SMEM]
    assert depths[-1] == 1280
    for d in depths + [1536, 2048]:
        kb = -(-d // 64)
        for two, has_kg, kbs, kbg, egmax in ((True, True, 0, kb, 64), (False, False, 0, kb, 32),
                                             (False, False, 1, 1, 32), (False, True, 0, kb, 64)):
            plan = th._values_plan(1024, 32, 512, 128, 1024, 0 if two else 384, two, kb, kbs,
                                   kbg, has_kg, egmax, i8)
            assert th._values_layout(32, plan.bmb, kb, kbs, kbg, has_kg, egmax, plan.S, i8,
                                     plan.qres).total <= SMEM
        if not i8:  # (z is bf16 at every tier)
            for K, bn, gpt, rrp, acols in ((32, 512, 32, 128, 384), (48, 256, 16, 256, 1025)):
                plan = th._parts_plan(1024, K, bn, gpt, d, d, True, rrp, acols,
                                      rrp + 128 + acols)
                assert th._parts_fits(th._parts_layout(K, bn, gpt, d, d, True, rrp, acols,
                                                       plan.seg_cap, plan.S, plan.direct,
                                                       plan.dglob, plan.res))


# ------------------------------------------------- the chains, pass by pass


def _bf16_rand(rng, shape, scale):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)).bfloat16()


def _passes(a, b, width=256):
    """a @ b.T in f32 as the deep chains sum it: over columns [0, 256),
    then each further 256 (the last pass what is left), into one
    accumulator."""
    acc = torch.zeros(a.shape[0], b.shape[0])
    for c0 in range(0, a.shape[1], width):
        acc = acc + a[:, c0:c0 + width].float() @ b[:, c0:c0 + width].float().T
    return acc


@pytest.mark.parametrize("Dk", [264, 384, 512])
def test_klist_chain_pass_by_pass(Dk):
    """The top-k kernel's chain over passes of 128 columns, qh kh + qh kl +
    ql kh of each pass in turn, against the one-pass plain version's
    logits (`_hier_klist_plain`: q2 . khl + ql . kh): within f32 order."""
    rng = np.random.default_rng(Dk)
    q = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((64, Dk))), dim=1)
    k = torch.nn.functional.normalize(torch.from_numpy(rng.standard_normal((96, Dk))), dim=1)
    qh, ql = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
              for a in jax_split_hilo(jnp.asarray(q.numpy(), jnp.float32)))
    kh, kl = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
              for a in jax_split_hilo(jnp.asarray(k.numpy(), jnp.float32)))
    q2, khl = torch.cat([qh, qh], 1), torch.cat([kh, kl], 1)
    one = q2.float() @ khl.float().T + ql.float() @ kh.float().T
    chain = torch.zeros(64, 96)
    for c0 in range(0, Dk, 128):
        sl = slice(c0, min(c0 + 128, Dk))
        chain = (chain + qh[:, sl].float() @ kh[:, sl].float().T
                 + qh[:, sl].float() @ kl[:, sl].float().T + ql[:, sl].float() @ kh[:, sl].float().T)
    mag = (q2.float().abs() @ khl.float().abs().T + ql.float().abs() @ kh.float().abs().T)
    assert ((chain - one).abs() <= ORDER * mag).all()
    # the argmax the kernel takes from the chain is the plain version's
    # wherever the rival is more than 2e-6 apart
    a, b = chain.argmax(1), one.argmax(1)
    assert ((a == b) | ((one.gather(1, a[:, None]) - one.amax(1, keepdim=True)).abs()[:, 0]
                         <= GAP)).all()


def _deep_spans(kb, res):
    """The passes of a deep chain over kb boxes with res resident
    (`deep_pass` in csrc/sm90_common.cuh): 4 boxes a pass over the resident
    ones, then 2 (their query boxes streamed), as column slices."""
    spans = [(b0, min(b0 + 4, res)) for b0 in range(0, res, 4)]
    spans += [(b0, min(b0 + 2, kb)) for b0 in range(res, kb, 2)]
    return [slice(64 * a, 64 * b) for a, b in spans]


@pytest.mark.parametrize("kf,res", [(384, None), (768, None), (1024, None), (1024, 12),
                                    (1152, 8), (1280, 16), (1296, 4)])
def test_parts_chains_pass_by_pass(kf, res):
    """The parts kernels' row logits (q . k over the family's kf columns)
    and group logits (q . g) in passes of 256 columns (with ``res``
    resident boxes: passes of 128 past them) against one product: within
    f32 order; p = exp2(min(l + mask, 86)) then within a few f32 ulps
    times l."""
    rng = np.random.default_rng(kf)
    sc = 0.35 * math.sqrt(256 / kf)
    q, k, g = (_bf16_rand(rng, (64, kf), sc), _bf16_rand(rng, (512, kf), sc),
               _bf16_rand(rng, (32, kf), sc))
    kb = -(-kf // 64)
    spans = _deep_spans(kb, kb if res is None else res)
    assert spans[0].start == 0 and spans[-1].stop >= kf
    assert all(a.stop == b.start for a, b in zip(spans, spans[1:]))
    for b in (k, g):
        one = q.float() @ b.float().T
        chain = torch.zeros(64, b.shape[0])
        for sl in spans:
            chain = chain + q[:, sl].float() @ b[:, sl].float().T
        if res is None:
            assert torch.equal(chain, _passes(q, b))
        mag = q.float().abs() @ b.float().abs().T
        assert ((chain - one).abs() <= ORDER * mag).all()
        p_one, p_chain = (torch.exp2(torch.clamp_max(x, th.CLAMP2)) for x in (one, chain))
        assert ((p_chain - p_one).abs() <= p_one * ORDER * mag * math.log(2) * 2 + 1e-30).all()


# ------------------------------------------------ hier_topk over 512-d keys


@pytest.fixture(scope="module")
def wide_banks(tmp_path_factory):
    """JAX's HierBank of a 2,048-row informative bank with 512-d keys (bn
    128, topk_gsz 8), and the port's from its archive."""
    jb = JaxGeoBank.synthetic_informative(7, 2048, key_dim=512, value_dim=64, pad_to=512,
                                          value_dtype=jnp.bfloat16)
    jhb = jh.build_hier_bank(jb, bn=128, gsz_sem=16, gsz_geo=16, topk_gsz=8)
    path = str(tmp_path_factory.mktemp("wide") / "jax_hb.npz")
    jh.save_hier_bank(jhb, path)
    return jb, jhb, th.load_hier_bank(path, device="cpu")


@pytest.mark.parametrize("k", [1, 8])
def test_hier_topk_512d_keys_equals_jax(wide_banks, k):
    """The endpoint over 512-d keys on the CPU (the port's plain versions
    of the stats scan and the argmax / k-carry) against JAX's hier_topk
    in interpret mode: the same rows wherever the rival rows' logits are
    more than 2e-6 apart (none differ on this batch at k = 1)."""
    jb, jhb, thb = wide_banks
    rng = np.random.default_rng(21)
    keys = np.asarray(jb.keys_sem, np.float32)
    locs = np.asarray(jb.locs_lonlat, np.float32)
    rows = np.repeat(rng.integers(0, int(jb.n_valid), 8), 16)
    q = keys[rows] + 0.3 * rng.standard_normal((128, 512))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    ll = locs[rows] + rng.normal(0, 3.0, (128, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    x = np.array(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)
    kw = dict(k_tiles=4, bm=128)
    j = np.asarray(jh.hier_topk(jnp.asarray(q), jnp.asarray(x), jhb, k=k, interpret=True, **kw))
    t = th.hier_topk(torch.from_numpy(q), torch.from_numpy(x), thb, k=k, **kw)
    assert t.dtype == torch.int32 and tuple(t.shape) == j.shape
    t, j = t.numpy().reshape(128, -1), j.reshape(128, -1)
    if (t != j).any():  # only near-ties may differ
        qh, ql = (np.asarray(a, np.float64) for a in jax_split_hilo(jnp.asarray(q)))
        khl = np.asarray(jhb.khl_sem, np.float32).astype(np.float64)
        mask = np.asarray(jhb.mask_neg, np.float32)[0].astype(np.float64)

        def logit(r):
            kr = khl[r]
            return (np.einsum("bd,bkd->bk", np.concatenate([qh, qh], 1), kr)
                    + np.einsum("bd,bkd->bk", ql, kr[:, :, :512]) + mask[r])

        off = t != j
        assert (np.abs(logit(t) - logit(j))[off] <= GAP).all()
    assert thb.khl_sem.shape[1] == 2 * 512
