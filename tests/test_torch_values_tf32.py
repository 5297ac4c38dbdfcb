"""Kernel 15 and kernel 14's value shapes at the `exact` tier, on the CPU:
`csrc/hier_values_tf32_sm90.cu` (the logits as three TF32 products, p once
into device memory, the value products: bf16 on wgmma, f32 as three TF32
products) with the group products on `csrc/hier_rr_tf32_sm90.cu`'s groups
pass (no group sums: e, or -e added into acc and d).

A CUDA kernel cannot run here, so the arithmetic is held through a plain
version of it that reads the very images the kernels copy
(`ops.retrieval_hier._values_tf32_plain`): the same TF32 halves, the same
chunk order, each 32-deep chunk's products in a fresh fragment truncated
toward zero (`ops._prep.tf32x3_matmul`), a bf16 step's 64 exact products in
one.  Against range_tpu's `_hier_parts_call` and `_hier_parts_family_call`
(value shapes) in interpret mode at f32 keys and queries, on a small
numpy-seeded `exact` bank with bf16, f32 and int8 values.  Also: the
images read back to their operands, a cancelling product that one
truncated chain misses and the chunks hold, and the shape check refuses
what the launches refuse.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval_hier as jh
from range_tpu_torch.convert.from_jax import _tensor
from range_tpu_torch.ops import _prep
from range_tpu_torch.ops import retrieval_fused as rf
from range_tpu_torch.ops import retrieval_hier as th

SMEM_MAX = 232_448  # a block's shared memory on sm_90
N, B, DV = 2048, 128, 320  # 320 value columns: three slices of 128, the last partial


@pytest.fixture(scope="module")
def bank(tmp_path_factory):
    """An informative bank of 2,048 rows (256-d keys, 320-d values), its JAX
    HierBank at the `exact` tier (bn 128, gsz_sem 8, gsz_geo 16, lr_rank
    and lr_geo 128, a 64-column sel_lr sketch), the port's load of it, regional queries
    and each family's selection; the values as bf16, f32 and int8 codes
    (each row's max / 127 its scale), the same tensors on both sides."""
    jb = JaxGeoBank.synthetic_informative(7, N, key_dim=256, value_dim=DV, pad_to=512,
                                          value_dtype=jnp.bfloat16)
    jhb = jh.build_hier_bank(jb, bn=128, gsz_sem=8, gsz_geo=16, tier="exact", lr_rank=128,
                             lr_geo=128, sel_lr=64)
    path = str(tmp_path_factory.mktemp("values_tf32") / "exact.npz")
    jh.save_hier_bank(jhb, path)
    thb = th.load_hier_bank(path, device="cpu")
    rng = np.random.default_rng(4)
    rows = np.repeat(rng.integers(0, N, 4), B // 4)
    ll = np.asarray(jb.locs_lonlat, np.float32)[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = np.asarray(jb.keys_sem, np.float32)[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)
    q_cat = rf.pack_queries(_tensor(q), _tensor(x), 12.0, 40.0, "exact")
    m_s, s_s, m_g, s_g = th._hier_scan_stats_plain(q_cat, thb.g_sem_cat, thb.g_geo_cat,
                                                   gpt_s=16, gpt_g=8)
    sel = dict(t_real=thb.t_real, bm=128, n_valid=B, mode="range")
    idx_s, _ = th.select_tiles(m_s, s_s, m_g, s_g, k_tiles=4, **sel)
    idx_g, _ = th.select_tiles(m_g, s_g, m_s, s_s, k_tiles=2, **sel)
    v = thb.values.float()
    sc = v.abs().amax(1).clamp_min(1e-8) / 127
    codes = (v / sc[:, None]).round().clamp(-127, 127).to(torch.int8)
    values = {"bf16": (thb.values, None), "f32": (v, None),
              "int8": (codes, sc[None, :].contiguous())}
    return dict(jhb=jhb, thb=thb, q_cat=q_cat, idx={False: idx_s, True: idx_g}, values=values,
                jb=jb, qx=(q, x))


@pytest.fixture(scope="module")
def high_f32(bank, tmp_path_factory):
    """The same bank at the `high` tier built with f32 values
    (`build_hier_bank(value_dtype=)`, as JAX builds it): 768 bf16 logit
    columns a row and a sem group, bf16 group sums; the port's load, the
    queries packed for it and the sem family's selection."""
    jhb = jh.build_hier_bank(bank["jb"], bn=128, gsz_sem=8, gsz_geo=16, tier="high",
                             lr_rank=128, lr_geo=128, value_dtype=jnp.float32)
    path = str(tmp_path_factory.mktemp("values_tf32") / "high_f32.npz")
    jh.save_hier_bank(jhb, path)
    thb = th.load_hier_bank(path, device="cpu")
    q, x = bank["qx"]
    q_cat = rf.pack_queries(_tensor(q), _tensor(x), 12.0, 40.0, "high")
    m_s, s_s, m_g, s_g = th._hier_scan_stats_plain(q_cat, thb.g_sem_cat, thb.g_geo_cat,
                                                   gpt_s=16, gpt_g=8)
    idx, _ = th.select_tiles(m_s, s_s, m_g, s_g, k_tiles=4, t_real=thb.t_real, bm=128,
                             n_valid=B, mode="range")
    return dict(jhb=jhb, thb=thb, q_cat=q_cat, idx=idx)


def _j(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _within_terms(name, got, ref, mag, bf16_rows=None):
    """The exact tier's bar (`_hold_cores`): with f32 values (``bf16_rows``
    None) 1e-4 x the sum of the terms' magnitudes + 1e-6 (f32 products; p
    moves by ~1e-5 of itself with the logits' summation order at |l| <=
    86).  After a bf16 rounding point (bf16 values, int8 codes) the terms
    rule, min(4e-3 x the row's largest |ref|, 2^-7 x the sum of the terms)
    + 1e-6: a weight within the logits' f32 difference of a bf16 boundary
    may round the other way, so at most ``bf16_rows`` rows may hold
    elements over it, each within 2^-7 x the sum of its terms."""
    err = np.abs(got - ref)
    if bf16_rows is None:
        assert (err <= 1e-4 * mag + 1e-6).all(), (name, (err / (1e-4 * mag + 1e-6)).max())
        return
    flip = 2.0 ** -7 * mag + 1e-6
    tol = np.minimum(4e-3 * np.abs(ref).max(1, keepdims=True), flip - 1e-6) + 1e-6
    over = (err > tol).any(1)
    assert over.sum() <= bf16_rows, (name, int(over.sum()), (err / tol).max())
    assert (err <= flip).all(), (name, (err / flip).max())


MERGED = ["lr", "lr-nogeo", "plain", "plain-nogeo"]


def _merged(bank, form, vdt):
    thb, jhb = bank["thb"], bank["jhb"]
    lr, geo = form.startswith("lr"), not form.endswith("nogeo")
    values, scale = bank["values"][vdt]
    vw = thb.g_sem_vw_lr if lr else thb.g_sem_vw
    targs = (bank["q_cat"], thb.k_cat, values, scale, thb.mask_neg, bank["idx"][False],
             thb.g_sem_cat, thb.g_geo_cat, vw, thb.g_geo_vw)
    tkw = dict(sem_d=thb.sem_d, bm=128, bn=128, gpt_s=16, gpt_g=8, lr=lr, geo=geo)
    jargs = tuple(_j(t) for t in targs[:6]) + (
        jhb.g_sem_cat, jhb.g_geo_cat, jhb.g_sem_vw_lr if lr else jhb.g_sem_vw, jhb.g_geo_vw)
    jkw = dict(sem_d=thb.sem_d, bm=128, bn=128, gpt_s=16, gpt_g=8, lr=lr)
    fams, out_w = th._merged_fams(targs[0], targs[1], values, thb.g_sem_cat, thb.g_geo_cat, vw,
                                  thb.g_geo_vw, sem_d=thb.sem_d, gpt_s=16, gpt_g=8, lr=lr,
                                  geo=geo)
    return targs, tkw, jargs, jkw, fams, out_w


@pytest.mark.parametrize("vdt", ["bf16", "f32", "int8"])
@pytest.mark.parametrize("form", MERGED)
def test_values_tf32_merged_matches_jax(bank, form, vdt):
    """Kernel 15 (lr or plain sem groups, with or without the geo family):
    `_values_tf32_plain` against JAX's `_hier_parts_call` in interpret mode
    (its geo family always on: the port's geo=False columns come back zero)
    and the port's one-pass plain version, every column by the exact
    tier's bar; bf16 values and int8 codes allow their rounding point's
    flips in at most 2 rows."""
    targs, tkw, jargs, jkw, fams, out_w = _merged(bank, form, vdt)
    got = th._values_tf32_plain(*targs[:6], fams, bm=128, bn=128, out_w=out_w).numpy()
    plain = th._hier_parts_plain(*targs, **tkw).numpy()
    mag = th._hier_parts_plain(*targs, **tkw, magnitude=True).numpy()
    want = np.asarray(jh._hier_parts_call(*jargs, **jkw, interpret=True), np.float32)
    assert got.shape == plain.shape == want.shape
    flips = None if vdt == "f32" else 2
    _within_terms(form, got, plain, mag, flips)
    Dv = DV
    keep = np.ones(got.shape[1], bool)
    if not tkw["geo"]:
        keep[Dv:2 * Dv] = keep[2 * Dv + 1] = False
        assert not got[:, ~keep].any()
    assert not got[:, 2 * Dv + 2:2 * Dv + 128].any()
    _within_terms(form + " vs JAX", got[:, keep], want[:, keep], mag[:, keep], flips)


FAMILY = ["lr-sem", "plain-sem", "lr-geo", "plain-geo", "lr-sel", "plain-sel", "lr-dedup",
          "plain-dedup"]


def _family(bank, form, vdt):
    thb, jhb = bank["thb"], bank["jhb"]
    lr, geo = form.startswith("lr"), form.endswith("geo")
    sel, dedup = form.endswith("sel"), form.endswith("dedup")
    values, scale = bank["values"][vdt]
    idx = bank["idx"][geo]
    if dedup:
        idx = torch.cat([idx[:, :2], idx[:, 1:2], idx[:, 2:]], 1)  # a repeat a row
    q_cat, g_cat = bank["q_cat"], thb.g_geo_cat if geo else thb.g_sem_cat
    jg = jhb.g_geo_cat if geo else jhb.g_sem_cat
    vw = (thb.g_geo_vw_lr if lr else thb.g_geo_vw) if geo else (
        thb.g_sem_vw_lr if lr else thb.g_sem_vw)
    jvw = (jhb.g_geo_vw_lr if lr else jhb.g_geo_vw) if geo else (
        jhb.g_sem_vw_lr if lr else jhb.g_sem_vw)
    if sel:
        q_cat = torch.cat([q_cat, q_cat[:, :thb.sem_d] @ thb.p_sel.T], 1).contiguous()
        g_cat, jg = thb.g_sem_sel, jhb.g_sem_sel
    targs = (q_cat, thb.k_cat, thb.mask_neg, idx, g_cat, vw, None)
    tkw = dict(sem_d=thb.sem_d, bm=128, bn=128, gpt=8 if geo else 16, geo=geo, lrr=0, lr=lr,
               values=values, scale=scale, sel=sel, dedup_pad=dedup)
    jargs = (_j(q_cat), _j(thb.k_cat), _j(values), _j(scale), _j(thb.mask_neg), _j(idx), jg,
             jvw)
    jkw = dict(sem_d=thb.sem_d, bm=128, bn=128, gpt=8 if geo else 16, geo=geo, lr=lr,
               dedup_pad=dedup, sel=sel)
    fams, out_w = th._family_fams(q_cat, thb.k_cat, values, g_cat, vw, sem_d=thb.sem_d,
                                  gpt=tkw["gpt"], geo=geo, lr=lr, sel=sel)
    return targs, tkw, jargs, jkw, fams, out_w


@pytest.mark.parametrize("vdt", ["bf16", "f32"])
@pytest.mark.parametrize("form", FAMILY)
def test_values_tf32_family_matches_jax(bank, form, vdt):
    """Kernel 14's value shapes (lr and plain; sem, geo, the sel form over
    [q_cat | q_sel] against the sketched centroids, dedup_pad over a list
    with a repeat a row): `_values_tf32_plain` against JAX's
    `_hier_parts_family_call` in interpret mode and the port's one-pass
    plain version by the exact tier's bar; the pad columns are zero."""
    targs, tkw, jargs, jkw, fams, out_w = _family(bank, form, vdt)
    f = tkw
    got = th._values_tf32_plain(targs[0], targs[1], f["values"], f["scale"], targs[2],
                                targs[3], fams, bm=128, bn=128, out_w=out_w,
                                dedup=f["dedup_pad"]).numpy()
    plain = th._hier_parts_family_plain(*targs, **tkw).numpy()
    mag = th._hier_parts_family_plain(*targs, **tkw, magnitude=True).numpy()
    want = np.asarray(jh._hier_parts_family_call(*jargs, **jkw, interpret=True), np.float32)
    assert got.shape == plain.shape == want.shape
    flips = None if vdt == "f32" else 2
    _within_terms(form, got, plain, mag, flips)
    _within_terms(form + " vs JAX", got, want, mag, flips)
    assert not got[:, DV + 1:DV + 128].any()


def test_values_tf32_int8_family(bank):
    """The family lr shape over int8 codes: w = bf16(p * s) against JAX."""
    targs, tkw, jargs, jkw, fams, out_w = _family(bank, "lr-sem", "int8")
    got = th._values_tf32_plain(targs[0], targs[1], tkw["values"], tkw["scale"], targs[2],
                                targs[3], fams, bm=128, bn=128, out_w=out_w).numpy()
    mag = th._hier_parts_family_plain(*targs, **tkw, magnitude=True).numpy()
    want = np.asarray(jh._hier_parts_family_call(*jargs, **jkw, interpret=True), np.float32)
    _within_terms("int8 lr", got, want, mag, 2)


@pytest.mark.parametrize("form", ["merged-plain", "family-lr"])
def test_values_tf32_bf16_logits_f32_values(bank, form):
    """A `fast` bank whose values are f32 (`build_hier_bank(value_dtype=)`
    at a bf16 tier): its f32-operand launches take the TF32 x3 body too,
    the bf16 logit and group operands exact in it; p is not rounded (f32
    values), e is (bf16 group sums: the groups pass's ebf16), as in JAX's
    kernel in interpret mode, held by the terms rule (bf16 e before a
    product)."""
    bf = torch.bfloat16
    if form == "merged-plain":
        targs, tkw, *_ = _merged(bank, "plain", "f32")
        targs = tuple(t.to(bf) if i in (0, 1, 6, 7, 8, 9) else t for i, t in enumerate(targs))
        fams, out_w = th._merged_fams(targs[0], targs[1], targs[2], targs[6], targs[7],
                                      targs[8], targs[9], sem_d=tkw["sem_d"], gpt_s=16,
                                      gpt_g=8, lr=False, geo=True)
        args = targs[:6]
        plain = th._hier_parts_plain(*targs, **tkw).numpy()
        mag = th._hier_parts_plain(*targs, **tkw, magnitude=True).numpy()
        want = jh._hier_parts_call(*(_j(t) for t in targs), sem_d=tkw["sem_d"], bm=128,
                                   bn=128, gpt_s=16, gpt_g=8, lr=False, interpret=True)
        dedup = False
    else:
        targs, tkw, *_ = _family(bank, "lr-sem", "f32")
        targs = tuple(t.to(bf) if i in (0, 1, 4, 5) else t for i, t in enumerate(targs))
        fams, out_w = th._family_fams(targs[0], targs[1], tkw["values"], targs[4], targs[5],
                                      sem_d=tkw["sem_d"], gpt=16, geo=False, lr=True, sel=False)
        args = (targs[0], targs[1], tkw["values"], None, targs[2], targs[3])
        plain = th._hier_parts_family_plain(*targs, **tkw).numpy()
        mag = th._hier_parts_family_plain(*targs, **tkw, magnitude=True).numpy()
        want = jh._hier_parts_family_call(
            _j(targs[0]), _j(targs[1]), _j(tkw["values"]), None, _j(targs[2]), _j(targs[3]),
            _j(targs[4]), _j(targs[5]), sem_d=tkw["sem_d"], bm=128, bn=128, gpt=16, lr=True,
            interpret=True)
        dedup = False
    got = th._values_tf32_plain(*args, fams, bm=128, bn=128, out_w=out_w, dedup=dedup).numpy()
    want = np.asarray(want, np.float32)
    _within_terms(form, got, plain, mag, 2)
    _within_terms(form + " vs JAX", got, want, mag, 2)


@pytest.mark.parametrize("form", ["merged-lr", "merged-plain", "family-lr"])
def test_values_tf32_high_tier_f32_values(high_f32, form):
    """A `high` bank built with f32 values: 768 bf16 logit columns (24
    chunks, past the p pass's 8 resident ones) and 768-column sem
    centroids (past the groups pass's 16 resident chunks), which the TF32 x3
    body takes (the CUDA-core body took them before it); kernel 15 lr and
    plain, kernel 14's lr value shape, against JAX in interpret mode and
    the port's plain version by the terms rule (e rounded to bf16 before
    the bf16 group sums)."""
    thb, jhb, q_cat, idx = (high_f32[k] for k in ("thb", "jhb", "q_cat", "idx"))
    assert (thb.sem_d, q_cat.dtype, thb.values.dtype) == (768, torch.bfloat16, torch.float32)
    lr = form.endswith("lr")
    if form.startswith("merged"):
        vw = thb.g_sem_vw_lr if lr else thb.g_sem_vw
        targs = (q_cat, thb.k_cat, thb.values, None, thb.mask_neg, idx, thb.g_sem_cat,
                 thb.g_geo_cat, vw, thb.g_geo_vw)
        tkw = dict(sem_d=768, bm=128, bn=128, gpt_s=16, gpt_g=8, lr=lr)
        fams, out_w = th._merged_fams(*targs[:3], *targs[6:], sem_d=768, gpt_s=16, gpt_g=8,
                                      lr=lr, geo=True)
        plain = th._hier_parts_plain(*targs, **tkw).numpy()
        mag = th._hier_parts_plain(*targs, **tkw, magnitude=True).numpy()
        want = jh._hier_parts_call(*(_j(t) for t in targs[:6]), jhb.g_sem_cat, jhb.g_geo_cat,
                                   jhb.g_sem_vw_lr if lr else jhb.g_sem_vw, jhb.g_geo_vw,
                                   **tkw, interpret=True)
    else:
        targs = (q_cat, thb.k_cat, thb.mask_neg, idx, thb.g_sem_cat, thb.g_sem_vw_lr, None)
        tkw = dict(sem_d=768, bm=128, bn=128, gpt=16, geo=False, lrr=0, lr=True,
                   values=thb.values, scale=None, sel=False, dedup_pad=False)
        fams, out_w = th._family_fams(q_cat, thb.k_cat, thb.values, thb.g_sem_cat,
                                      thb.g_sem_vw_lr, sem_d=768, gpt=16, geo=False, lr=True,
                                      sel=False)
        plain = th._hier_parts_family_plain(*targs, **tkw).numpy()
        mag = th._hier_parts_family_plain(*targs, **tkw, magnitude=True).numpy()
        want = jh._hier_parts_family_call(
            _j(q_cat), _j(thb.k_cat), _j(thb.values), None, _j(thb.mask_neg), _j(idx),
            jhb.g_sem_cat, jhb.g_sem_vw_lr, sem_d=768, bm=128, bn=128, gpt=16, lr=True,
            interpret=True)
    assert fams[0][2] == slice(0, 768) and fams[0][3] == slice(0, 768)
    sh = th._values_tf32_shape("hier_parts", q_cat, thb.k_cat, thb.values, None, thb.mask_neg,
                               idx, fams, bm=128, bn=128)
    assert (sh.fams[0].KC, sh.fams[0].GC) == (24, 24)
    got = th._values_tf32_plain(q_cat, thb.k_cat, thb.values, None, thb.mask_neg, idx, fams,
                                bm=128, bn=128, out_w=out_w).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == plain.shape == want.shape
    _within_terms(form, got, plain, mag, 2)
    _within_terms(form + " vs JAX", got, want, mag, 2)


def test_values_tf32_images_read_back(bank):
    """The value pass's B images read back to the values: bf16 values and
    int8 codes exactly (bf16 holds both), zero past Dv (three slices, the
    last 64 columns wide) and past a tile's rows; f32 values as hi + lo
    within 2^-22 of each value, both TF32 values."""
    thb = bank["thb"]
    sh = th.ValuesTf32Shape(2, DV, 3, ())
    T = N // 128
    for vdt in ("bf16", "int8"):
        v = bank["values"][vdt][0]
        img = th._values_bf16_image(v, spt=2, VS=3, bn=128)
        assert img.shape == (T, 2, 3, 2, 64, 64) and img.dtype == torch.bfloat16
        back = _prep.swizzle128(img).permute(0, 1, 4, 2, 3, 5).reshape(T, 128, 384)
        assert torch.equal(back[..., :DV].float(), v.float().reshape(T, 128, DV))
        assert not back[..., DV:].any()
    v = bank["values"]["f32"][0]
    img = th._values_tf32_images(v, sh, bn=128)
    assert img.shape == (T, 2, 2, 3, 2, 128, 32)
    hi, lo = _prep.kmajor_tf32_read(img.transpose(2, 3))  # [T, spt, VS, 128, 64]
    hi, lo = (x.permute(0, 1, 4, 2, 3).reshape(T, 128, 384) for x in (hi, lo))
    assert torch.equal(hi, _prep.tf32_rna(hi)) and torch.equal(lo, _prep.tf32_rna(lo))
    ref = v.reshape(T, 128, DV)
    assert ((ref - hi[..., :DV] - lo[..., :DV]).abs() <= 2.0 ** -22 * ref.abs()).all()
    assert not hi[..., DV:].any()
    # the keys' image, shared with the rr kernels (one bank layout)
    kimg = th._tf32_keys_image(thb.k_cat, kc0=0, kf=thb.sem_d, KC=8, spt=2, bn=128)
    assert kimg is th._tf32_keys_image(thb.k_cat, kc0=0, kf=thb.sem_d, KC=8, spt=2, bn=128)


def test_values_tf32_chunks_hold_a_cancelling_product():
    """The value pass at f32 over a 16,384-row list (32 tiles of 512 rows,
    RANGE's flagship): p (exponentials, as the p pass makes them) times
    value columns that cancel over the rows.  The kernel's chunks (each 32
    rows' twelve TF32 products in a fresh fragment) hold the f32 bar of a
    sum taken in another order, 1e-5 of each row's largest result; one
    truncated chain over every row misses it."""
    g = torch.Generator().manual_seed(2)
    p = torch.exp2(torch.rand(8, 16_384, generator=g) * 6)
    v = torch.rand(16_384, 128, generator=g) + 0.5
    v = v - (p.mean(0) @ v / p.mean(0).sum())  # each column's p-weighted mean removed
    vh, vl = _prep.tf32_split(v)
    ref = p.double() @ v.double()
    bar = 1e-5 * ref.abs().amax(1, keepdim=True)

    def chunks():
        acc = torch.zeros(8, 128)
        for r0 in range(0, 16_384, 32):
            acc = _prep.tf32x3_matmul(p[:, r0:r0 + 32], vh[r0:r0 + 32], vl[r0:r0 + 32],
                                      "chunks", acc=acc)
        return acc

    def ratio(got):
        return ((got.double() - ref).abs() / bar).max().item()

    assert ratio(chunks()) < 0.5
    assert ratio(_prep.tf32x3_matmul(p, vh, vl, "rz")) > 1.0


def test_values_tf32_shape_refuses_what_the_launch_refuses(bank):
    """The shape check takes the exact tier's widths and refuses, before
    any launch, what `hier_values_tf32_p_launch` / `_v_launch` and the
    groups launch refuse: logits over 1,536 columns (rows or groups; 512,
    768 and 1,536 are taken, the CUDA-core body took ~450 f32 and ~1,290
    bf16 ones), a batch of no whole selection
    blocks, bm no multiple of 64, tiles of no whole number of groups, an
    odd Dv, int8 codes without their scales, full-width group sums
    narrower than Dv + 1; and every block fits the SM at every depth."""
    thb = bank["thb"]
    targs, tkw, *_ = _merged(bank, "plain", "f32")
    q_cat, k_cat, values, scale, mask, idx, gs, gg, vw, gvw = targs

    def shape(q=q_cat, k=k_cat, v=values, s=scale, i=idx, g=gs, w=vw, sem_d=thb.sem_d,
              bm=128, bn=128, gpt=16, lr=False):
        fams, out_w = th._merged_fams(q, k, v, g, gg, w, gvw, sem_d=sem_d, gpt_s=gpt, gpt_g=8,
                                      lr=lr, geo=True)
        return th._values_tf32_shape("hier_parts", q, k, v, s, mask, i, fams, bm=bm, bn=bn)

    sh = shape()
    assert (sh.spt, sh.Dv, sh.VS) == (2, DV, 3)
    fs = sh.fams[0]
    assert (fs.kf, fs.KC, fs.gwe, fs.GC, fs.NS, fs.acols, fs.dcol) == (
        256, 8, 256, 8, 3, DV + 1, 2 * DV)
    def wider(n):  # n more key columns in front (q, k), sem_d 256 + n
        return dict(q=torch.cat([q_cat[:, :256]] * (n // 256) + [q_cat[:, :n % 256], q_cat], 1),
                    k=torch.cat([k_cat[:, :256]] * (n // 256) + [k_cat[:, :n % 256], k_cat], 1),
                    sem_d=256 + n)

    for n in (256, 512, 1280):
        wide = shape(**wider(n), g=torch.cat([gs] * (1 + n // 256), 1))
        assert (wide.fams[0].kf, wide.fams[0].KC, wide.fams[0].gwe, wide.fams[0].GC) == (
            256 + n, 8 + n // 32, 256 + n, 8 + n // 32)
    bad = [wider(1281), dict(**wider(1280), g=torch.cat([gs] * 6 + [gs[:, :8]], 1)),
           dict(q=q_cat[:64]), dict(bm=96, q=torch.cat([q_cat, q_cat[:64]])),
           dict(gpt=12), dict(v=values[:, :DV - 1]), dict(w=vw[:, :DV]),
           dict(v=bank["values"]["int8"][0])]
    for kw in bad:
        with pytest.raises(ValueError, match="unsupported shapes"):
            shape(**kw)
    for KC in range(1, 49):
        for f in (False, True):
            assert max(th._values_tf32_smem(KC, f)) <= SMEM_MAX
        assert max(th._rr_tf32_smem(min(KC, 16), KC)) <= SMEM_MAX
    assert th._values_tf32_smem(8, False) == (201_792, 205_904)
    assert th._values_tf32_smem(16, True) == (201_792, 164_896)


@pytest.mark.parametrize("Bp,K,bm,VS", [(10_112, 32, 128, 8), (128, 32, 128, 8),
                                        (1_024, 96, 128, 8), (10_112, 32, 128, 3),
                                        (10_112, 32, 64, 8)])
def test_values_tf32_segments(Bp, K, bm, VS):
    """Each pass cuts its lists by `_rr_tf32_segments` over its own blocks
    (the p pass 128 queries a block where bm allows it, else 64; the value
    pass one a pair of slices): never past the list, every list cut where
    query blocks are few (B = 1 and 37 pad to 128 queries: one p block),
    RANGE's flagship's p pass in 3 segments of its 79 blocks."""
    n_p, n_v = th._values_tf32_segments(Bp, K, bm, VS)
    assert 1 <= n_p <= K and 1 <= n_v <= K
    assert n_p == th._rr_tf32_segments(Bp // (2 if bm % 128 == 0 else 1), K, 1)
    assert n_v == th._rr_tf32_segments(Bp, K, -(-VS // 2))
    if Bp == 128:
        assert n_p == K and n_v >= K // 2
    if (Bp, K, bm, VS) == (10_112, 32, 128, 8):
        assert (n_p, n_v) == (3, 1)
