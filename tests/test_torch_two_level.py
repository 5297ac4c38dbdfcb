"""The two-level top-k selection (gsz_super, the refine kernel's stats-only
form) and the weighted-supergroup sem tail (tail_super, the correction
kernel and the scan's segment-sum variant) of range_tpu_torch, each
against its range_tpu counterpart on the CPU.

Sizes follow `tests/test_hier.py:271,782`: the 3,000-row informative bank
of `tests/test_torch_hier.py` (256-d keys, bf16 128-d values), built by
JAX twice: two-level (bn = 128, gsz_sem = 8, gsz_geo = 16, gsz_super = 16:
8 supergroups of 2 fine groups a tile) and with tail_super = 32 on an
lr + rr + lr_geo bank (ratio 4).  The port loads JAX's archives, so both
sides serve the same operands.  JAX's Pallas kernels run in interpret mode.
Inputs are float32 numpy arrays (conftest enables x64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import _within_terms, jbank, tbank  # noqa: F401
from test_torch_topk import _hilo, _row_logits, _rows_agree_outside_near_ties

import range_tpu
from range_tpu.geometry import lonlat_deg_to_xyz as jax_xyz
from range_tpu.ops import retrieval_hier as jh
from range_tpu.ops.retrieval_pallas import pack_queries as jax_pack_queries
from range_tpu_torch import load_model
from range_tpu_torch.convert.from_jax import geobank_from_arrays, siren_params_from_jax
from range_tpu_torch.ops import retrieval_hier as th

KW2 = dict(bn=128, gsz_sem=8, gsz_geo=16, gsz_super=16)
KW_TS = dict(bn=128, gsz_sem=8, gsz_geo=16, lr_rank=128, lr_geo=128,
             res_rank=128, tail_super=32)
B = 256


def _np(x):
    return np.asarray(x).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf(x):
    return _t(np.asarray(x, np.float32)).bfloat16()


@pytest.fixture(scope="module")
def jhb2(jbank):
    return jh.build_hier_bank(jbank, **KW2)


@pytest.fixture(scope="module")
def jts(jbank):
    return jh.build_hier_bank(jbank, **KW_TS)


def _archive(jhb, tmp_path_factory, name):
    path = str(tmp_path_factory.mktemp("two_level") / name)
    jh.save_hier_bank(jhb, path)
    return path


@pytest.fixture(scope="module")
def thb2(jhb2, tmp_path_factory):
    return th.load_hier_bank(_archive(jhb2, tmp_path_factory, "hb2.npz"), device="cpu")


@pytest.fixture(scope="module")
def tts(jts, tmp_path_factory):
    return th.load_hier_bank(_archive(jts, tmp_path_factory, "ts.npz"), device="cpu")


@pytest.fixture(scope="module")
def regional(jhb2):
    """B queries near 8 bank rows (3 degree jitter), each a bank key nearby
    plus noise: the coherent batches hier serves (`tests/test_torch_topk.py`)."""
    rng = np.random.default_rng(21)
    locs, keys = _np(jhb2.bank.locs_lonlat), _np(jhb2.bank.keys_sem)
    rows = np.repeat(rng.integers(0, int(jhb2.bank.n_valid), 8), B // 8)
    ll = locs[rows] + rng.normal(0, 3.0, (B, 2))
    ll[:, 0] = (ll[:, 0] + 180) % 360 - 180
    ll[:, 1] = np.clip(ll[:, 1], -89.9, 89.9)
    q = keys[rows] + 0.3 * rng.standard_normal((B, 256))
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    x = np.asarray(jax_xyz(jnp.asarray(ll, jnp.float32)), np.float32)
    return q, x


@pytest.fixture(scope="module")
def q_cat(jhb2, regional):
    """The regional batch packed with its locations, geo-sorted (JAX)."""
    q, x = regional
    qc = jax_pack_queries(jnp.asarray(q), jnp.asarray(x), 12.0, 40.0, tier="fast")
    order = jh._hybrid_order(jnp.asarray(x), jnp.zeros(B, jnp.int32), B, jhb2.t_pad,
                             sort="geo")
    return qc[order]


# ---------------------------------------------------------------- build


def test_hierarchical_row_order_equals_jax(jhb2):
    """The per-tile key+value k-means, then the supergroup k-means over
    its 16 fine centroids (8 supergroups), on the clustered bank's
    features: the same permutation."""
    cb = jhb2.bank
    vf = cb.values.astype(jnp.float32)
    vn = vf / jnp.maximum(jnp.linalg.norm(vf, axis=1, keepdims=True), 1e-9)
    feats = jnp.concatenate([cb.keys_sem.astype(jnp.float32), vn], axis=1)
    j = jh._order_rows_within_tiles(feats, cb.row_mask(), 128, 16, 1, n_super=8)
    t = th._order_rows_within_tiles(_t(_np(feats)), _t(cb.row_mask()), 128, 16, n_super=8)
    np.testing.assert_array_equal(t, j)


def test_two_level_build_row_order_equals_jax(jhb2, tbank):
    hb = th.build_hier_bank(tbank, **KW2)
    assert (hb.bank.locs_lonlat.numpy() == _np(jhb2.bank.locs_lonlat)).all()
    assert (hb.gsz_super, hb.g_sup_cat.shape, hb.g_sup_vw.shape) == (16, (256, 256),
                                                                     (256, 256))


def _injected(jhb, **kw):
    """The port's operands of JAX's clustered bank (JAX's row order)."""
    cb = jhb.bank
    tcb = geobank_from_arrays(cb.locs_lonlat, cb.xyz, cb.keys_sem, cb.values,
                              cb.n_valid, cb.valid_mask)
    return th.pack_hier_bank(tcb, **kw)


# as `tests/test_torch_hier.py::test_build_operands_match_jax`: the same f32
# group sums of the same rows, then the same bf16 rounding; one bf16 ulp
# where a 16-term f32 sum lands on a tie
@pytest.mark.parametrize("name,atol", [("g_sup_cat", 2 ** -9), ("g_sup_vw", 2 ** -4),
                                       ("g_sem_cat", 2 ** -9)])
def test_supergroup_operands_match_jax(jhb2, name, atol):
    a = _np(getattr(jhb2, name))
    b = getattr(_injected(jhb2, **KW2), name).float().numpy()
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=atol)


def test_tail_super_operands_match_jax(jts):
    """ts_vw and dvw of the lr coefficients, whose eigenvector signs are
    arbitrary per column: compare what serving uses, the reconstructions
    ts_vw @ u and dvw @ u (the coefficients are bf16, summed over 128
    basis vectors: 2e-3 of the largest), and the count columns: the
    supergroup mean count, and each group's count minus it in dvw (0
    where the supergroup's groups are full)."""
    hb = _injected(jts, **KW_TS)
    u_j, u_t, r = _np(jts.u_sem), hb.u_sem.numpy(), 128
    for name in ("g_sem_ts_vw", "g_sem_ts_dvw"):
        a, b = _np(getattr(jts, name)), getattr(hb, name).float().numpy()
        assert a.shape == b.shape
        ref = a[:, :r] @ u_j
        np.testing.assert_allclose(b[:, :r] @ u_t, ref, rtol=0,
                                   atol=2e-3 * np.abs(ref).max(), err_msg=name)
        np.testing.assert_array_equal(b[:, r], a[:, r])
    full = (hb.g_sem_ts_vw[:, r].float() == 8).repeat_interleave(4)  # 8-row groups
    assert full.any() and not hb.g_sem_ts_dvw[full, r].any()
    assert hb.g_sem_ts_vw.shape[0] * 4 == hb.g_sem_vw_lr.shape[0]


@pytest.mark.parametrize("bank", ["two_level", "tail_super"])
def test_jax_archive_loads_equal(jhb2, jts, thb2, tts, bank, tmp_path):
    """A JAX archive with the new operands loads field for field; the
    port's save and load round-trip them; the build signatures are JAX's."""
    jhb, thb = (jhb2, thb2) if bank == "two_level" else (jts, tts)
    for f in ("g_sup_cat", "g_sup_vw", "g_sem_ts_vw", "g_sem_ts_dvw"):
        a, b = getattr(jhb, f), getattr(thb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == torch.bfloat16
            np.testing.assert_array_equal(b.float().numpy(), _np(a))
    assert (thb.gsz_super, thb.tail_super) == (jhb.gsz_super, jhb.tail_super)
    path = str(tmp_path / "port.npz")
    th.save_hier_bank(thb, path)
    back = th.load_hier_bank(path, device="cpu")
    for f in ("g_sup_cat", "g_sup_vw", "g_sem_ts_vw", "g_sem_ts_dvw"):
        a, b = getattr(thb, f), getattr(back, f)
        assert (a is None) == (b is None) and (a is None or torch.equal(a, b)), f
    kw = KW2 if bank == "two_level" else KW_TS
    sig = dict(tier="fast", seed=0, shards=1, **kw)
    assert th.hier_build_signature(thb.bank, **sig) == jh.hier_build_signature(jhb.bank, **sig)


# ---------------------------------------------------------------- kernels


def test_scan_sup_variant_plain_matches_jax(jts, tts, q_cat):
    """`_hier_scan_plain(sup_r=4)` against `_hier_scan_call(sup_r_s=4)`:
    stats as the one-level scan's (max logits within 1e-4, exp-masses 1e-4
    relative); the tails within one bf16 ulp of their terms, the
    supergroup sums rounding where a sum lands near a bf16 boundary."""
    args = (q_cat, jts.g_sem_cat, jts.g_geo_cat, jts.g_sem_ts_vw, jts.g_geo_vw_lr)
    ref = jh._hier_scan_call(*args, bm=128, tc=4, gpt_s=16, gpt_g=8, sup_r_s=4,
                             interpret=True)
    targs = (_bf(q_cat), tts.g_sem_cat, tts.g_geo_cat, tts.g_sem_ts_vw, tts.g_geo_vw_lr)
    got = th._hier_scan_plain(*targs, gpt_s=16, gpt_g=8, sup_r=4)
    mag = th._hier_scan_plain(_bf(q_cat), tts.g_sem_cat, tts.g_geo_cat,
                              tts.g_sem_ts_vw.abs(), tts.g_geo_vw_lr.abs(), gpt_s=16,
                              gpt_g=8, sup_r=4)[4].numpy()
    for i in (0, 2):
        np.testing.assert_allclose(got[i].numpy(), _np(ref[i]), rtol=0, atol=1e-4)
    for i in (1, 3):
        np.testing.assert_allclose(got[i].numpy(), _np(ref[i]), rtol=1e-4, atol=0)
    tails, ref4 = got[4].numpy(), _np(ref[4])
    assert tails.shape == ref4.shape == (B, 256 + 256)
    for cols in (slice(0, 256), slice(256, 512)):
        _within_terms(tails[:, cols], ref4[:, cols], mag[:, cols])


def test_scan_sup_variant_rounds_the_sums_once(tts, q_cat):
    """Rounding each group's exp2 to bf16 before the segment sum gives
    another tail: the variant rounds the f32 sums."""
    args = (_bf(q_cat), tts.g_sem_cat, tts.g_geo_cat, tts.g_sem_ts_vw, tts.g_geo_vw_lr)
    got = th._hier_scan_plain(*args, gpt_s=16, gpt_g=8, sup_r=4)[4][:, :256]
    logit = _bf(q_cat)[:, :256].float() @ tts.g_sem_cat.float().T
    e = torch.exp2(torch.clamp_max(logit, 86.0)).bfloat16().float()
    each = e.reshape(B, -1, 4).sum(2).bfloat16().float() @ tts.g_sem_ts_vw.float()
    assert not torch.equal(got, each)


def _refine_operands(jhb2, q_cat, M=8):
    """The coarse selection of M tiles per 128-query block (JAX)."""
    stats = jh._hier_scan_stats_call(q_cat, jhb2.g_sup_cat, jhb2.g_geo_cat, bm=128, tc=8,
                                     gpt_s=8, gpt_g=8, interpret=True)
    idx, _ = jh.select_tiles(*stats, t_real=24, k_tiles=M, bm=128, n_valid=B, j_sem=6,
                             mode="range")
    return stats, idx


def test_refine_plain_matches_jax(jhb2, thb2, q_cat):
    """The stats-only refine over 8 coarse tiles per block, 16 fine groups
    a tile: max logits within 1e-4, exp-masses 1e-4 relative (f32 sums of
    the same bf16 products in another order)."""
    _, idx = _refine_operands(jhb2, q_cat)
    m_j, s_j, none = jh._hier_refine_call(q_cat, idx, jhb2.g_sem_cat, jhb2.g_sup_cat, None,
                                          None, bm=128, gpt_f=16, gpt_sup=8,
                                          stats_only=True, interpret=True)
    m_t, s_t, none_t = th._hier_refine_call(_bf(q_cat), _t(idx).to(torch.int32),
                                            thb2.g_sem_cat, thb2.g_sup_cat, None, None,
                                            bm=128, gpt_f=16, gpt_sup=8, stats_only=True)
    assert none is none_t is None and m_t.shape == (B, 8)
    np.testing.assert_allclose(m_t.numpy(), _np(m_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(s_t.numpy(), _np(s_j), rtol=1e-4, atol=0)
    # the has_parts form (`tests/test_torch_two_level_features.py` holds its
    # partial against JAX's) gives the same stats
    m_p, s_p, parts = th._hier_refine_call(_bf(q_cat), _t(idx).to(torch.int32),
                                           thb2.g_sem_cat, thb2.g_sup_cat, thb2.g_sem_vw,
                                           thb2.g_sup_vw, bm=128, gpt_f=16, gpt_sup=8)
    assert torch.equal(m_p, m_t) and torch.equal(s_p, s_t) and parts.shape == (B, 256)


def test_gather_cols_equals_jax(jhb2, q_cat):
    stats, idx = _refine_operands(jhb2, q_cat)
    for s in stats:
        np.testing.assert_array_equal(th._gather_cols(_t(_np(s)), _t(idx), 128).numpy(),
                                      _np(jh._gather_cols(s, idx, 128)))


def test_corr_plain_matches_jax(jts, tts, q_cat):
    """The correction over 12 sem tiles per block: one bf16 ulp of each
    term, as the tails (the bf16 exp2 of f32 logits summed in another
    order may round the other way)."""
    m_s, s_s, m_g, s_g, _ = jh._hier_scan_call(
        q_cat, jts.g_sem_cat, jts.g_geo_cat, jts.g_sem_ts_vw, jts.g_geo_vw_lr, bm=128, tc=4,
        gpt_s=16, gpt_g=8, sup_r_s=4, interpret=True)
    idx, _ = jh.select_tiles(m_s, s_s, m_g, s_g, t_real=24, k_tiles=12, bm=128, n_valid=B,
                             mode="range")
    ref = _np(jh._hier_corr_call(q_cat, idx, jts.g_sem_cat, jts.g_sem_ts_dvw, bm=128,
                                 gpt=16, interpret=True))
    targs = (_bf(q_cat), _t(idx).to(torch.int32), tts.g_sem_cat, tts.g_sem_ts_dvw)
    got = th._hier_corr_call(*targs, bm=128, gpt=16).numpy()
    mag = th._hier_corr_plain(*targs, bm=128, gpt=16, magnitude=True).numpy()
    assert got.shape == ref.shape == (B, 256)
    _within_terms(got, ref, mag)


def test_new_wrappers_take_the_plain_version_on_cpu(jhb2, thb2, tts, q_cat):
    _, idx = _refine_operands(jhb2, q_cat)
    n0 = (th._hier_refine_call.launches, th._hier_corr_call.launches,
          th._hier_scan_call.launches, th._hier_scan_call.sup_launches)
    th._hier_refine_call(_bf(q_cat), _t(idx).int(), thb2.g_sem_cat, None, None, None,
                         bm=128, gpt_f=16, gpt_sup=8, stats_only=True)
    th._hier_corr_call(_bf(q_cat), _t(idx).int(), tts.g_sem_cat, tts.g_sem_ts_dvw, bm=128,
                       gpt=16)
    th._hier_scan_call(_bf(q_cat), tts.g_sem_cat, tts.g_geo_cat, tts.g_sem_ts_vw,
                       tts.g_geo_vw_lr, gpt_s=16, gpt_g=8, sup_r=4)
    assert (th._hier_refine_call.launches, th._hier_corr_call.launches,
            th._hier_scan_call.launches, th._hier_scan_call.sup_launches) == n0


# ---------------------------------------------------------------- serving


def test_retrieve_hier_m_corr_matches_jax(jts, tts, regional):
    """The tail_super flagship shape: one selection of K + m_corr tiles,
    the supergroup scan, the correction, the fused combine.  The
    flagship's feature tolerance (`tests/test_torch_hier_api.py`: f32 sums
    in other orders, a bf16-rounded weight one ulp the other way): 2e-4 on
    outputs ~0.5."""
    q, x = regional
    kw = dict(k_tiles=4, k_geo=2, bm=128, m_corr=4)
    j = np.asarray(jh.retrieve_hier(jnp.asarray(q), jnp.asarray(x), jts,
                                    concat_query=jnp.asarray(q), interpret=True, **kw))
    t = th.retrieve_hier(_t(q), _t(x), tts, concat_query=_t(q), **kw).numpy()
    assert t.shape == j.shape == (B, 384)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)


def test_tail_super_telescope(tts, regional):
    """`tests/test_hier.py::test_tail_super_telescope` on the port: with
    every tile corrected (m_corr = t_real) the supergroup tail plus the
    correction is the fine-tail pipeline's output (up to the bf16 split of
    the tail operand into ts_vw and dvw: rtol 2e-2, atol 2e-3, JAX's);
    against the exact dense retrieve the error does not grow with m_corr,
    and at m_corr = 0 stays in the fine baseline's regime."""
    from range_tpu_torch.ops import retrieval

    q, x = _t(regional[0]), _t(regional[1])
    skw = dict(k_tiles=4, k_geo=2, bm=128)
    fine = dataclasses.replace(tts, tail_super=0, g_sem_ts_vw=None, g_sem_ts_dvw=None)
    base = th.retrieve_hier(q, x, fine, **skw).numpy()
    full = th.retrieve_hier(q, x, tts, m_corr=tts.t_real, **skw).numpy()
    np.testing.assert_allclose(full, base, rtol=2e-2, atol=2e-3)
    ref = retrieval.retrieve(q, x, tts.bank, sem_temp=12.0, beta=0.5).numpy()
    den = np.maximum(np.abs(ref), 1e-1)

    def err(out):
        return (np.abs(out - ref) / den).mean()

    e0, e8 = (err(th.retrieve_hier(q, x, tts, m_corr=m, **skw).numpy()) for m in (0, 8))
    assert e8 <= e0 + 1e-9 and err(full) <= e8 + 1e-9
    assert e0 < 3 * err(base) + 1e-3


def test_tail_super_serving_contract(tts, regional):
    """RANGE mode on a tail_super bank raises ValueError (the merged parts
    kernel has no supergroup correction); the rescue and dedup serve it as
    JAX does: dedup is skipped on tail_super banks and a rescue share of 2
    (R >= the padded batch) rescues nothing, so both answers are the plain
    one; m_corr on a bank without tail_super is ignored, as in JAX."""
    q, x = _t(regional[0][:8]), _t(regional[1][:8])
    with pytest.raises(ValueError, match="family-split"):
        th.retrieve_hier(q, None, tts, mode="range", bm=128)
    base = th.retrieve_hier(q, x, tts, bm=128)
    for knob in ("adaptive_frac", "dedup"):
        assert torch.equal(th.retrieve_hier(q, x, tts, bm=128, **{knob: 2}), base)
    fine = dataclasses.replace(tts, tail_super=0, g_sem_ts_vw=None, g_sem_ts_dvw=None)
    assert torch.equal(th.retrieve_hier(q, x, fine, bm=128, m_corr=8),
                       th.retrieve_hier(q, x, fine, bm=128))


@pytest.mark.parametrize("k", [1, 8])
@pytest.mark.parametrize("with_xyz", [True, False], ids=["xyz", "no_xyz"])
@pytest.mark.parametrize("budget", ["widened", "base"])
def test_two_level_hier_topk_equals_jax(jhb2, thb2, regional, k, with_xyz, budget):
    """The two-level endpoint: coarse stats over g_sup_cat, M tiles, the
    refine stats, K of the M.  ``widened`` (B = 256: bm 128, 3x K = 12, M
    = 24 = every tile, j + 4) and ``base`` (K = 4 of M = 8).  Rows equal
    JAX's outside near-ties (`tests/test_torch_topk.py`: rival logits
    within 2e-6)."""
    q, x = regional
    kw = (dict(k_tiles=4, m_tiles=8, bm=128) if budget == "widened"
          else dict(k_tiles=4, m_tiles=8, bm=128, auto_widen=False))
    xx = x if with_xyz else None
    j = np.asarray(jh.hier_topk(jnp.asarray(q), None if xx is None else jnp.asarray(xx),
                                jhb2, k=k, interpret=True, **kw))
    t = th.hier_topk(_t(q), None if xx is None else _t(xx), thb2, k=k, **kw)
    assert t.dtype == torch.int32 and t.shape == j.shape
    t, j = t.numpy().reshape(B, -1), j.reshape(B, -1)
    if (t != j).any():  # only near-ties may differ
        q2, ql = _hilo(q)
        ref_scores = _row_logits(q2, ql, jhb2.khl_sem, jhb2.mask_neg, j, 256)
        _rows_agree_outside_near_ties(t, j, ref_scores, q2, ql, jhb2.khl_sem, jhb2.mask_neg,
                                      256, f"two-level k={k}")


def test_two_level_branch_selects_from_the_fine_stats(thb2, regional):
    """With every tile in M and K the two-level selection keeps every
    tile, so its rows are the one-level endpoint's over the same bank
    (its g_sem_cat branch) exactly."""
    q, x = _t(regional[0]), _t(regional[1])
    one = dataclasses.replace(thb2, gsz_super=0, g_sup_cat=None)
    kw = dict(k_tiles=24, m_tiles=24, bm=128, auto_widen=False)
    assert torch.equal(th.hier_topk(q, x, thb2, k=4, **kw),
                       th.hier_topk(q, x, one, k=4, **kw))


def test_flagship_tail_super_matches_jax(jbank, tmp_path):
    """load_model("RANGE+", profile="flagship", tail_super=32, m_corr=8):
    JAX builds the HierBank and saves it as its hier cache; the port's
    load_model with the same knobs loads that archive (the signatures are
    equal) and serves the same path.  f32 tower (the JAX weights carried
    across) and retrieval summed in other orders: 2e-4, as
    `tests/test_torch_hier_api.py::test_flagship_matches_jax`."""
    cache = str(tmp_path / "hb.npz")
    kw = dict(profile="flagship", k_tiles=4, k_geo=2, hier_cache=cache, tower_matmul=None,
              hier_bn=128, gsz_geo=16, chunk=512, seed=0, tail_super=32, m_corr=8)
    jenc = range_tpu.load_model("RANGE+", db_path=jbank, **kw)
    sig = th.peek_hier_build(cache)
    assert sig["tail_super"] == 32
    bank = geobank_from_arrays(jbank.locs_lonlat, jbank.xyz, jbank.keys_sem, jbank.values,
                               jbank.n_valid)
    enc = load_model("RANGE+", db_path=bank, device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    assert th.peek_hier_build(cache) == sig  # loaded, not rebuilt
    assert enc.model.bank.tail_super == 32 and enc.model.config.m_corr == 8
    rng = np.random.default_rng(3)
    locs = np.asarray(jbank.locs_lonlat)[np.repeat(rng.integers(0, 2000, 8), 32)]
    coords = (locs + rng.normal(0, 3.0, locs.shape)).astype(np.float32)
    coords[:, 1] = np.clip(coords[:, 1], -89.9, 89.9)
    coords[:, 0] = (coords[:, 0] + 180) % 360 - 180
    j = np.asarray(jenc(jnp.asarray(coords)))
    t = enc(coords).numpy()
    assert t.shape == j.shape == (256, 384)
    np.testing.assert_allclose(t, j, rtol=0, atol=2e-4)
