"""The hierarchical RANGE+ slice of range_tpu_torch as a whole: the flagship
profile through `load_model` on the CPU, against range_tpu's and against
the exact dense retrieval, plus its error contract.

The shapes follow `tests/test_api.py::test_serving_profiles`: the flagship
profile with bn = 128 and gsz_geo = 16 over a small informative bank with
128-d bf16 values (lr_rank / lr_geo / res_rank clamp to 128).  The SatCLIP
tower runs at full width with the JAX weights carried across.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)

import range_tpu
from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu_torch import GeoBank, load_model
from range_tpu_torch.api import SERVING_PROFILES
from range_tpu_torch.convert.from_jax import geobank_from_arrays, siren_params_from_jax
from range_tpu_torch.geometry import lonlat_deg_to_xyz
from range_tpu_torch.models.range_encoder import RangeConfig
from range_tpu_torch.ops import retrieval
from range_tpu_torch.ops import retrieval_hier as th

SMALL = dict(hier_bn=128, gsz_geo=16, chunk=512, seed=0)
CHEAP = dict(SMALL, lr_rank=0, lr_geo=0, res_rank=0)


def _regional_coords(locs, B, seed):
    """B query locations around 8 bank rows (3 degree jitter): the spatially
    coherent batches hier serving is built for (`tests/test_hier.py:40`)."""
    rng = np.random.default_rng(seed)
    qi = np.repeat(rng.integers(0, 2000, 8), B // 8)
    c = np.asarray(locs)[qi] + rng.normal(0, 3.0, (B, 2))
    c[:, 0] = (c[:, 0] + 180) % 360 - 180
    c[:, 1] = np.clip(c[:, 1], -89.9, 89.9)
    return c.astype(np.float32)


@pytest.fixture(scope="module")
def flagship_cache(tmp_path_factory):
    """The JAX bank and its flagship HierBank, built once by JAX's
    `load_model` and saved as the hier cache that both tower modes load."""
    jbank = JaxGeoBank.synthetic_informative(5, 3000, key_dim=256, value_dim=128,
                                             pad_to=512, value_dtype=jnp.bfloat16)
    cache = str(tmp_path_factory.mktemp("flagship") / "hb.npz")
    range_tpu.load_model("RANGE+", db_path=jbank, profile="flagship", k_tiles=4, k_geo=2,
                         hier_cache=cache, **SMALL)
    return jbank, cache


@pytest.mark.parametrize("tower_matmul", [None, "bf16"])
def test_flagship_matches_jax(flagship_cache, tower_matmul):
    """JAX builds the HierBank and saves it as its hier cache (once, for both
    tower modes); the port's `load_model` with the same bank, knobs and
    cache path loads that archive
    (the build signatures are equal) and serves through the same scan,
    selection, parts and combine.  k_tiles / k_geo are cut so that the
    selection keeps 12 / 6 of 24 tiles at B = 256 (the 3x small-batch
    widening applies on both sides).

    Tolerance: f32 tower and retrieval, summed in other orders (~1e-6),
    amplified where a bf16-rounded exp rounds the other way (2^-8 of one
    term); 2e-4 on outputs of size ~0.5.  With the bf16 tower the operand
    rounding points are the same but an f32 sum near a bf16 tie rounds the
    other way, moving the tower output by up to 2e-2 (tests/test_torch_sh.py),
    so the query part is held to 2e-2 and the retrieved part, a softmax of
    those queries, to 5e-2."""
    jbank, cache = flagship_cache
    sig = th.peek_hier_build(cache)
    kw = dict(profile="flagship", k_tiles=4, k_geo=2, hier_cache=cache,
              tower_matmul=tower_matmul, **SMALL)
    jenc = range_tpu.load_model("RANGE+", db_path=jbank, **kw)
    bank = geobank_from_arrays(jbank.locs_lonlat, jbank.xyz, jbank.keys_sem,
                               jbank.values, jbank.n_valid)
    enc = load_model("RANGE+", db_path=bank, device="cpu", **kw)
    enc.model.query_encoder.nnet.load_state_dict(siren_params_from_jax(jenc.params))
    assert th.peek_hier_build(cache) == sig  # loaded, not rebuilt
    hb = enc.model.bank
    assert isinstance(hb, th.HierBank) and hb.t_real == 24
    np.testing.assert_array_equal(hb.k_cat.float().numpy(),
                                  np.asarray(jenc.extra.k_cat, np.float32))
    coords = _regional_coords(jbank.locs_lonlat, 256, seed=1)
    j = np.asarray(jenc(jnp.asarray(coords)))
    t = enc(coords).numpy()
    assert t.shape == j.shape == (256, 384)
    q_atol, r_atol = (2e-4, 2e-4) if tower_matmul is None else (2e-2, 5e-2)
    np.testing.assert_allclose(t[:, 128:], j[:, 128:], rtol=0, atol=q_atol)
    np.testing.assert_allclose(t[:, :128], j[:, :128], rtol=0, atol=r_atol)


def test_port_build_serves_within_fidelity_bars():
    """The port's own build of its own informative bank, served with the
    flagship profile, against the exact f32 dense `retrieve` over the same
    rows: relerr (denominator max(|ref|, 0.1), `bench.py:182-192`) mean
    <= 0.04 and p99 <= 0.165.  12,000 rows make 94 tiles; at B = 2,048 the
    1.5x widening selects 48 sem and 24 geo tiles per block of 128."""
    bank = GeoBank.synthetic_informative(0, 12_000, value_dim=128, pad_to=512,
                                         value_dtype=torch.bfloat16, device="cpu")
    enc = load_model("RANGE+", db_path=bank, device="cpu", profile="flagship",
                     **SMALL)
    hb = enc.model.bank
    assert hb.t_real == 94 and enc.model.config.hier_plan(2048) == (128, 48, 24, 4)
    coords = _regional_coords(bank.locs_lonlat, 2048, seed=0)
    out = enc(coords)
    assert out.shape == (2048, 384) and torch.isfinite(out).all()
    ref = retrieval.retrieve(out[:, 128:], lonlat_deg_to_xyz(torch.from_numpy(coords)),
                             hb.bank)
    rel = (out[:, :128] - ref).abs() / ref.abs().clamp_min(0.1)
    assert rel.mean() <= 0.04 and torch.quantile(rel.flatten(), 0.99) <= 0.165


def test_turbo_profile_and_dense_fallback():
    """turbo runs the same kernels with smaller budgets; hier_min_batch
    sends smaller batches to the dense exact path over the same rows."""
    assert SERVING_PROFILES["turbo"]["k_tiles"] == 8
    bank = GeoBank.synthetic_informative(1, 3000, value_dim=128, pad_to=512,
                                         value_dtype=torch.bfloat16, device="cpu")
    coords = _regional_coords(bank.locs_lonlat, 64, seed=2)
    turbo = load_model("RANGE+", db_path=bank, device="cpu", profile="turbo", **SMALL)
    out = turbo(coords)
    assert out.shape == (64, 384) and torch.isfinite(out).all()
    exact = load_model("RANGE+", db_path=turbo.model.bank, device="cpu",
                       profile="turbo", hier_min_batch=100, **SMALL)
    ref = retrieval.retrieve(out[:, 128:], lonlat_deg_to_xyz(torch.from_numpy(coords)),
                             turbo.model.bank.bank)
    torch.testing.assert_close(exact(coords)[:, :128], ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,plan", [
    (1, (128, 96, 48, 5)), (2047, (128, 96, 48, 5)), (2048, (128, 48, 24, 4)),
    (8192, (128, 32, 16, 3)), (10_000, (128, 32, 16, 3)),
    (40_960, (256, 32, 16, 3))])
def test_hier_plan_copies_the_jax_heuristic(B, plan):
    """bm = min(hier_bm, max(128, B // 40 // 128 * 128)) and the small-batch
    widening (`range_tpu/models/range_encoder.py:161-175`), flagship knobs."""
    cfg = RangeConfig(retrieval="hier", k_tiles=32, k_geo=16, j_sem=3)
    assert cfg.hier_plan(B) == plan


@pytest.mark.parametrize("kw,error", [
    # RANGE mode without the low-rank sem tail (kernel 15's plain variant)
    # serves: None = no error
    (dict(profile="flagship", mode_range=True, lr_rank=0), None),
    # the sel_lr sketch, tile-list dedup and the rescue serve (the
    # flagship's budgets over a 512-row bank without its Dv-wide eigen
    # bases: the knob's path, not the build's cost, is under test)
    (dict(profile="flagship", sel_lr=64, **CHEAP), None),
    # tail_super serves RANGE+ only (the family-split path)
    (dict(profile="flagship", mode_range=True, tail_super=64), ValueError),
    (dict(profile="flagship", dedup=2, **CHEAP), None),
    (dict(profile="flagship", adaptive_frac=0.1, **CHEAP), None),
    # gsz_super and the flagship's topk_gsz both feed hier_topk's selection
    (dict(profile="flagship", gsz_super=64), ValueError),
    (dict(profile="flagship", mesh=object()), NotImplementedError),
    (dict(profile="flagship", k_tile=32), TypeError),
    # the two-level feature path's M is a knob (unused on one-level banks)
    (dict(profile="flagship", m_tiles=32, **CHEAP), None),
    (dict(profile="flagship", hier_scan_bm=512), TypeError),
], ids=["range_mode", "sel_lr", "tail_super", "dedup", "adaptive_frac",
        "gsz_super", "mesh", "unknown_kwarg", "two_level_knob",
        "tpu_speed_knob"])
def test_hier_error_contract(kw, error):
    """Every knob off the ported path, and every knob combination the JAX
    package refuses, raises before any bank is built; a knob set on the
    ported path (error None) serves finite [B, 1280] answers."""
    name = "RANGE" if kw.pop("mode_range", False) else "RANGE+"
    if error is None:
        enc = load_model(name, db_path="synthetic:100", device="cpu", **kw)
        rng = np.random.default_rng(0)
        coords = np.stack([rng.uniform(-180, 180, 8), rng.uniform(-80, 80, 8)], 1)
        out = enc(coords.astype(np.float32))
        assert out.shape == (8, 1280) and torch.isfinite(out).all()
        return
    with pytest.raises(error):
        load_model(name, db_path="synthetic:100", device="cpu", **kw)


def test_retrieve_hier_rejects_unported_banks_and_modes():
    """Banks without res_rank / lr_geo, and RANGE mode without lr_rank,
    serve (the family-split value shapes and the merged kernel's plain
    variant); a bank whose sel_lr is set without its sketch serves as the
    plain bank (JAX's use_sel); unknown modes raise."""
    bank = GeoBank.synthetic_informative(2, 1000, value_dim=128, pad_to=512,
                                         device="cpu")
    hb = th.build_hier_bank(bank, bn=128, gsz_sem=16, gsz_geo=16, lr_rank=128)
    q = torch.nn.functional.normalize(torch.randn(8, 256), dim=1)
    x = lonlat_deg_to_xyz(torch.zeros(8, 2))
    assert th.retrieve_hier(q, x, hb, bm=128).shape == (8, 128)
    assert th.retrieve_hier(q, x, hb, k_geo=4, bm=128).shape == (8, 128)
    assert th.retrieve_hier(q, None, hb, mode="range", bm=128).shape == (8, 128)
    no_lr = dataclasses.replace(hb, lr_rank=0, g_sem_vw_lr=None)
    out = th.retrieve_hier(q, None, no_lr, mode="range", bm=128)
    assert out.shape == (8, 128) and torch.isfinite(out).all()
    assert torch.equal(th.retrieve_hier(q, x, dataclasses.replace(hb, sel_lr=32), bm=128),
                       th.retrieve_hier(q, x, hb, bm=128))
    with pytest.raises(ValueError, match="mode"):
        th.retrieve_hier(q, x, hb, mode="dense")
