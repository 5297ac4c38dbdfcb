"""Kernel 2's `exact` tier (f32 packed operands) on its Hopper body,
`csrc/fused_retrieval_tf32_sm90.cu`, on the CPU: the logits three TF32
products a term on the tensor cores, the value products bf16.

A CUDA kernel cannot run here, so its arithmetic is held through a plain
version that reads the very keys' image the kernel copies
(`ops.retrieval_fused._fused_tf32_plain`): the same TF32 halves, each
32-deep chunk's products in a fresh fragment truncated toward zero
(`ops._prep.tf32x3_matmul`), the request's segments (`_tf32_plan`) added
in order.  Against range_tpu's `retrieve_pallas(tier="exact")` in
interpret mode, RANGE+ and RANGE, on small numpy-seeded banks (JAX builds
them; the port loads the arrays).  Also: the image read back to the
packed keys, the plan covers the bank, the packed keys and their image are
made once per bank, and the wrapper's check refuses what the launch
refuses before any launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401  (torch's CPU threads under xdist)
from test_torch_hier import _within_terms

from range_tpu.bank.bank import GeoBank as JaxGeoBank
from range_tpu.ops import retrieval_pallas as jrp
from range_tpu_torch.convert.from_jax import geobank_from_arrays
from range_tpu_torch.ops import _prep
from range_tpu_torch.ops import retrieval_fused as trf


@pytest.fixture(scope="module")
def dense():
    """A 700-row bank padded to 1,024 (64-d keys, bf16 96-d values), its
    port twin, and 37 unit queries with their points."""
    jb = JaxGeoBank.synthetic(0, 700, key_dim=64, value_dim=96, pad_to=512)
    jb = JaxGeoBank(locs_lonlat=jb.locs_lonlat, xyz=jb.xyz, keys_sem=jb.keys_sem,
                    values=jb.values.astype(jnp.bfloat16), n_valid=jb.n_valid)
    tb = geobank_from_arrays(jb.locs_lonlat, jb.xyz, jb.keys_sem, jb.values, jb.n_valid)
    rng = np.random.default_rng(3)
    q = rng.standard_normal((37, 64)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    x = rng.standard_normal((37, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return jb, tb, q, x


def _operands(tb, q, x, mode):
    q_cat = trf.pack_queries(torch.from_numpy(q), None if mode == "range" else
                             torch.from_numpy(x), 12.0, 40.0, "exact")
    k_cat = trf.pack_bank(tb.keys_sem, tb.xyz, "exact")
    mask = (trf.NEG * (1.0 - tb.row_mask()))[None, :].to(torch.float32)
    return q_cat, k_cat, mask, trf.packed_dims(64, "exact")[0]


@pytest.mark.parametrize("mode", ["range+", "range"])
def test_tf32_plain_matches_jax(dense, mode):
    """RANGE+ (beta 0.5) and RANGE (beta 1, no geo query) against JAX's fused
    kernel at `exact` in interpret mode (Precision.HIGHEST), and against the
    one-pass plain version: 37 queries, so the plan cuts the bank into
    segments of one tile.  The logits agree to TF32 x3's ~2^-21 of each
    term, so p moves by ~1e-6 of itself and a weight may round to the other
    bf16 neighbour before the value product: each element within one bf16
    ulp of its terms (`_within_terms`, the rule of the hierarchical
    kernels' bf16 weights), most within 2e-5."""
    jb, tb, q, x = dense
    beta = 0.5 if mode == "range+" else 1.0
    j = jrp.retrieve_pallas(jnp.asarray(q), None if mode == "range" else jnp.asarray(x), jb,
                            sem_temp=12.0, beta=beta, mode=mode, tier="exact", bm=16, bn=256,
                            interpret=True)
    q_cat, k_cat, mask, sem_d = _operands(tb, q, x, mode)
    assert trf._tf32_plan(37, k_cat.shape[0], 96) == (16, 64)
    got = trf._fused_tf32_plain(q_cat, k_cat, tb.values, mask, beta, sem_d=sem_d)
    one = trf._retrieve_fused_plain(q_cat, k_cat, tb.values, mask, beta, sem_d=sem_d)
    mag = trf._retrieve_fused_plain(q_cat, k_cat, tb.values.abs(), mask, beta, sem_d=sem_d)
    assert got.shape == (37, 96) and torch.isfinite(got).all()
    for ref in (np.asarray(j), one.numpy()):
        _within_terms(got.numpy(), ref, mag.numpy())
        assert (np.abs(got.numpy() - ref) > 2e-5).mean() < 0.05


def test_tf32_plain_one_segment_and_exact_chain(dense):
    """At a batch that fills the card (one segment of the whole bank) the
    same answer; the chunked chain's truncation stays within f32 of the
    exact sum of the split's products."""
    _, tb, q, x = dense
    q_cat, k_cat, mask, sem_d = _operands(tb, q, x, "range+")
    q_cat = q_cat.repeat(256, 1)  # 9,472 queries: 148 blocks, one segment
    assert trf._tf32_plan(q_cat.shape[0], k_cat.shape[0], 96) == (1, 1024)
    q_cat = q_cat[::256]  # the plain version of its first rows, at that plan
    chunks = trf._fused_tf32_plain(q_cat, k_cat, tb.values, mask, 0.5, sem_d=sem_d)
    exact = trf._fused_tf32_plain(q_cat, k_cat, tb.values, mask, 0.5, sem_d=sem_d,
                                  chain="exact")
    torch.testing.assert_close(chunks, exact, rtol=0, atol=2e-5)


def test_keys_image_reads_back(dense):
    """The image holds each 64-row tile's sem columns in KC chunks and the
    geo block's 16 columns in one more, TF32 halves summing to the packed
    keys (hi + lo within 2^-22 of each), zero past the bank's rows."""
    _, tb, _, _ = dense
    k_cat = trf.pack_bank(tb.keys_sem, tb.xyz, "exact")
    sem_d = trf.packed_dims(64, "exact")[0]
    img = trf._tf32_keys(k_cat, sem_d)
    N, KC = k_cat.shape[0], -(-sem_d // 32)
    assert img.shape == (N // 64, KC + 1, 2, 64, 32)
    hi, lo = _prep.kmajor_tf32_read(img)  # [T, 64, 32 (KC + 1)]
    k = (hi + lo).reshape(N, -1)
    np.testing.assert_allclose(k[:, :sem_d].numpy(), k_cat[:, :sem_d].numpy(), rtol=2 ** -21,
                               atol=0)
    np.testing.assert_allclose(k[:, 32 * KC:32 * KC + 16].numpy(),
                               k_cat[:, sem_d:sem_d + 16].numpy(), rtol=2 ** -21, atol=0)
    assert not k[:, sem_d:32 * KC].any() and not k[:, 32 * KC + 16:].any()
    assert torch.equal(hi, _prep.tf32_rna(hi))
    assert trf._tf32_keys(k_cat, sem_d) is img  # once per bank


@pytest.mark.parametrize("N", [3001, 102_400])
@pytest.mark.parametrize("B", [1, 37, 1000, 10_000])
@pytest.mark.parametrize("Dv", [96, 1024])
def test_tf32_plan_covers_the_bank(B, N, Dv):
    """Whole 64-row tiles a segment, the segments covering the bank once
    (the last ragged), no chain over TF32_SEG_ROWS_MAX rows, and the card's
    SMs given a block each unless every tile is a segment."""
    n_seg, seg_rows = trf._tf32_plan(B, N, Dv)
    assert seg_rows % 64 == 0 and 0 < seg_rows <= trf.TF32_SEG_ROWS_MAX
    segs = [(lo, min(N, lo + seg_rows)) for lo in range(0, N, seg_rows)]
    assert len(segs) == n_seg and segs[-1][1] == N and all(b > a for a, b in segs)
    blocks = -(-B // 64) * -(-Dv // 256)
    assert n_seg * blocks >= trf.SM90_SMS or seg_rows == 64


def test_packed_keys_made_once_per_bank(dense):
    """On the card (`_bank_keys(card=True)`, which `_packed` asks for) a
    bank's packed keys and mask are made once and reused while its tensors
    are unchanged, and repacked after an in-place update; the CPU path
    packs a request's own, as JAX does."""
    _, tb, _, _ = dense
    a = trf._bank_keys(tb, "exact", True)
    b = trf._bank_keys(tb, "exact", True)
    assert a[0] is b[0] and a[1] is b[1]
    torch.testing.assert_close(a[0], trf.pack_bank(tb.keys_sem, tb.xyz, "exact", True))
    tb.keys_sem.mul_(1.0)  # an in-place update: a new version
    c = trf._bank_keys(tb, "exact", True)
    assert c[0] is not a[0] and torch.equal(c[1], a[1])
    assert trf._bank_keys(tb, "exact", False)[0] is not trf._bank_keys(tb, "exact", False)[0]


def test_launch_refuses_before_any_launch(dense):
    """The wrapper raises ValueError, with nothing launched, on what the
    launch refuses: values other than bf16, semantic columns past 1,536;
    the shared check (`_check_fused`) on mismatched or misaligned
    operands, as for the mma.sync body, which took the same shapes."""
    _, tb, q, x = dense
    q_cat, k_cat, mask, sem_d = _operands(tb, q, x, "range+")
    with pytest.raises(ValueError, match="bf16 values"):
        trf._launch_tf32(q_cat, k_cat, tb.values.float(), mask, 0.5, sem_d)
    wide = torch.zeros((2, 1664), dtype=torch.float32)
    with pytest.raises(ValueError, match="sem_d"):
        trf._launch_tf32(wide, torch.zeros((64, 1664)), tb.values[:64], mask[:, :64], 0.5,
                         1568)
    with pytest.raises(ValueError):
        trf._check_fused("retrieve_fused", q_cat, k_cat[:, :-8], tb.values, mask, sem_d)
    with pytest.raises(ValueError):
        trf._check_fused("retrieve_fused", q_cat, k_cat, tb.values, mask, sem_d + 8)
