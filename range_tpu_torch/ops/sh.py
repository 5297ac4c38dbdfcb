"""Real spherical harmonics and the fused SatCLIP tower, in PyTorch.

Counterpart of `range_tpu/ops/sh.py`.  The numpy plans (`_sh_plan`,
`_sh_times_plan`, `_sh_fourier_plan`) are copied verbatim from the JAX
module (`ops/sh.py:122-305`): the JAX module imports jax, so the port
cannot import them from there.  Conventions are the JAX module's:
``phi = deg2rad(lon + 180)``, ``theta = deg2rad(lat + 90)``, basis columns
stacked in (l, m) order, l = 0..L-1, m = -l..l.

Two kernel wrappers, each an `autograd.Function` whose backward is the
plain compose, as the JAX package's `custom_vjp`s are:

- `spherical_harmonics_times_fused`: basis @ W0 (SH Fourier synthesis ->
  two folded products), the training path's first layer.  CUDA tensor:
  `csrc/sh_times.cu`; CPU tensor: `_sh_times_plain`.
- `siren_tower`: the whole SatCLIP tower (the same first layer -> every
  SIREN layer), the serving path.  CUDA tensor: `csrc/siren_tower_sm90.cu`
  in the bf16 mode (wgmma), `csrc/siren_tower.cu` in the f32 mode (f32
  FMAs); CPU tensor: `_siren_tower_plain`.

The kernels' weight layouts (the fold, the casts, the swizzled bf16 tiles)
are built once per parameter update (`ops._prep.prepared`), not per call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from ._prep import prepared, swizzle128

# ---------------------------------------------------------------------------
# numpy plans (verbatim from range_tpu/ops/sh.py:122-305)


@functools.lru_cache(maxsize=16)
def _sh_plan(L: int, convention: str):
    """Static (numpy) coefficient tables for the vectorized evaluation.

    The recurrence is iterated over the diagonal offset k = l - m, all m
    columns in parallel: P[k] is the [M] vector (Pbar_{m+k, m})_m.
    """
    ms = np.arange(L, dtype=np.float64)
    # diag constants d_m: Pbar_mm = d_m * s^m
    d = np.full(L, 1.0 / math.sqrt(4 * math.pi))
    for m in range(1, L):
        d[m] = d[m - 1] * math.sqrt((2 * m + 1) / (2 * m))
    # off-diag: Pbar_{m+1,m} = e_m * x * Pbar_mm
    e = np.sqrt(2 * ms + 3)
    # general term coefficients per k >= 2 (l = m + k):
    #   Pbar_{l,m} = a[k,m] * (x * Pbar_{l-1,m} - b[k,m] * Pbar_{l-2,m})
    a = np.zeros((L, L))
    b = np.zeros((L, L))
    for k in range(2, L):
        for m in range(0, L - k):
            l = m + k
            a[k, m] = math.sqrt((4 * l * l - 1) / (l * l - m * m))
            b[k, m] = math.sqrt(((l - 1) ** 2 - m * m) / (4 * (l - 1) ** 2 - 1))
    # output assembly: column j (l, m order) reads P_flat[:, k*L + |m|]
    gather = np.zeros(L * L, np.int32)
    trig_sel = np.zeros(L * L, np.int32)  # 0: const, 1: cos, 2: sin
    m_sel = np.zeros(L * L, np.int32)
    scale = np.zeros(L * L)
    sqrt2 = math.sqrt(2.0)
    j = 0
    for l in range(L):
        for m in range(-l, l + 1):
            am = abs(m)
            k = l - am
            gather[j] = k * L + am
            m_sel[j] = am
            if convention == "analytic":
                sign, m0_scale = 1.0, math.pi
            else:
                sign, m0_scale = (-1.0) ** am, 1.0
            if m == 0:
                trig_sel[j] = 0
                scale[j] = m0_scale
            elif m > 0:
                trig_sel[j] = 1
                scale[j] = sign * sqrt2
            else:
                trig_sel[j] = 2
                scale[j] = sign * sqrt2
            j += 1
    return d, e, a, b, gather, trig_sel, m_sel, scale


@functools.lru_cache(maxsize=8)
def _sh_times_plan(L: int, convention: str):
    """Static scatter indices for the gather-free fused `basis @ W` path:
    per trig class, the P_flat column p each output column j reads, and
    the scale to fold into W's row j.

    TWO classes, not three: the const class (m = 0, trig factor 1) folds
    into the cos class exactly — cos(0*phi) = 1 — and their scatter
    targets cannot collide (const reads p = k*L + 0, cos reads
    p = k*L + m with m >= 1)."""
    _, _, _, _, gather, trig_sel, _, scale = _sh_plan(L, convention)
    out = []
    for classes in ((0, 1), (2,)):
        j_idx = np.nonzero(np.isin(trig_sel, classes))[0].astype(np.int32)
        out.append((j_idx, gather[j_idx].astype(np.int32),
                    scale[j_idx].copy()))
    return out


@functools.lru_cache(maxsize=8)
def _sh_fourier_plan(L: int) -> np.ndarray:
    """[2L, L*L] trig-synthesis table replacing the sequential recurrence:

        P_flat[:, p] = sum_j cos(j th) * ftab[j, p] + sin(j th) * ftab[L+j, p]

    Every fully-normalized Pbar_{m+k,m}(cos th) is a finite trigonometric
    polynomial of degree <= l in th, so the whole [B, L*L] P_flat block is
    one [B, 2L] @ [2L, L*L] matmul.  Coefficients come from an exact DFT of
    the f64 recurrence sampled on the full circle.  Convention-independent.
    """
    _, _, a_np, b_np, _, _, _, _ = _sh_plan(L, "analytic")
    N = 4 * L
    th = 2 * np.pi * np.arange(N) / N
    x, s = np.cos(th), np.sin(th)
    d = np.full(L, 1.0 / math.sqrt(4 * math.pi))
    for m in range(1, L):
        d[m] = d[m - 1] * math.sqrt((2 * m + 1) / (2 * m))
    e = np.sqrt(2 * np.arange(L) + 3.0)
    spow = s[:, None] ** np.arange(L)[None, :]
    rows = [d * spow, e * x[:, None] * (d * spow)]
    for k in range(2, L):
        rows.append(a_np[k] * (x[:, None] * rows[-1] - b_np[k] * rows[-2]))
    P = np.concatenate(rows, axis=1)          # [N, L*L], col p = k*L + m
    P[:, 2 * L - 1] = 0.0  # k=1 junk column (m = L-1, never gathered):
    #                        degree L would break the bandlimit below
    F = np.fft.rfft(P, axis=0) / N
    if np.abs(F[L:]).max() >= 1e-9:
        raise ValueError(
            f"SH Fourier plan: spectral tail {np.abs(F[L:]).max():.3g} at "
            f"L={L} — recurrence not bandlimited; the generated table "
            "would be wrong")
    ftab = np.zeros((2 * L, L * L))
    ftab[0] = F[0].real
    ftab[1:L] = 2 * F[1:L].real               # cos(j th) coefficients
    ftab[L + 1:2 * L] = -2 * F[1:L].imag      # sin(j th) coefficients
    return ftab


# ---------------------------------------------------------------------------
# plain basis and basis @ W


def _check_convention(convention: str) -> None:
    if convention not in ("analytic", "closed-form"):
        raise ValueError(f"unknown SH convention: {convention}")


def _angles(lonlat_deg: torch.Tensor):
    phi = (lonlat_deg[..., 0] + 180.0) * (math.pi / 180.0)
    theta = (lonlat_deg[..., 1] + 90.0) * (math.pi / 180.0)
    return phi, theta


def spherical_harmonics_basis(lonlat_deg: torch.Tensor, L: int,
                              convention: str = "analytic") -> torch.Tensor:
    """Real-SH basis of degree < L at (lon, lat) degrees: [B, 2] -> [B, L*L].

    The normalized-Legendre recurrence runs over the diagonal offset
    k = l - m with all orders m in parallel, then one gather + trig multiply
    assembles the (l, m)-ordered output (`range_tpu/ops/sh.py:178`)."""
    _check_convention(convention)
    dtype, dev = lonlat_deg.dtype, lonlat_deg.device
    d_np, e_np, a_np, b_np, gather, trig_sel, m_sel, scale = _sh_plan(
        L, convention)
    phi, theta = _angles(lonlat_deg)
    x = torch.cos(theta)[:, None]
    s = torch.sin(theta)[:, None]
    d = torch.as_tensor(d_np, dtype=dtype, device=dev)
    e = torch.as_tensor(e_np, dtype=dtype, device=dev)
    # s^m via cumprod (no log(0) at the poles): [B, L]
    s_pows = torch.cumprod(
        torch.cat([torch.ones_like(s), s.repeat(1, L - 1)], 1), 1)
    rows = [d * s_pows]
    rows.append(e * x * rows[0])
    for k in range(2, L):
        a_k = torch.as_tensor(a_np[k], dtype=dtype, device=dev)
        b_k = torch.as_tensor(b_np[k], dtype=dtype, device=dev)
        rows.append(a_k * (x * rows[-1] - b_k * rows[-2]))
    P_flat = torch.cat(rows, dim=-1)  # [B, L*L], col k*L + m

    m_arr = torch.arange(L, dtype=dtype, device=dev)
    ang = phi[:, None] * m_arr
    Pg = P_flat[:, torch.as_tensor(gather, dtype=torch.long, device=dev)]
    msel = torch.as_tensor(m_sel, dtype=torch.long, device=dev)
    cg = torch.cos(ang)[:, msel]
    sg = torch.sin(ang)[:, msel]
    tsel = torch.as_tensor(trig_sel, device=dev)
    trig = torch.where(tsel == 0, torch.ones_like(cg),
                       torch.where(tsel == 1, cg, sg))
    return Pg * trig * torch.as_tensor(scale, dtype=dtype, device=dev)


def _fourier_synthesis_inputs(lonlat_deg: torch.Tensor, L: int):
    """(fth [B, 2L] = [cos j th | sin j th], cos(m phi) [B, L],
    sin(m phi) [B, L])."""
    phi, theta = _angles(lonlat_deg)
    j_arr = torch.arange(L, dtype=lonlat_deg.dtype, device=lonlat_deg.device)
    angt = theta[:, None] * j_arr
    ang = phi[:, None] * j_arr
    fth = torch.cat([torch.cos(angt), torch.sin(angt)], dim=1)
    return fth, torch.cos(ang), torch.sin(ang)


# The plans as tensors, cached per device so that a call copies nothing from
# the host (a host-to-device copy would stall the caller on every request).
# Built outside inference mode whatever the caller's mode (serving runs
# under it): a cached inference tensor would break autograd for every later
# caller that trains.
@functools.lru_cache(maxsize=32)
def _fourier_table(L: int, dtype: torch.dtype, device: torch.device,
                   transposed: bool = False) -> torch.Tensor:
    """`_sh_fourier_plan(L)` ([2L, L*L], or its transpose) on ``device``."""
    t = _sh_fourier_plan(L)
    with torch.inference_mode(False):
        return torch.as_tensor(np.ascontiguousarray(t.T if transposed else t),
                               dtype=dtype, device=device)


@functools.lru_cache(maxsize=32)
def _fold_index(L: int, convention: str, device: torch.device):
    """`_sh_times_plan` as (j, p, scale) tensors on ``device``."""
    with torch.inference_mode(False):
        return [(torch.as_tensor(j_idx, dtype=torch.long, device=device),
                 torch.as_tensor(p_idx, dtype=torch.long, device=device),
                 torch.as_tensor(sc, dtype=torch.float64, device=device))
                for j_idx, p_idx, sc in _sh_times_plan(L, convention)]


def _fold_first_layer(w: torch.Tensor, L: int, convention: str,
                      dtype: torch.dtype):
    """Scatter-fold W0 [L*L, H] into P_flat coordinates, one [L*L, H]
    matrix per trig class (cos-with-const, sin) — `_sh_times_plan`."""
    out = []
    for j_t, p_t, sc_t in _fold_index(L, convention, w.device):
        wf = torch.zeros((L * L, w.shape[1]), dtype=dtype, device=w.device)
        wf[p_t] = sc_t.to(dtype)[:, None] * w[j_t].to(dtype)
        out.append(wf)
    return out


def spherical_harmonics_times(lonlat_deg: torch.Tensor, L: int,
                              w: torch.Tensor, convention: str = "analytic",
                              matmul_dtype=None) -> torch.Tensor:
    """``spherical_harmonics_basis(lonlat_deg, L, convention) @ w`` without
    materializing the [B, L*L] basis (`range_tpu/ops/sh.py:308`):

        basis @ W = (P_flat * cos_tile) @ Wc' + (P_flat * sin_tile) @ Ws'

    with P_flat one Fourier-synthesis matmul.  ``matmul_dtype=bfloat16``
    rounds the folded matmuls' inputs to bf16; the products accumulate in
    f32 (the operands are upcast before `torch.matmul`, whose bf16 output
    would otherwise drop the f32 accumulation).  Each folded product is
    rounded to f32 and the sum cast back to the input's dtype, as the JAX
    package's ``preferred_element_type=f32`` does.  Returns [B, D]."""
    _check_convention(convention)
    dtype = lonlat_deg.dtype
    fth, cosm, sinm = _fourier_synthesis_inputs(lonlat_deg, L)
    P_flat = fth @ _fourier_table(L, dtype, lonlat_deg.device)
    trig_tiles = (cosm.repeat(1, L), sinm.repeat(1, L))
    acc = dtype if dtype == torch.float64 else torch.float32
    out = None
    for cls, wf in enumerate(_fold_first_layer(w, L, convention, w.dtype)):
        lhs = P_flat * trig_tiles[cls]
        if matmul_dtype is not None:
            lhs, wf = lhs.to(matmul_dtype), wf.to(matmul_dtype)
        term = (lhs.to(acc) @ wf.to(acc)).to(torch.float32)
        out = term if out is None else out + term
    return out.to(dtype)




# ---------------------------------------------------------------------------
# autograd: a kernel's forward, the plain compose's backward


def _check_matmul_dtype(matmul_dtype) -> None:
    if matmul_dtype not in (None, torch.bfloat16):
        raise ValueError(
            f"matmul_dtype must be None or torch.bfloat16, got {matmul_dtype}")


def _vjp(fn, inputs, needs, g):
    """The gradients of ``fn(*inputs)`` for the upstream gradient ``g``,
    through autograd; None for each input whose ``needs`` is False."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        wanted = [x for x in xs if x.requires_grad]
        grads = iter(torch.autograd.grad(fn(*xs), wanted, g) if wanted else ())
    return tuple(next(grads) if n else None for n in needs)


def _kernel_device(t: torch.Tensor, what: str) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")


# ---------------------------------------------------------------------------
# basis @ W0: the SH-times kernel wrapper + plain version


def _sh_times_plain(lonlat_deg: torch.Tensor, L: int, w: torch.Tensor,
                    convention: str = "analytic", matmul_dtype=None,
                    magnitude: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the SH-times kernel, laid out as the TPU
    kernel computes it (`range_tpu/ops/sh.py:539-562`): the Fourier
    synthesis P = fth @ ftab, the cos/sin(m phi) tiles, two folded
    products.  With ``matmul_dtype=bfloat16`` every matmul operand is
    rounded to bf16, the synthesis inputs ftab and fth included
    (`sh.py:537,547`; `spherical_harmonics_times` leaves those in f32), and
    every product accumulates in the input's float type.
    ``magnitude=True`` gives the same sums over the operands' magnitudes
    (each output's sum of |terms|), for the kernel checks' error bound."""
    _check_convention(convention)
    dtype = lonlat_deg.dtype

    def op(t):  # a matmul operand, rounded as the kernel rounds it
        t = t.to(dtype)
        return t if matmul_dtype is None else t.to(matmul_dtype).to(dtype)

    fth, cosm, sinm = _fourier_synthesis_inputs(lonlat_deg, L)
    P = op(fth) @ op(_fourier_table(L, dtype, lonlat_deg.device))  # [B, L*L]
    terms = [(op(P * trig.repeat(1, L)), op(wf)) for trig, wf in zip(
        (cosm, sinm), _fold_first_layer(w, L, convention, dtype))]
    if magnitude:
        terms = [(a.abs(), b.abs()) for a, b in terms]
    return terms[0][0] @ terms[0][1] + terms[1][0] @ terms[1][1]


def _sh_times_call(lonlat_deg: torch.Tensor, L: int, w: torch.Tensor,
                   convention: str, matmul_dtype) -> torch.Tensor:
    """Launch `csrc/sh_times.cu` on CUDA tensors: [B, 2] f32 -> [B, D] f32."""
    if lonlat_deg.dtype != torch.float32 or lonlat_deg.ndim != 2 \
            or lonlat_deg.shape[1] != 2:
        raise ValueError("spherical_harmonics_times_fused: expected float32 "
                         f"[B, 2] coordinates, got {lonlat_deg.dtype} "
                         f"{tuple(lonlat_deg.shape)}")
    dev = lonlat_deg.device
    D = w.shape[1]
    if w.device != dev or w.ndim != 2 or w.shape[0] != L * L:
        raise ValueError(f"spherical_harmonics_times_fused: w must be [L*L, D]"
                         f" = [{L * L}, D] on {dev}, got {tuple(w.shape)} on "
                         f"{w.device}")
    if D % 32 or not 0 < D <= 512:
        raise ValueError("spherical_harmonics_times_fused kernel: needs D a "
                         f"multiple of 32 up to 512, got D={D}")
    f32 = torch.float32
    ftabT = _fourier_table(L, f32, dev, transposed=True)
    wc, ws = prepared("sh_times", [w], lambda: _fold_first_layer(w, L, convention, f32),
                      (L, convention))
    coords = lonlat_deg.contiguous()
    B = coords.shape[0]
    out = torch.empty((B, D), dtype=f32, device=dev)
    if B == 0:
        return out
    from ..kernels._build import load_kernel_library

    lib = load_kernel_library("sh_times")
    plan = (ctypes.c_int * 2)()  # column slice NC, row splits KS
    rc = lib.sh_times_plan(B, L, D, ctypes.addressof(plan))
    if rc != 0:
        raise RuntimeError(f"sh_times kernel plan failed: CUDA error {rc}")
    nc, ks = plan
    # the row splits' partial sums, added in a fixed order by the kernel's
    # second pass
    work = torch.empty((ks, B, D), dtype=f32, device=dev) if ks > 1 else None
    rc = lib.sh_times_launch(
        coords.data_ptr(), ftabT.data_ptr(), wc.data_ptr(), ws.data_ptr(),
        out.data_ptr(), None if work is None else work.data_ptr(), B, L, D,
        nc, ks, int(matmul_dtype is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sh_times kernel launch failed: CUDA error {rc}")
    spherical_harmonics_times_fused.launches += 1
    return out


class _ShTimes(torch.autograd.Function):
    """Forward: the SH-times kernel (CUDA) or its plain version (CPU).
    Backward: autograd through `spherical_harmonics_times` in the same
    ``matmul_dtype``, as `_sh_times_pallas_bwd` (`range_tpu/ops/sh.py:454`)."""

    @staticmethod
    def forward(ctx, lonlat_deg, w, L, convention, matmul_dtype):
        ctx.save_for_backward(lonlat_deg, w)
        ctx.plan = (L, convention, matmul_dtype)
        if lonlat_deg.device.type == "cpu":
            return _sh_times_plain(lonlat_deg, L, w, convention, matmul_dtype)
        return _sh_times_call(lonlat_deg, L, w, convention, matmul_dtype)

    @staticmethod
    def backward(ctx, g):
        L, convention, md = ctx.plan
        grads = _vjp(lambda ll, ww: spherical_harmonics_times(
            ll, L, ww, convention, matmul_dtype=md), ctx.saved_tensors,
            ctx.needs_input_grad[:2], g)
        return (*grads, None, None, None)


def spherical_harmonics_times_fused(lonlat_deg: torch.Tensor, L: int,
                                    w: torch.Tensor,
                                    convention: str = "analytic",
                                    matmul_dtype=None) -> torch.Tensor:
    """``spherical_harmonics_basis(lonlat_deg, L) @ w`` through the SH-times
    kernel: [B, 2] (lon, lat) degrees, w [L*L, D] -> [B, D].  Counterpart of
    `spherical_harmonics_times_pallas` (`range_tpu/ops/sh.py:426-463`).

    CPU tensor: `_sh_times_plain`.  CUDA tensor: the hand-written kernel
    (`csrc/sh_times.cu`, float32 coordinates, D a multiple of 32 up to 512),
    which replaces the TPU kernel `kern` inside `_sh_times_pallas_impl`
    (`sh.py:539`); a launch failure raises.  Differentiable in
    ``lonlat_deg`` and ``w``: the backward is autograd through the plain
    compose `spherical_harmonics_times`.  L outside 2..64 takes that
    compose for the forward too, as the JAX envelope does (`sh.py:498-503`).
    ``spherical_harmonics_times_fused.launches`` counts kernel launches."""
    _check_convention(convention)
    _check_matmul_dtype(matmul_dtype)
    _kernel_device(lonlat_deg, "spherical_harmonics_times_fused")
    if not 2 <= L <= 64:  # the JAX envelope (`sh.py:498-503`)
        return spherical_harmonics_times(lonlat_deg, L, w, convention,
                                         matmul_dtype=matmul_dtype)
    return _ShTimes.apply(lonlat_deg, w, L, convention, matmul_dtype)


spherical_harmonics_times_fused.launches = 0


# ---------------------------------------------------------------------------
# the SatCLIP tower: kernel wrapper + plain version


def _tower_biases(params, H: int, D: int, dtype, device):
    zeros = functools.partial(torch.zeros, dtype=dtype, device=device)
    rows = [layer["b"].to(dtype) if "b" in layer else zeros(H)
            for layer in params["layers"]]
    last = params["last"]
    rows.append(last["b"].to(dtype) if "b" in last else zeros(D))
    return rows


def _siren_tower_plain(lonlat_deg: torch.Tensor, L: int, params,
                       convention: str = "analytic", matmul_dtype=None,
                       w0_initial: float = 30.0,
                       w0: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of the tower kernel, laid out as the TPU kernel
    computes it (`range_tpu/ops/sh.py:726-751`): the SH-times first layer
    (`_sh_times_plain`), sin(w0_initial * (h + b0)), the hidden layers, the
    output layer.  With ``matmul_dtype=bfloat16`` every matmul operand is
    rounded to bf16, as the TPU kernel rounds them, and every product still
    accumulates in the input's float type."""
    _check_convention(convention)
    dtype = lonlat_deg.dtype
    layers, last = params["layers"], params["last"]
    H, D = layers[0]["w"].shape[1], last["w"].shape[1]

    def op(t):  # a matmul operand, rounded as the kernel rounds it
        t = t.to(dtype)
        return t if matmul_dtype is None else t.to(matmul_dtype).to(dtype)

    h = _sh_times_plain(lonlat_deg, L, layers[0]["w"], convention, matmul_dtype)
    biases = _tower_biases(params, H, D, dtype, lonlat_deg.device)
    x = torch.sin(w0_initial * (h + biases[0]))
    for layer, b in zip(layers[1:], biases[1:-1]):
        x = torch.sin(w0 * (op(x) @ op(layer["w"]) + b))
    return op(x) @ op(last["w"]) + biases[-1]


def _siren_tower_ref(lonlat_deg: torch.Tensor, L: int, params,
                     convention: str = "analytic", matmul_dtype=None,
                     w0_initial: float = 30.0, w0: float = 1.0) -> torch.Tensor:
    """The compose the tower's backward differentiates, as `_siren_tower_ref`
    (`range_tpu/ops/sh.py:630-646`): `spherical_harmonics_times` in
    ``matmul_dtype``, then the SIREN layers in the input's float type (only
    the first layer's operands round to bf16, unlike `_siren_tower_plain`)."""
    layers, last = params["layers"], params["last"]
    x = spherical_harmonics_times(lonlat_deg, L, layers[0]["w"], convention,
                                  matmul_dtype=matmul_dtype)
    if "b" in layers[0]:
        x = x + layers[0]["b"]
    x = torch.sin(w0_initial * x)
    for layer in layers[1:]:
        h = x @ layer["w"]
        x = torch.sin(w0 * (h + layer["b"] if "b" in layer else h))
    out = x @ last["w"]
    return out + last["b"] if "b" in last else out


def _tower_sources(params):
    """Every parameter tensor of the tower, the last layer last."""
    return [t for e in list(params["layers"]) + [params["last"]]
            for _, t in sorted(e.items())]


@torch.no_grad()
def _tower_f32(L: int, params, convention: str):
    """`csrc/siren_tower.cu`'s f32 operands: ftabT, the folded wc / ws, the
    stacked hidden weights, the last layer's and the biases."""
    layers, last = params["layers"], params["last"]
    H, D = layers[0]["w"].shape[1], last["w"].shape[1]
    dev, f32 = layers[0]["w"].device, torch.float32
    wc, ws = _fold_first_layer(layers[0]["w"], L, convention, f32)
    n_deep = len(layers) - 1
    deep = (torch.stack([layer["w"].to(f32) for layer in layers[1:]])
            if n_deep else torch.zeros((1, H, H), dtype=f32, device=dev))
    return (_fourier_table(L, f32, dev, transposed=True), wc, ws, deep,
            last["w"].to(f32).contiguous(),
            torch.stack(_tower_biases(params, H, D, f32, dev)))


def _tower_shape(L: int, H: int):
    """(Lq, KS, KB2, KC) of `csrc/siren_tower_sm90.cu`: P's columns (L
    rounded up to 16), a recurrence row's first-layer depth (cos | sin),
    the 64-column boxes of the synthesis depth, the weight rows of a
    further layer's chunk."""
    lq = 16 * ((L + 15) // 16)
    ks = 2 * lq
    return lq, ks, (ks + 63) // 64, ks if ks % 64 == 0 or ks == 32 else 64


def _tower_plan(B: int, L: int, H: int) -> dict:
    """The bf16 tower kernel's launch at (B, L, H), as its `Shape` lays it
    out: its consumer warpgroups (two, of 64 queries each, where their
    shared-memory regions fit beside the rings; else one), blocks, threads
    (and a producer warpgroup), dynamic shared memory, the stages of each of its
    two rings (the Fourier slabs', the weights') and their bytes; chunks
    of a further layer.  Checked against the kernel's
    `siren_tower_sm90_smem` on the card."""
    lq, ks, kb2, kc = _tower_shape(L, H)
    ns, bm, smem_max = 2, 64, 232_448
    ft_bytes, w1_bytes = kb2 * lq * 128, ks * H * 2
    trig = kb2 * bm * 128
    wg_bytes = -(-max(trig + bm * (lq // 2 + 1) * 16, (H // 64) * bm * 128) // 1024) * 1024
    fixed = ns * (ft_bytes + w1_bytes) + 32 * ns + 1024
    wgs = 2 if fixed + 2 * wg_bytes <= smem_max else 1
    rows = bm * wgs
    return dict(warpgroups=wgs, grid=(B + rows - 1) // rows, threads=128 * wgs + 128,
                smem=fixed + wgs * wg_bytes, stages=ns, stage_bytes=(ft_bytes, w1_bytes),
                lq=lq, ks=ks, kc=kc, chunks=H // kc)


@torch.no_grad()
def _tower_images(L: int, params, convention: str):
    """`csrc/siren_tower_sm90.cu`'s operands, each stage one contiguous
    image of swizzled bf16 tiles: (ftab [L, KB2, Lq, 64]: row k's Fourier
    slab, K-major, B[r][j] = ftab[j][kL + r] with cos j in columns j < L and
    sin j in Lq + j; w1 [L, H / 64, KS, 64]: row k's folded first layer
    [wc rows kL..kL+L | zeros | ws rows | zeros], MN-major; hid [n_deep + 1,
    H / KC, H / 64, KC, 64]: each further layer's [in, out] weights in
    chunks of KC rows, MN-major; bpack [n_deep + 2, H] f32).  Rounded to
    bf16 from the same f32 operands as `_siren_tower_plain`'s."""
    layers, last = params["layers"], params["last"]
    H = layers[0]["w"].shape[1]
    lq, ks, kb2, kc = _tower_shape(L, H)
    dev, f32, bf16 = layers[0]["w"].device, torch.float32, torch.bfloat16
    ftab = _fourier_table(L, f32, dev).reshape(2 * L, L, L)  # [j, k, r]
    T = torch.zeros(L, lq, kb2 * 64, dtype=f32, device=dev)
    T[:, :L, :L] = ftab[:L].permute(1, 2, 0)
    T[:, :L, lq:lq + L] = ftab[L:].permute(1, 2, 0)
    ft = swizzle128(T.to(bf16).reshape(L, lq, kb2, 64).permute(0, 2, 1, 3).contiguous())
    wc, ws = _fold_first_layer(layers[0]["w"], L, convention, f32)
    W1 = torch.zeros(L, ks, H, dtype=f32, device=dev)
    W1[:, :L] = wc.reshape(L, L, H)
    W1[:, lq:lq + L] = ws.reshape(L, L, H)
    w1 = swizzle128(W1.to(bf16).reshape(L, ks, H // 64, 64).permute(0, 2, 1, 3).contiguous())
    hw = torch.stack([layer["w"].to(f32) for layer in layers[1:]] + [last["w"].to(f32)])
    nl = hw.shape[0]
    hid = swizzle128(hw.to(bf16).reshape(nl, H // kc, kc, H // 64, 64)
                      .permute(0, 1, 3, 2, 4).contiguous())
    return ft, w1, hid, torch.stack(_tower_biases(params, H, H, f32, dev))


def _siren_tower_slabs(lonlat_deg: torch.Tensor, L: int, images,
                       w0_initial: float = 30.0, w0: float = 1.0) -> torch.Tensor:
    """Plain version of `csrc/siren_tower_sm90.cu`'s decomposition, read
    from its images (`_tower_images`, unswizzled here): per recurrence row
    k, P_k = bf16(fth) @ the row's Fourier slab (Lq columns), amat =
    bf16([P_k cos m phi | P_k sin m phi]), h += amat @ the row's first-layer
    slab one k16 step at a time (the accumulator's order); then every
    further layer one k16 step at a time.  f32 sums of bf16 operands."""
    ft, w1, hid, bpack = images
    H, f32, bf16 = bpack.shape[1], torch.float32, torch.bfloat16
    lq, ks, kb2, _ = _tower_shape(L, H)
    T = swizzle128(ft).permute(0, 2, 1, 3).reshape(L, lq, kb2 * 64)[:, :, :ks].to(f32)
    W1 = swizzle128(w1).permute(0, 2, 1, 3).reshape(L, ks, H).to(f32)
    nl = hid.shape[0]
    HW = swizzle128(hid).permute(0, 1, 3, 2, 4).reshape(nl, H, H).to(f32)
    phi, theta = _angles(lonlat_deg.to(f32))
    m = torch.arange(lq, dtype=f32, device=lonlat_deg.device)
    keep = (m < L).to(f32)
    fth = torch.cat([torch.cos(theta[:, None] * m) * keep,
                     torch.sin(theta[:, None] * m) * keep], 1).to(bf16).to(f32)
    cosm, sinm = torch.cos(phi[:, None] * m), torch.sin(phi[:, None] * m)

    def steps(x, w):  # x @ w as the accumulator adds it: k16 step by step
        acc = torch.zeros(x.shape[0], w.shape[1], dtype=f32, device=x.device)
        for k0 in range(0, w.shape[0], 16):
            acc = acc + x[:, k0:k0 + 16] @ w[k0:k0 + 16]
        return acc

    h = torch.zeros(lonlat_deg.shape[0], H, dtype=f32, device=lonlat_deg.device)
    for k in range(L):
        P = fth @ T[k].T
        amat = torch.cat([P * cosm, P * sinm], 1).to(bf16).to(f32)
        for k0 in range(0, ks, 16):
            h = h + amat[:, k0:k0 + 16] @ W1[k, k0:k0 + 16]
    x = torch.sin(w0_initial * (h + bpack[0])).to(bf16).to(f32)
    for layer in range(nl - 1):
        x = torch.sin(w0 * (steps(x, HW[layer]) + bpack[layer + 1])).to(bf16).to(f32)
    return steps(x, HW[-1]) + bpack[-1]


def _siren_tower_call(lonlat_deg: torch.Tensor, L: int, params,
                      convention: str, matmul_dtype, w0_initial: float,
                      w0: float) -> torch.Tensor:
    """Launch the tower kernel on CUDA tensors: [B, 2] f32 -> [B, D].  The
    bf16 mode runs `csrc/siren_tower_sm90.cu` (counted in
    ``siren_tower.bf16_launches`` too), the f32 mode `csrc/siren_tower.cu`."""
    layers, last = params["layers"], params["last"]
    if lonlat_deg.dtype != torch.float32 or lonlat_deg.ndim != 2 \
            or lonlat_deg.shape[1] != 2:
        raise ValueError("siren_tower: expected float32 [B, 2] coordinates, "
                         f"got {lonlat_deg.dtype} {tuple(lonlat_deg.shape)}")
    H, D = layers[0]["w"].shape[1], last["w"].shape[1]
    if H != D or H not in (128, 256) or not 2 <= L <= 64:
        raise ValueError(
            f"siren_tower kernel: needs H == D in (128, 256) and 2 <= L <= 64,"
            f" got H={H}, D={D}, L={L}")
    if layers[0]["w"].shape[0] != L * L or any(
            layer["w"].shape != (H, H) for layer in layers[1:]):
        raise ValueError("siren_tower: layer shapes do not match L and H")
    dev = lonlat_deg.device
    coords = lonlat_deg.contiguous()
    B = coords.shape[0]
    out = torch.empty((B, D), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    from ..kernels._build import load_kernel_library

    n_deep = len(layers) - 1
    stream = torch.cuda.current_stream(dev).cuda_stream
    sources = _tower_sources(params)
    if matmul_dtype is not None:
        ft, w1, hid, bpack = prepared(
            "siren_tower_sm90", sources, lambda: _tower_images(L, params, convention),
            (L, convention, n_deep))
        rc = load_kernel_library("siren_tower_sm90").siren_tower_sm90_launch(
            coords.data_ptr(), ft.data_ptr(), w1.data_ptr(), hid.data_ptr(),
            bpack.data_ptr(), out.data_ptr(), B, L, H, n_deep,
            ctypes.c_float(w0_initial), ctypes.c_float(w0), stream)
        if rc != 0:
            raise RuntimeError(f"siren_tower_sm90 kernel launch failed: CUDA error {rc}")
        siren_tower.bf16_launches += 1
    else:
        ftabT, wc, ws, deep, wl, bpack = prepared(
            "siren_tower", sources, lambda: _tower_f32(L, params, convention),
            (L, convention, n_deep))
        rc = load_kernel_library("siren_tower").siren_tower_launch(
            coords.data_ptr(), ftabT.data_ptr(), wc.data_ptr(), ws.data_ptr(),
            bpack.data_ptr(), deep.data_ptr(), wl.data_ptr(), out.data_ptr(),
            B, L, H, n_deep, ctypes.c_float(w0_initial), ctypes.c_float(w0), 0, stream)
        if rc != 0:
            raise RuntimeError(f"siren_tower kernel launch failed: CUDA error {rc}")
    siren_tower.launches += 1
    return out


def _flatten_tower(params):
    """(layout, tensors): the SirenNet params as a flat tuple, and the key
    names of each layer (the last layer last) to rebuild them."""
    entries = list(params["layers"]) + [params["last"]]
    layout = tuple(tuple(sorted(e)) for e in entries)
    return layout, tuple(e[k] for e, keys in zip(entries, layout) for k in keys)


def _unflatten_tower(layout, tensors):
    it = iter(tensors)
    entries = [{k: next(it) for k in keys} for keys in layout]
    return {"layers": entries[:-1], "last": entries[-1]}


class _SirenTower(torch.autograd.Function):
    """Forward: the tower kernel (CUDA) or its plain version (CPU).
    Backward: autograd through `_siren_tower_ref`, as `_siren_tower_bwd`
    (`range_tpu/ops/sh.py:649-658`)."""

    @staticmethod
    def forward(ctx, lonlat_deg, plan, *tensors):
        ctx.save_for_backward(lonlat_deg, *tensors)
        ctx.plan = plan
        L, convention, md, w0_initial, w0, layout = plan
        params = _unflatten_tower(layout, tensors)
        if lonlat_deg.device.type == "cpu":
            return _siren_tower_plain(lonlat_deg, L, params, convention, md,
                                      w0_initial, w0)
        return _siren_tower_call(lonlat_deg, L, params, convention, md,
                                 w0_initial, w0)

    @staticmethod
    def backward(ctx, g):
        L, convention, md, w0_initial, w0, layout = ctx.plan
        needs = (ctx.needs_input_grad[0],) + ctx.needs_input_grad[2:]
        grads = _vjp(lambda ll, *t: _siren_tower_ref(
            ll, L, _unflatten_tower(layout, t), convention, md, w0_initial, w0),
            ctx.saved_tensors, needs, g)
        return (grads[0], None, *grads[1:])


def siren_tower(lonlat_deg: torch.Tensor, L: int, params,
                convention: str = "analytic", matmul_dtype=None,
                w0_initial: float = 30.0, w0: float = 1.0) -> torch.Tensor:
    """The whole SatCLIP tower for [B, 2] (lon, lat) degrees -> [B, D] f32.

    ``params`` is the SirenNet layout of the JAX package
    (``{"layers": [{"w": [in, out], "b": [out]}, ...], "last": {...}}``).
    ``matmul_dtype`` is None (true f32 operands) or ``torch.bfloat16``
    (operands rounded to bf16, f32 accumulation).

    CPU tensor: `_siren_tower_plain`.  CUDA tensor: a hand-written kernel,
    `csrc/siren_tower_sm90.cu` in the bf16 mode (wgmma) and
    `csrc/siren_tower.cu` in the f32 mode, which replace the TPU kernel
    `kern` inside `_siren_tower_impl` (`range_tpu/ops/sh.py:661-782`); a
    launch failure raises.  Differentiable in the coordinates and every
    parameter: the backward is autograd through the plain compose
    `_siren_tower_ref`, as in the JAX package.  ``siren_tower.launches``
    counts kernel launches, ``siren_tower.bf16_launches`` those of the bf16
    mode's kernel."""
    _check_convention(convention)
    _check_matmul_dtype(matmul_dtype)
    _kernel_device(lonlat_deg, "siren_tower")
    layout, tensors = _flatten_tower(params)
    return _SirenTower.apply(
        lonlat_deg, (L, convention, matmul_dtype, w0_initial, w0, layout),
        *tensors)


siren_tower.launches = 0
siren_tower.bf16_launches = 0
