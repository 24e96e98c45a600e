"""MMSE / ZF equalization weights and their application (port of `srsran_projectvtlmo_tpu.ops.equalization`).

The slot's channel estimate is constant over the data symbols, so weights are
computed once per subcarrier.  MMSE: L = 1 uses the reference's SIMO closed
form (equalize_mmse_1xn.h:44-96), L = 2 a closed-form 2x2 hermitian inverse
in real arithmetic, L = 3-4 a batched complex inverse.  ZF: the SIMO closed
form (equalize_zf_1xn.h:43-96), a 2x2 adjugate, a batched inverse.  The
per-RE forms (`equalize_*`) serve the unit tests, as in the JAX package.
Products are elementwise complex64/float32 with explicit sums; no matrix
product goes through TF32.
"""

from __future__ import annotations

import torch

from ..utils.cplx import from_cplx, to_cplx


def mmse_weights(h_pair: torch.Tensor, noise_var_port: torch.Tensor, tx_scaling: float = 1.0):
    """MMSE weights with noise whitening and bias correction folded in.

    h_pair: (..., S, P, L, 2) channel estimates; noise_var_port: (..., P).
    Returns (w_pair (..., S, L, P, 2) with symbols = w @ y,
    nvar_out (..., S, L) post-equalization noise, +inf where degenerate).
    """
    nlayers = h_pair.shape[-2]
    nvar = noise_var_port[..., None, :]  # (..., 1, P)
    hr = h_pair[..., 0] * tx_scaling  # (..., S, P, L)
    hi = h_pair[..., 1] * tx_scaling

    if nlayers == 1:
        hr0, hi0 = hr[..., 0], hi[..., 0]
        ch_norm = hr0 * hr0 + hi0 * hi0
        ok = torch.isfinite(ch_norm) & (ch_norm > 0) & torch.isfinite(nvar) & (nvar > 0)
        ch_norm = torch.where(ok, ch_norm, 0.0)
        c = ch_norm.sum(dim=-1)
        nvar_acc = (ch_norm * torch.where(ok, nvar, 0.0)).sum(dim=-1)
        denom = c * c + nvar_acc
        good = torch.isfinite(c) & (c > 0) & torch.isfinite(nvar_acc) & (nvar_acc > 0)
        safe = torch.where(good, denom, 1.0)
        scale = torch.where(good, c / safe, 0.0)
        wr = torch.where(ok, hr0, 0.0) * scale[..., None]
        wi = torch.where(ok, -hi0, 0.0) * scale[..., None]
        nvars = torch.where(good, nvar_acc / safe, float("inf"))
        return torch.stack([wr[..., None, :], wi[..., None, :]], dim=-1), nvars[..., None]

    if nlayers == 2:
        ninv = 1.0 / torch.clamp(nvar, min=1e-38)
        h0r, h0i, h1r, h1i = hr[..., 0], hi[..., 0], hr[..., 1], hi[..., 1]
        # A = H^H N^-1 H + I (hermitian 2x2, real diagonal).
        a00 = ((h0r * h0r + h0i * h0i) * ninv).sum(dim=-1) + 1.0
        a11 = ((h1r * h1r + h1i * h1i) * ninv).sum(dim=-1) + 1.0
        a01r = ((h0r * h1r + h0i * h1i) * ninv).sum(dim=-1)
        a01i = ((h0r * h1i - h0i * h1r) * ninv).sum(dim=-1)
        det = torch.clamp(a00 * a11 - (a01r * a01r + a01i * a01i), min=1e-30)
        # B = H^H N^-1; W = A^-1 B with A^-1 = [[a11, -a01], [-conj(a01), a00]] / det.
        b0r, b0i = h0r * ninv, -h0i * ninv
        b1r, b1i = h1r * ninv, -h1i * ninv
        inv_det = 1.0 / det
        a11d = (a11 * inv_det)[..., None]
        a00d = (a00 * inv_det)[..., None]
        a01rd = (a01r * inv_det)[..., None]
        a01id = (a01i * inv_det)[..., None]
        w0r = a11d * b0r - (a01rd * b1r - a01id * b1i)
        w0i = a11d * b0i - (a01rd * b1i + a01id * b1r)
        w1r = a00d * b1r - (a01rd * b0r + a01id * b0i)
        w1i = a00d * b1i - (a01rd * b0i - a01id * b0r)
        # Bias d_l = [A^-1]_ll: unbias by 1/(1-d); noise d/(1-d).
        d0 = torch.clamp(a11 * inv_det, 1e-9, 1.0 - 1e-9)
        d1 = torch.clamp(a00 * inv_det, 1e-9, 1.0 - 1e-9)
        g0 = (1.0 / (1.0 - d0))[..., None]
        g1 = (1.0 / (1.0 - d1))[..., None]
        wr_out = torch.stack([w0r * g0, w1r * g1], dim=-2)
        wi_out = torch.stack([w0i * g0, w1i * g1], dim=-2)
        nvars = torch.stack([d0 / (1.0 - d0), d1 / (1.0 - d1)], dim=-1)
        return torch.stack([wr_out, wi_out], dim=-1), nvars

    h = to_cplx(h_pair) * tx_scaling  # (..., S, P, L)
    ninv = 1.0 / torch.clamp(nvar, min=1e-38)
    ah_n = h.transpose(-1, -2).conj() * ninv[..., None, :]  # (..., S, L, P)
    eye = torch.eye(nlayers, dtype=h.dtype, device=h.device)
    a = (ah_n[..., :, :, None] * h[..., None, :, :]).sum(dim=-2) + eye
    a_inv = torch.linalg.inv(a)
    w = (a_inv[..., :, :, None] * ah_n[..., None, :, :]).sum(dim=-2)  # (..., S, L, P)
    d = torch.clamp(torch.diagonal(a_inv, dim1=-2, dim2=-1).real, 1e-9, 1.0 - 1e-9)
    w = w / (1.0 - d)[..., None]
    return from_cplx(w), d / (1.0 - d)


def apply_weights_ports_first(w_pair: torch.Tensor, y_pair: torch.Tensor,
                              rot_pair: torch.Tensor | None = None) -> torch.Tensor:
    """Apply per-subcarrier weights to REs in the grid's native (P, nsym, S) order.

    w_pair: (..., S, L, P, 2); y_pair: (..., P, nsym, S, 2); rot_pair:
    optional (..., nsym, 2) unit phasors r_t, outputs multiplied by conj(r_t)
    (CFO derotation).  Returns (..., nsym, S, L, 2).
    """
    wr, wi = w_pair[..., 0], w_pair[..., 1]  # (..., S, L, P)
    yr, yi = y_pair[..., 0], y_pair[..., 1]  # (..., P, T, S)
    outr = outi = None
    for p in range(yr.shape[-3]):
        wrp, wip = wr[..., p][..., None, :, :], wi[..., p][..., None, :, :]
        yrp, yip = yr[..., p, :, :][..., None], yi[..., p, :, :][..., None]
        tr = wrp * yrp - wip * yip
        ti = wrp * yip + wip * yrp
        outr = tr if outr is None else outr + tr
        outi = ti if outi is None else outi + ti
    if rot_pair is not None:
        cr = rot_pair[..., 0][..., None, None]
        ci = rot_pair[..., 1][..., None, None]
        outr, outi = outr * cr + outi * ci, outi * cr - outr * ci
    return torch.stack([outr, outi], dim=-1)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., i, k) @ (..., k, j) as an elementwise product and sum (tiny k)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def apply_weights(w_pair: torch.Tensor, y_pair: torch.Tensor) -> torch.Tensor:
    """Apply per-subcarrier weights to per-symbol received REs.

    w_pair: (..., S, L, P, 2); y_pair: (..., nsym, S, P, 2).
    Returns (..., nsym, S, L, 2).
    """
    w = to_cplx(w_pair)[..., None, :, :, :]  # (..., 1, S, L, P)
    y = to_cplx(y_pair)[..., None, :]  # (..., T, S, 1, P)
    return from_cplx((w * y).sum(dim=-1))


def zf_weights(h_pair: torch.Tensor, noise_var_port: torch.Tensor, tx_scaling: float = 1.0):
    """Zero-forcing weights per subcarrier; same signature and returns as
    `mmse_weights`.  L = 1: matched filter over the ports divided by the
    combined channel energy, post-eq noise nvar_acc / c^2; L >= 2:
    (H^H N^-1 H)^-1 H^H N^-1 (the reference's 2xN case generalized)."""
    h = to_cplx(h_pair) * tx_scaling  # (..., S, P, L)
    nlayers = h.shape[-1]
    nvar = noise_var_port[..., None, :]  # (..., 1, P)

    if nlayers == 1:
        hs = h[..., 0]
        ch_norm = hs.abs() ** 2
        ok = torch.isfinite(ch_norm) & (ch_norm > 0) & torch.isfinite(nvar) & (nvar > 0)
        ch_norm = torch.where(ok, ch_norm, 0.0)
        c = ch_norm.sum(dim=-1)
        nvar_acc = (ch_norm * torch.where(ok, nvar, 0.0)).sum(dim=-1)
        good = torch.isfinite(c) & (c > 1e-30) & torch.isfinite(nvar_acc)
        w = torch.where(ok, hs.conj(), 0.0) / torch.where(good, c, 1.0)[..., None]
        w = torch.where(good[..., None], w, 0.0)
        nvars = torch.where(good, nvar_acc / torch.where(good, c * c, 1.0), float("inf"))
        return from_cplx(w[..., None, :]), nvars[..., None]

    ninv = 1.0 / torch.clamp(nvar, min=1e-38)
    ah_n = h.transpose(-1, -2).conj() * ninv[..., None, :]  # (..., S, L, P)
    a = _matmul(ah_n, h)  # no +I: pure ZF

    if nlayers == 2:
        a00, a11, a01 = a[..., 0, 0].real, a[..., 1, 1].real, a[..., 0, 1]
        det = a00 * a11 - a01.abs() ** 2
        good = det > 1e-30
        det = torch.where(good, det, 1.0)
        inv00 = (a11 / det).to(h.dtype)
        inv11 = (a00 / det).to(h.dtype)
        inv01 = -a01 / det
        a_inv = torch.stack([torch.stack([inv00, inv01], dim=-1),
                             torch.stack([inv01.conj(), inv11], dim=-1)], dim=-2)
        a_inv = torch.where(good[..., None, None], a_inv, 0.0)
        nvars = torch.where(good[..., None],
                            torch.diagonal(a_inv, dim1=-2, dim2=-1).real, float("inf"))
    else:
        # inv_ex: a singular subcarrier gives unusable weights there, as in
        # JAX, instead of raising for the whole slot.
        a_inv = torch.linalg.inv_ex(a)[0]
        nvars = torch.diagonal(a_inv, dim1=-2, dim2=-1).real
    return from_cplx(_matmul(a_inv, ah_n)), nvars


def equalize_mmse_1xn(y_pair: torch.Tensor, h_pair: torch.Tensor, noise_var_port: torch.Tensor,
                      tx_scaling: float = 1.0):
    """Per-RE MMSE of one layer over N ports (equalize_mmse_1xn.h:44-96).

    y_pair, h_pair: (..., nre, P, 2); noise_var_port: (..., P).  Returns
    (symbols (..., nre, 2), noise variances (..., nre), +inf where degenerate).
    """
    y = to_cplx(y_pair)
    h = to_cplx(h_pair) * tx_scaling
    nvar = noise_var_port[..., None, :].expand(y.shape)
    ch_norm = h.abs() ** 2
    ok = torch.isfinite(ch_norm) & (ch_norm > 0) & torch.isfinite(nvar) & (nvar > 0)
    ch_norm = torch.where(ok, ch_norm, 0.0)
    c = ch_norm.sum(dim=-1)
    nvar_acc = (ch_norm * torch.where(ok, nvar, 0.0)).sum(dim=-1)
    mf = torch.where(ok, y * h.conj(), 0.0).sum(dim=-1)
    denom = c * c + nvar_acc
    good = torch.isfinite(c) & (c > 0) & torch.isfinite(nvar_acc) & (nvar_acc > 0)
    safe = torch.where(good, denom, 1.0)
    out = torch.where(good, mf * c / safe, 0.0)
    nvars = torch.where(good, nvar_acc / safe, float("inf"))
    return from_cplx(out), nvars


def equalize_zf_1xn(y_pair: torch.Tensor, h_pair: torch.Tensor, noise_var_port: torch.Tensor,
                    tx_scaling: float = 1.0):
    """Per-RE ZF of one layer over N ports (equalize_zf_1xn.h:43-96); the
    I/O of `equalize_mmse_1xn`."""
    w_pair, nvars = zf_weights(h_pair[..., None, :], noise_var_port, tx_scaling)
    out = (to_cplx(w_pair)[..., 0, :] * to_cplx(y_pair)).sum(dim=-1)
    return from_cplx(out), nvars[..., 0]


def equalize_mmse_general(y_pair: torch.Tensor, h_pair: torch.Tensor,
                          noise_var_port: torch.Tensor, tx_scaling: float = 1.0):
    """MMSE of L layers over N ports by batched per-RE hermitian solves.

    y_pair: (..., nre, P, 2); h_pair: (..., nre, P, L, 2); noise_var_port:
    (..., P).  Returns (symbols (..., nre, L, 2), noise variances (..., nre, L)).
    """
    y = to_cplx(y_pair)
    h = to_cplx(h_pair) * tx_scaling
    nvar = noise_var_port[..., None, :].expand(y.shape)
    wht = torch.rsqrt(torch.clamp(nvar, min=1e-38))
    hw = h * wht[..., None]
    yw = y * wht
    ah = hw.transpose(-1, -2).conj()  # (..., R, L, P)
    eye = torch.eye(h.shape[-1], dtype=hw.dtype, device=hw.device)
    a = _matmul(ah, hw) + eye
    rhs = (ah * yw[..., None, :]).sum(dim=-1)
    sol = torch.linalg.solve(a, rhs[..., None])[..., 0]
    g = 1.0 - torch.diagonal(torch.linalg.inv(a), dim1=-2, dim2=-1).real
    g = torch.clamp(g, 1e-9, 1.0 - 1e-9)
    return from_cplx(sol / g), (1.0 - g) / g
