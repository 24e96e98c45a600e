"""MMSE equalization weights and their application (port of `srsran_projectvtlmo_tpu.ops.equalization`).

The slot's channel estimate is constant over the data symbols, so weights are
computed once per subcarrier.  L = 1 uses the reference's SIMO closed form
(equalize_mmse_1xn.h:44-96), L = 2 a closed-form 2x2 hermitian inverse in
real arithmetic, L = 3-4 a batched complex inverse.  All elementwise float32;
no matrix product goes through TF32.
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
