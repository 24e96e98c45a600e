"""O-RAN fronthaul IQ compression (BFP + none) as batched torch ops on the
caller's device (port of `srsran_projectvtlmo_tpu.ops.ofh_compression`).

The reference implements O-RAN.WG4.CUS Annex A.1.2 block-floating-point
compression with per-ISA SIMD kernels and a byte-level PRB packer
(reference: lib/ofh/compression/iq_compression_bfp_impl.cpp:52-137,
lib/ofh/compression/quantizer.h:34-105,
lib/ofh/compression/iq_compression_bfp_impl.h:63-77).  Here the whole
symbol's (or slot's) PRBs batch on leading axes and the bit-level wire
packing is a vectorized bit expansion, so compressing a full slot is a few
elementwise ops and reductions on the tensor's device.

Semantics are kept exactly:
  * quantization to Q_BIT_WIDTH=16 with gain 2^15-1 and round half to even
    (`torch.round`, as `jnp.round`);
  * per-PRB max_abs = max(|max|, |min|-1) over the 24 real samples;
  * exponent = max(0, (16-W) - min(16-W, clz16(max_abs)-1));
  * mantissas are arithmetic right shifts (int32 `>>`) by the exponent;
  * decompression scales (mantissa << exponent) back by 1/(2^15-1)
    (a multiplication by the float32 reciprocal, as XLA compiles it).
"""

from __future__ import annotations

import numpy as np
import torch

MAX_IQ_WIDTH = 16
_Q_GAIN = float((1 << (MAX_IQ_WIDTH - 1)) - 1)  # 32767
NOF_SUBC = 12
SAMPLES_PER_PRB = 2 * NOF_SUBC


def _dequantize(x: torch.Tensor, iq_scaling: float) -> torch.Tensor:
    """x / (2^15-1) / iq_scaling as float32: a multiplication by the float32
    reciprocal, which is what XLA compiles the JAX package's division by
    that constant to, so the floats come out bit for bit the same."""
    return x.to(torch.float32) * (torch.tensor(1.0, dtype=torch.float32)
                                  / torch.tensor(_Q_GAIN * iq_scaling, dtype=torch.float32))


def _quantize16(iq_pair, iq_scaling: float) -> torch.Tensor:
    """float (..., 2) in [-1,1] -> int16-valued int32 (reference quantizer::to_fixed_point)."""
    x = torch.as_tensor(iq_pair, dtype=torch.float32)
    scaled = x * torch.tensor(_Q_GAIN * iq_scaling, dtype=torch.float32)
    q = torch.round(scaled).to(torch.int32)
    return torch.clamp(q, -32768, 32767)


def _bits_needed(x: torch.Tensor) -> torch.Tensor:
    """Number of significant bits of nonnegative x < 2^16 (16 - clz16)."""
    n = torch.zeros_like(x)
    for k in range(MAX_IQ_WIDTH):
        n = n + (x >= (1 << k)).to(x.dtype)
    return n


@torch.no_grad()
def bfp_compress(iq_pair, data_width: int, iq_scaling: float = 1.0):
    """BFP-compress PRBs of IQ samples.

    Args:
      iq_pair: (..., n_prb, 12, 2) float32 resource elements as real pairs.
      data_width: compressed mantissa width W in bits (1..16).
      iq_scaling: input scale applied before quantization.

    Returns:
      (mantissas (..., n_prb, 24) int32 in [-2^(W-1), 2^(W-1)-1],
       exponents (..., n_prb) int32)
    """
    assert 1 <= data_width <= MAX_IQ_WIDTH
    q = _quantize16(iq_pair, iq_scaling)
    flat = q.reshape(q.shape[:-3] + (q.shape[-3], SAMPLES_PER_PRB))
    max_v = flat.amax(dim=-1)
    min_v = flat.amin(dim=-1)
    # reference: iq_compression_bfp_impl.cpp:57-60 (|min|-1 avoids int16 overflow)
    max_abs = torch.maximum(max_v.abs(), min_v.abs() - 1)

    max_shift = MAX_IQ_WIDTH - data_width
    # reference: iq_compression_bfp_impl.h:63-77 (clz-based exponent)
    lz_wo_sign = torch.where(max_abs > 0, 15 - _bits_needed(max_abs),
                             torch.full_like(max_abs, max_shift))
    raw_exp = torch.clamp(lz_wo_sign, max=max_shift)
    exponent = torch.clamp(max_shift - raw_exp, min=0)

    mant = flat >> exponent[..., None]  # int32: arithmetic (signed)
    return mant, exponent


@torch.no_grad()
def bfp_decompress(mantissas, data_width: int, iq_scaling: float = 1.0, exponents=None):
    """Inverse of bfp_compress -> (..., n_prb, 12, 2) float32.

    reference: lib/ofh/compression/iq_compression_bfp_impl.cpp:101-122.
    """
    del data_width  # mantissas arrive sign-extended already
    m = torch.as_tensor(mantissas, dtype=torch.int32)
    e = torch.as_tensor(exponents, dtype=torch.int32, device=m.device)
    out = _dequantize(m << e[..., None], iq_scaling)
    return out.reshape(m.shape[:-1] + (NOF_SUBC, 2))


@torch.no_grad()
def none_compress(iq_pair, iq_scaling: float = 1.0) -> torch.Tensor:
    """'none' compression = plain 16-bit quantization
    (reference: lib/ofh/compression/iq_compression_none_impl.cpp)."""
    q = _quantize16(iq_pair, iq_scaling)
    return q.reshape(q.shape[:-3] + (q.shape[-3], SAMPLES_PER_PRB))


@torch.no_grad()
def none_decompress(samples, iq_scaling: float = 1.0) -> torch.Tensor:
    s = torch.as_tensor(samples)
    return _dequantize(s, iq_scaling).reshape(s.shape[:-1] + (NOF_SUBC, 2))


def _msb_first(width: int, device) -> torch.Tensor:
    """Shift amounts width-1 .. 0: bit j of a field is its (width-1-j)-th bit."""
    return torch.arange(width - 1, -1, -1, dtype=torch.int32, device=device)


@torch.no_grad()
def pack_prbs(mantissas, data_width: int, exponents=None) -> torch.Tensor:
    """Pack per-PRB mantissas (+ optional leading exponent byte) to wire bytes.

    O-RAN U-plane udCompParam/PRB layout: one exponent byte (when exponents
    is given) followed by 24 big-endian data_width-bit fields
    (reference: lib/ofh/compression/compressed_prb_packer.cpp).

    mantissas: (..., n_prb, 24) int32. Returns (..., n_prb, nbytes) uint8.
    """
    w = data_width
    u = torch.as_tensor(mantissas).to(torch.int32) & ((1 << w) - 1)
    # Expand to a bitstream: bit j of sample s sits at stream position s*w+j.
    bits = (u[..., None] >> _msb_first(w, u.device)) & 1  # (..., 24, w)
    stream = bits.reshape(bits.shape[:-2] + (SAMPLES_PER_PRB * w,))
    pad = (-stream.shape[-1]) % 8
    if pad:
        stream = torch.cat([stream, stream.new_zeros(stream.shape[:-1] + (pad,))], dim=-1)
    by = stream.reshape(stream.shape[:-1] + (stream.shape[-1] // 8, 8))
    data = (by << _msb_first(8, u.device)).sum(dim=-1).to(torch.uint8)
    if exponents is None:
        return data
    exp_b = torch.as_tensor(exponents, device=u.device)[..., None].to(torch.uint8)
    return torch.cat([exp_b, data], dim=-1)


@torch.no_grad()
def unpack_prbs(prb_bytes, data_width: int, has_exponent: bool = True):
    """Inverse of pack_prbs -> (mantissas (..., 24) int32 sign-extended, exponents)."""
    w = data_width
    b = torch.as_tensor(prb_bytes)
    if has_exponent:
        exponents = b[..., 0].to(torch.int32)
        data = b[..., 1:]
    else:
        exponents = None
        data = b
    db = data.to(torch.int32)
    bits = (db[..., None] >> _msb_first(8, db.device)) & 1
    stream = bits.reshape(bits.shape[:-2] + (bits.shape[-2] * 8,))
    stream = stream[..., :SAMPLES_PER_PRB * w]
    fields = stream.reshape(stream.shape[:-1] + (SAMPLES_PER_PRB, w))
    raw = (fields << _msb_first(w, db.device)).sum(dim=-1, dtype=torch.int32)
    # Sign extend from data_width (reference: quantizer::sign_extend).
    sign = 1 << (w - 1)
    mant = torch.where(raw >= sign, raw - (1 << w), raw)
    return mant, exponents


def compress_symbol(iq_pair, params_type: str, data_width: int, iq_scaling: float = 1.0):
    """Compress one symbol's worth of PRBs to wire bytes.

    iq_pair: (..., n_prb, 12, 2) float32; returns (..., n_prb, nbytes) uint8.
    Mirrors iq_compressor_selector dispatch
    (reference: lib/ofh/compression/iq_compressor_selector.cpp).
    """
    if params_type == "bfp":
        mant, exp = bfp_compress(iq_pair, data_width, iq_scaling)
        return pack_prbs(mant, data_width, exp)
    if params_type == "none":
        samples = none_compress(iq_pair, iq_scaling)
        return pack_prbs(samples, MAX_IQ_WIDTH)
    raise ValueError(f"unsupported compression type {params_type!r}")


def decompress_symbol(prb_bytes, params_type: str, data_width: int, iq_scaling: float = 1.0):
    """Inverse of compress_symbol -> (..., n_prb, 12, 2) float32."""
    if params_type == "bfp":
        mant, exp = unpack_prbs(prb_bytes, data_width, True)
        return bfp_decompress(mant, data_width, iq_scaling, exponents=exp)
    if params_type == "none":
        samples, _ = unpack_prbs(prb_bytes, MAX_IQ_WIDTH, False)
        return none_decompress(samples, iq_scaling)
    raise ValueError(f"unsupported compression type {params_type!r}")


def golden_bfp_compress_prb(samples16: np.ndarray, data_width: int):
    """Scalar numpy golden model of one-PRB BFP compression for tests
    (independent port of O-RAN.WG4.CUS A.1.2 as the reference implements it)."""
    assert samples16.shape == (SAMPLES_PER_PRB,)
    max_abs = max(abs(int(samples16.max())), abs(int(samples16.min())) - 1)
    max_shift = MAX_IQ_WIDTH - data_width
    if max_abs > 0 and max_shift > 0:
        lz = 15 - int(max_abs).bit_length()
    else:
        lz = max_shift
    raw_exp = min(max_shift, lz)
    exp = max(0, max_shift - raw_exp)
    return (samples16.astype(np.int32) >> exp), exp
