"""The reference of a PUSCH: the UE side that makes a slot's received samples,
and a receiver that recovers the TB and the channel state from them, written
from TS 38.211, 38.212 and 38.214 in plain PyTorch float32.

What it takes from the frozen copies beside it is channel coding alone: the
TB and codeblock CRCs with segmentation, the LDPC encoder, the TBS formula,
the base graphs and the desegmentation with both CRC checks
(`ops/ldpc/segment.desegment_rx`).  Every sequence (the Gold sequence,
QAM, the DM-RS and the rate matching from `dl`), resource element,
estimator, the demapper, the rate recovery and the LDPC decoder are its own.

The UE side (`transmit`): 38.211 6.3.1 scrambling (c_init = rnti 2^15 +
n_id), QAM (5.1), layer mapping (6.3.1.3), no transform precoding; the
layers' data frequency first on every symbol without DM-RS; DM-RS type 1
(6.4.1.1, n_SCID 0) on the even subcarriers of its symbols, CDM group 0 with
the frequency OCC (+1, +1) / (+1, -1) of layers 0 / 1, the odd subcarriers
empty (two CDM groups without data); each rx port the layers through a flat
P x L channel; the OFDM modulator of 5.3.1 with the unitary DFT scaling
(1 / sqrt(dft) of the unnormalised inverse DFT); a delay of whole samples;
white Gaussian noise of a given std per real component.

The receiver (`receive`), all in float32 with TF32 off and no matrix product
but the 2 x 2 solves of the MMSE filter:
  * OFDM demodulation: the cyclic prefix dropped, the DFT divided by its
    size, subcarrier k from bin k - nsubc/2;
  * least-squares estimates at the pilots, despread over each pilot pair
    into one estimate per (layer, rx port) at the pair's centre;
  * timing advance: the mean phase step between adjacent pair estimates,
    over ports and layers (positive: the signal arrives late);
  * the channel: the pair estimates with the TA's phase ramp removed,
    averaged per PRB, the ramp put back per subcarrier; the noise variance
    per RE from their spread around that average (unbiased where the
    channel is flat over a PRB once the ramp is removed);
  * MMSE per subcarrier with its bias removed: g_l = [W H]_ll, SINR_l =
    g_l / (1 - g_l); the reported SINR is 10 log10 of the mean over layers
    and subcarriers of SINR_l, the EVM the RMS distance of the unbiased
    symbols to their nearest constellation point;
  * max-log LLRs over the whole constellation (the symbol's noise 1 /
    SINR_l), layer demapping, descrambling;
  * rate recovery per codeblock (38.212 5.4.2 inverted): bit
    de-interleaving, repeated positions summed, filler bits as known zeros,
    the 2 Z punctured systematic bits as erasures;
  * normalized min-sum LDPC decoding (scale 0.75), layered schedule (one
    row of the base graph at a time), at most `MAX_SWEEPS` sweeps, each
    codeblock stopping once its syndrome is zero; then desegmentation with
    both CRC levels.

Departures from the specification: the standard fixes no estimator, so the
TA, noise, SINR and EVM estimates above are this reference's choices; the
decoder approximates belief propagation, as every practical decoder does.
It serves DM-RS type 1 with one or two layers (CDM group 0), no frequency
hopping, no UCI multiplexing.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import dl as ref_dl
from .ops.ldpc.encode import ldpc_encode
from .ops.ldpc.graphs import get_graph
from .ops.ldpc.segment import desegment_rx, segment_tx
from .ran.ldpc_params import BaseGraph
from .ran.sch import sch_segmentation_info

NSYM = ref_dl.NSYM
#: Min-sum scale and sweep budget of the reference decoder (the
#: configuration's `pusch_decoder_max_iterations` is 6).
MINSUM_SCALE = 0.75
MAX_SWEEPS = 6
#: The LLR of a filler bit, known to be zero.
FILLER_LLR = 1.0e4


def _qm(pdu) -> int:
    return ref_dl.QM[pdu.modulation.name]


def data_symbols(pdu) -> list[int]:
    return ref_dl.data_symbols(pdu)


def tbs(pdu) -> int:
    return ref_dl.pdsch_tbs(pdu)


def dmrs_pilots(pdu, slot: int, symbol: int, numerology: int) -> np.ndarray:
    """r(m) of one DM-RS symbol over the allocation's 6 rb_size pilots
    (38.211 6.4.1.1.1.1, counted from CRB 0), complex128."""
    n_s = slot % (10 << numerology)
    c_init = ((1 << 17) * (NSYM * n_s + symbol + 1) * (2 * pdu.n_id + 1) + 2 * pdu.n_id) \
        % (1 << 31)
    return ref_dl.qpsk_pilots(c_init, 6 * pdu.rb_size, skip=6 * pdu.rb_start)


def occ(nof_layers: int, npil: int) -> np.ndarray:
    """(L, npil) frequency OCC w_f(k') of layers 0 and 1 (Table 6.4.1.1.3-1)."""
    kp = np.arange(npil) % 2
    return np.stack([np.where((kp == 1) & (l % 2 == 1), -1.0, 1.0) for l in range(nof_layers)])


@functools.lru_cache(maxsize=None)
def constellation(qm: int) -> tuple[np.ndarray, np.ndarray]:
    """(points (2^qm,) complex128, their bits (2^qm, qm) uint8) of 38.211 5.1."""
    bits = ((np.arange(1 << qm)[:, None] >> np.arange(qm - 1, -1, -1)) & 1).astype(np.uint8)
    return ref_dl.qam(bits.reshape(-1), qm), bits


# --------------------------------------------------------------- UE side --


def gold_rows(c_inits: list[int], n: int) -> np.ndarray:
    """c(0..n-1) of TS 38.211 5.2.1 for several c_init at once, (R, n)
    uint8: `dl.gold`'s recursion, x1 (the same for every c_init) once and
    x2 over all rows in each step."""
    total = ref_dl.NC + n + 31
    x1 = np.zeros(total + 28, np.uint8)
    x2 = np.zeros((len(c_inits), total + 28), np.uint8)
    x1[0] = 1
    x2[:, :31] = [[(c >> i) & 1 for i in range(31)] for c in c_inits]
    for s in range(0, total - 31, 28):  # 28 new values per step depend only on older ones
        x1[s + 31:s + 59] = x1[s + 3:s + 31] ^ x1[s:s + 28]
        x2[:, s + 31:s + 59] = (x2[:, s + 3:s + 31] ^ x2[:, s + 2:s + 30] ^ x2[:, s + 1:s + 29]
                                ^ x2[:, s:s + 28])
    return x1[None, ref_dl.NC:ref_dl.NC + n] ^ x2[:, ref_dl.NC:ref_dl.NC + n]


def codeword_bits(pdu) -> int:
    """G, the PUSCH's codeword bits: data REs x layers x Qm."""
    return len(data_symbols(pdu)) * pdu.rb_size * 12 * _qm(pdu) * pdu.nof_layers


def codeword(pdu, tb: np.ndarray, device) -> np.ndarray:
    """TB bits -> the G codeword bits before scrambling (38.212 6.2: CRC,
    segmentation, LDPC encoding, 5.4.2 rate matching as `dl.pdsch_codeword`
    does for the DL-SCH).  `device` runs the LDPC encoder."""
    qm, nl, g = _qm(pdu), pdu.nof_layers, codeword_bits(pdu)
    seg = sch_segmentation_info(len(tb), pdu.target_code_rate)
    z, c = seg.lifting_size, seg.nof_cb
    cbs = segment_tx(torch.as_tensor(np.asarray(tb, np.uint8)[None], device=device), seg)[0]
    d = ldpc_encode(cbs, seg.base_graph, z)[:, 2 * z:].cpu().numpy()  # (C, N)
    n = d.shape[1]
    filler = np.zeros(n, bool)
    filler[seg.nof_payload_bits_per_cb - 2 * z:seg.nof_bits_per_cb - 2 * z] = True
    order = (ref_dl.k0(seg.base_graph, pdu.rv, n, z) + np.arange(n)) % n
    order = order[~filler[order]]
    out = []
    for r in range(c):  # 5.4.2.1: E_r, bit selection; 5.4.2.2: bit interleaving
        short = r <= c - (g // (nl * qm)) % c - 1
        e = nl * qm * (g // (nl * qm * c) if short else -(-g // (nl * qm * c)))
        out.append(d[r, np.resize(order, e)].reshape(qm, e // qm).T.reshape(-1))
    return np.concatenate(out)


def transmit(pdu, tb: np.ndarray, slot: int, cell: dict, channel: np.ndarray,
             noise_std: float, delay: int, rng: np.random.Generator, device,
             scrambling: np.ndarray | None = None) -> np.ndarray:
    """The samples (P, nsamples, 2) float32 the cell's rx ports receive of
    one PUSCH carrying `tb`: through `channel` (P, L), delayed by `delay`
    samples, with noise of std `noise_std` per real component.  `device`
    runs the LDPC encoder; `scrambling` is the row's Gold sequence where the
    caller made it (`gold_rows`), else it is made here."""
    qm, nl = _qm(pdu), pdu.nof_layers
    nsubc, dft = cell["nof_rb"] * 12, cell["dft_size"]
    if scrambling is None:
        scrambling = ref_dl.gold((pdu.rnti << 15) + pdu.n_id, codeword_bits(pdu))
    layers = np.zeros((nl, NSYM, nsubc), np.complex128)
    x = ref_dl.qam(codeword(pdu, tb, device) ^ scrambling, qm).reshape(-1, nl).T
    k = pdu.rb_start * 12 + np.arange(pdu.rb_size * 12)
    syms = data_symbols(pdu)
    x = x.reshape(nl, len(syms), len(k))
    for i, l in enumerate(syms):
        layers[:, l, k] = x[:, i]
    npil = 6 * pdu.rb_size
    w = occ(nl, npil)
    for l in pdu.dmrs_symbols:
        layers[:, l, pdu.rb_start * 12 + 2 * np.arange(npil)] = \
            w * dmrs_pilots(pdu, slot, l, cell["numerology"])[None]
    rx = np.einsum("pl,lsk->psk", channel, layers)
    t = ref_dl.ofdm(rx, dft, cell["numerology"], slot) / math.sqrt(dft)
    t = np.concatenate([np.zeros((t.shape[0], delay), t.dtype), t[:, :t.shape[1] - delay]], 1)
    t = t + noise_std * (rng.standard_normal(t.shape) + 1j * rng.standard_normal(t.shape))
    return np.stack([t.real, t.imag], -1).astype(np.float32)


def true_sinr_db(channel: np.ndarray, noise_std: float) -> float:
    """10 log10 of the mean over layers of the post-MMSE SINR with the
    channel known (per RE: the unitary DFT keeps symbols at unit power and
    the noise at 2 std^2), unbiased: 1 / [(H^H H / s2 + I)^-1]_ll - 1."""
    s2 = 2.0 * noise_std ** 2
    a = channel.conj().T @ channel / s2 + np.eye(channel.shape[1])
    d = np.real(np.diag(np.linalg.inv(a)))
    return float(10.0 * np.log10(np.mean(1.0 / d - 1.0)))


# -------------------------------------------------------------- receiver --


def store(grid: torch.Tensor, precision: str) -> torch.Tensor:
    """The complex grid rounded per real part to float8 e4m3 (the control),
    or kept in float32."""
    if precision == "f32":
        return grid
    pairs = torch.view_as_real(grid).to(torch.float8_e4m3fn).to(torch.float32)
    return torch.view_as_complex(pairs.contiguous())


def demodulate(samples: torch.Tensor, cell: dict, slot: int) -> torch.Tensor:
    """(P, nsamples, 2) float32 -> the grid (P, 14, nsubc) complex64."""
    x = torch.complex(samples[..., 0], samples[..., 1])
    dft, nsubc = cell["dft_size"], cell["nof_rb"] * 12
    start, offs = 0, []
    for cp in ref_dl.cp_lengths(dft, cell["numerology"], slot):
        offs.append(start + cp)
        start += cp + dft
    bins = torch.fft.fft(torch.stack([x[:, o:o + dft] for o in offs], 1), dim=-1) / dft
    k = torch.as_tensor((np.arange(nsubc) - nsubc // 2) % dft, device=x.device)
    return bins[..., k]


def _estimate(grid: torch.Tensor, pdu, slot: int, cell: dict, scs: float) -> dict:
    """Channel (S, P, L) per subcarrier of the allocation, the noise
    variance per RE, the TA in s."""
    dev = grid.device
    npil, nl = 6 * pdu.rb_size, pdu.nof_layers
    k = pdu.rb_start * 12 + 2 * np.arange(npil)
    z = 0
    for l in pdu.dmrs_symbols:
        r = torch.as_tensor(dmrs_pilots(pdu, slot, l, cell["numerology"]), dtype=torch.complex64,
                            device=dev)
        z = z + grid[:, l, torch.as_tensor(k, device=dev)] * r.conj()
    z = z / len(pdu.dmrs_symbols)                      # (P, npil)
    w = torch.as_tensor(occ(nl, npil), dtype=torch.float32, device=dev)
    h = (z[None] * w[:, None]).reshape(nl, -1, npil // 2, 2).mean(-1)   # (L, P, npair)
    step = (h[..., 1:] * h[..., :-1].conj()).sum()
    ta = -float(torch.angle(step)) / (2.0 * math.pi * 4 * scs)
    centre = 4.0 * torch.arange(npil // 2, device=dev, dtype=torch.float32) + 1.0
    ramp = torch.polar(torch.ones_like(centre), 2.0 * math.pi * scs * ta * centre)
    hd = (h * ramp).reshape(nl, h.shape[1], pdu.rb_size, 3)
    a = hd.mean(-1)                                    # (L, P, nprb)
    spread = (hd - a[..., None]).abs().square().sum() / (a.numel() * 2)
    noise = 2.0 * len(pdu.dmrs_symbols) * float(spread)
    sub = torch.arange(pdu.rb_size * 12, device=dev, dtype=torch.float32)
    back = torch.polar(torch.ones_like(sub), -2.0 * math.pi * scs * ta * sub)
    hk = a.repeat_interleave(12, dim=-1) * back        # (L, P, S)
    return {"h": hk.permute(2, 1, 0), "noise": noise, "ta_s": ta}


def _mmse(h: torch.Tensor, noise: float):
    """(unbiased weights (S, L, P), SINR (S, L)) of the MMSE filter per
    subcarrier, as elementwise sums."""
    nl = h.shape[-1]
    hh = (h.conj()[:, :, :, None] * h[:, :, None, :]).sum(1)    # (S, L, L): H^H H
    a = hh + noise * torch.eye(nl, device=h.device)
    w = torch.linalg.solve(a, h.conj().transpose(1, 2))         # (S, L, P)
    g = (w * h.transpose(1, 2)).sum(-1).real                    # diag(W H), (S, L)
    g = g.clamp(1e-9, 1.0 - 1e-9)
    return w / g[..., None], g / (1.0 - g)


def _llrs(x: torch.Tensor, sinr: torch.Tensor, qm: int, chunk: int = 16384) -> torch.Tensor:
    """Max-log LLRs (N, qm) of symbols x (N,) with noise 1 / sinr (N,),
    positive for bit 0."""
    pts, bits = constellation(qm)
    p = torch.as_tensor(pts, dtype=torch.complex64, device=x.device)
    one = torch.as_tensor(bits == 1, device=x.device)
    out = []
    for s in range(0, x.shape[0], chunk):
        d = (x[s:s + chunk, None] - p[None]).abs().square() * sinr[s:s + chunk, None]
        big = torch.full_like(d, float("inf"))
        out.append(torch.stack([torch.where(one[:, b], d, big).amin(-1)
                                - torch.where(one[:, b], big, d).amin(-1)
                                for b in range(qm)], -1))
    return torch.cat(out)


def _evm(x: torch.Tensor, qm: int, chunk: int = 16384) -> float:
    p = torch.as_tensor(constellation(qm)[0], dtype=torch.complex64, device=x.device)
    err = torch.cat([(x[s:s + chunk, None] - p[None]).abs().square().amin(-1)
                     for s in range(0, x.shape[0], chunk)])
    return float(err.mean().sqrt())


def _dematch(llr: torch.Tensor, pdu, seg, g: int) -> torch.Tensor:
    """(G,) descrambled LLRs -> (C, N_full) decoder inputs."""
    qm, nl = _qm(pdu), pdu.nof_layers
    z, c, n = seg.lifting_size, seg.nof_cb, seg.nof_cw_bits_per_cb
    filler = np.zeros(n, bool)
    filler[seg.nof_payload_bits_per_cb - 2 * z:seg.nof_bits_per_cb - 2 * z] = True
    order = (ref_dl.k0(seg.base_graph, pdu.rv, n, z) + np.arange(n)) % n
    order = order[~filler[order]]
    rows, off = [], 0
    for r in range(c):
        short = r <= c - (g // (nl * qm)) % c - 1
        e = nl * qm * (g // (nl * qm * c) if short else -(-g // (nl * qm * c)))
        f = llr[off:off + e].reshape(e // qm, qm).T.reshape(-1)
        buf = torch.zeros(n, dtype=torch.float32, device=llr.device)
        buf.index_add_(0, torch.as_tensor(np.resize(order, e), device=llr.device), f)
        buf[torch.as_tensor(filler, device=llr.device)] = FILLER_LLR
        rows.append(torch.cat([buf.new_zeros(2 * z), buf]))
        off += e
    return torch.stack(rows)


@functools.lru_cache(maxsize=None)
def _layers(bg: BaseGraph, z: int, device) -> list[torch.Tensor]:
    """The Tanner graph as its layers, one per row of the base graph: the
    variable index (z, d) of each of the row's z checks' d edges.  A layer
    touches each variable at most once."""
    g = get_graph(bg, z)
    deg = (g.row_cols >= 0).sum(1)
    i = np.arange(z)
    out = []
    for r, d in enumerate(deg.tolist()):
        cols, shifts = g.row_cols[r, :d], g.row_shifts[r, :d]
        var = cols[None, :] * z + (i[:, None] + shifts[None, :]) % z
        out.append(torch.as_tensor(var.astype(np.int64), device=device))
    return out


def decode(llr: torch.Tensor, bg: BaseGraph, z: int) -> tuple[torch.Tensor, np.ndarray]:
    """Normalized min-sum, layered (the base graph's rows in order, each
    updating the totals the next reads): (C, N_full) channel LLRs -> (hard
    bits (C, K) uint8, the sweeps each codeblock ran until its syndrome was
    zero, at most MAX_SWEEPS)."""
    layers = _layers(bg, z, llr.device)
    c = llr.shape[0]
    c2v = [torch.zeros((c,) + v.shape, device=llr.device) for v in layers]
    total = llr.clone()
    sweeps = torch.zeros(c, dtype=torch.int64, device=llr.device)
    done = torch.zeros(c, dtype=torch.bool, device=llr.device)
    for _ in range(MAX_SWEEPS):
        live = ~done[:, None, None]
        for j, var in enumerate(layers):
            v2c = total[:, var] - c2v[j]
            sign = torch.where(v2c < 0, -1.0, 1.0)
            mag = v2c.abs()
            m1, at = mag.min(-1, keepdim=True)
            m2 = mag.scatter(-1, at, float("inf")).min(-1, keepdim=True).values
            first = torch.arange(var.shape[1], device=llr.device) == at
            msg = sign.prod(-1, keepdim=True) * sign * torch.where(first, m2, m1) * MINSUM_SCALE
            msg = torch.where(live, msg, c2v[j])
            c2v[j] = msg
            total[:, var] = torch.where(live, v2c + msg, total[:, var])
        sweeps += (~done).long()
        hard = (total < 0).long()
        ok = torch.ones(c, dtype=torch.bool, device=llr.device)
        for var in layers:
            ok &= (hard[:, var].sum(-1) % 2 == 0).all(-1)
        done |= ok
        if bool(done.all()):
            break
    return (total[:, :get_graph(bg, z).k] < 0).to(torch.uint8), sweeps.cpu().numpy()


def receive(samples: torch.Tensor, pdu, slot: int, cell: dict, precision: str = "f32",
            decode_sch: bool = True) -> dict:
    """One PUSCH of `samples` (P, nsamples, 2) float32 on the device, its
    grid stored at `precision` ("f32", or "fp8" for the control).  Returns
    the channel state `sinr_db`, `ta_ns`, `evm` and, with `decode_sch`,
    `tb_bits` (TBS,) uint8, `tb_crc_ok` and `sweeps` (C,) per codeblock."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 stays float32 on a card
    torch.backends.cudnn.allow_tf32 = False
    scs = 15e3 * (1 << cell["numerology"])
    grid = store(demodulate(samples, cell, slot), precision)
    est = _estimate(grid, pdu, slot, cell, scs)
    w, sinr = _mmse(est["h"], est["noise"])
    k0 = pdu.rb_start * 12
    y = grid[:, data_symbols(pdu), k0:k0 + pdu.rb_size * 12]            # (P, T, S)
    x = (w[None] * y.permute(1, 2, 0)[:, :, None, :]).sum(-1)          # (T, S, L)
    qm = _qm(pdu)
    out = {"sinr_db": float(10.0 * torch.log10(sinr.mean())), "ta_ns": est["ta_s"] * 1e9,
           "evm": _evm(x.reshape(-1), qm)}
    if not decode_sch:
        return out
    n_tb = tbs(pdu)
    seg = sch_segmentation_info(n_tb, pdu.target_code_rate)
    llr = _llrs(x.reshape(-1), sinr[None].expand(x.shape).reshape(-1), qm).reshape(-1)
    g = llr.shape[0]
    scr = torch.as_tensor(ref_dl.gold((pdu.rnti << 15) + pdu.n_id, g), device=llr.device)
    llr = llr * (1.0 - 2.0 * scr.float())
    hard, sweeps = decode(_dematch(llr, pdu, seg, g), seg.base_graph, seg.lifting_size)
    tb, tb_ok, _ = desegment_rx(hard, seg, n_tb)
    out.update(tb_bits=tb.cpu().numpy().astype(np.uint8), tb_crc_ok=bool(tb_ok), sweeps=sweeps)
    return out
