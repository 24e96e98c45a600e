"""The reference of a DL slot, written from TS 38.211 and TS 38.212: every
sequence, every resource element and the OFDM modulation worked out here in
numpy complex128, one channel after another.

What it takes from the frozen copies beside it is channel coding alone: the
TB and codeblock CRCs with segmentation (`ops/ldpc/segment`), the LDPC
encoder (`ops/ldpc/encode`), the TBS formula (`ran/sch`), and the polar
coding of the DCI (`phy/pdcch.pdcch_encode`) and of the BCH
(`phy/pbch.pbch_encode`).  Rate matching, scrambling, modulation, layer
mapping, precoding, DM-RS, the CCE-to-REG mapping, the SS/PBCH block, the
CSI-RS and the OFDM modulator are its own.

The slot as the PDUs define it:

  * PDSCH (38.211 7.3.1): scrambling with c_init = rnti 2^15 + n_id, QAM,
    layer mapping, the PDU's P x L precoding matrix, mapped frequency first
    over its PRBs on every symbol without DM-RS; DM-RS type 1 (7.4.1.1) on
    the even subcarriers of its DM-RS symbols, ports 1000 + l with the
    frequency OCC (+1, +1) / (+1, -1), precoded as the data, the odd
    subcarriers empty (two CDM groups without data);
  * PDCCH (7.3.2): the candidate's CCEs through the interleaved or
    non-interleaved CCE-to-REG mapping, data frequency first on the REs of
    its PRBs outside subcarriers 1, 5, 9, whose DM-RS (7.4.1.3) counts from
    CRB 0; one port vector;
  * SS/PBCH block (7.4.3): PSS, SSS, PBCH and its DM-RS in 4 symbols x 240
    subcarriers, from the slot's first symbol (the PDU carries no symbol),
    at subcarrier 12 offset_pointa + k_ssb plus the cell's offset; one
    port vector;
  * CSI-RS (7.4.1.5): row 2, on port 0;
  * the PDUs carry no power offsets, so every amplitude factor beta is 1;
    channels that share a resource element add (the PDSCH declares no
    reserved REs in the traffic);
  * the grid is stored in the precision the configuration states (bfloat16)
    and OFDM-modulated from it (5.3.1): subcarrier k on bin k - nsubc/2, the
    unnormalised inverse DFT, the cyclic prefix of 144 dft/2048 samples and
    16 2^mu dft/2048 more on the first symbol of each half subframe.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.ldpc.encode import ldpc_encode
from .ops.ldpc.segment import segment_tx
from .phy.pbch import PbchMessage, pbch_encode
from .phy.pdcch import pdcch_encode
from .ran.ldpc_params import BaseGraph
from .ran.sch import sch_segmentation_info, tbs_calculator

NSYM = 14
NC = 1600
QM = {"QPSK": 2, "QAM16": 4, "QAM64": 6, "QAM256": 8}


# ------------------------------------------------------------- sequences --


def gold(c_init: int, n: int) -> np.ndarray:
    """c(0..n-1) of TS 38.211 5.2.1, uint8."""
    total = NC + n + 31
    x1 = np.zeros(total + 28, np.uint8)
    x2 = np.zeros(total + 28, np.uint8)
    x1[0] = 1
    x2[:31] = [(c_init >> i) & 1 for i in range(31)]
    for s in range(0, total - 31, 28):  # 28 new values per step depend only on older ones
        x1[s + 31:s + 59] = x1[s + 3:s + 31] ^ x1[s:s + 28]
        x2[s + 31:s + 59] = x2[s + 3:s + 31] ^ x2[s + 2:s + 30] ^ x2[s + 1:s + 29] ^ x2[s:s + 28]
    return x1[NC:NC + n] ^ x2[NC:NC + n]


def qam(bits: np.ndarray, qm: int) -> np.ndarray:
    """TS 38.211 5.1: Gray-mapped QPSK to 256QAM, bits b(qm i) ... b(qm i + qm - 1)."""
    s = 1.0 - 2.0 * np.asarray(bits, np.float64).reshape(-1, qm)
    if qm == 2:
        return (s[:, 0] + 1j * s[:, 1]) / np.sqrt(2.0)
    amp_re, amp_im = np.ones(len(s)), np.ones(len(s))
    for j in range(qm // 2 - 1, 0, -1):  # innermost level first: 2 - s, 4 - s (2 - s), ...
        amp_re = 2.0 ** (qm // 2 - j) - s[:, 2 * j] * amp_re
        amp_im = 2.0 ** (qm // 2 - j) - s[:, 2 * j + 1] * amp_im
    norm = {4: 10.0, 6: 42.0, 8: 170.0}[qm]
    return (s[:, 0] * amp_re + 1j * s[:, 1] * amp_im) / np.sqrt(norm)


def qpsk_pilots(c_init: int, n: int, skip: int = 0) -> np.ndarray:
    """r(skip .. skip + n - 1) = ((1 - 2 c(2m)) + j (1 - 2 c(2m + 1))) / sqrt 2."""
    c = gold(c_init, 2 * (skip + n))[2 * skip:].astype(np.float64)
    return ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2.0)


def pair(w) -> np.ndarray:
    """A PDU's ((re, im), ...) weights as complex."""
    w = np.asarray(w, np.float64)
    return w[..., 0] + 1j * w[..., 1]


def port_vector(precoding, nof_ports: int) -> np.ndarray:
    if precoding is None:
        return np.eye(nof_ports)[0].astype(np.complex128)
    return pair(precoding)


# ----------------------------------------------------------------- PDSCH --


def _name(modulation) -> str:
    return modulation.name


def data_symbols(pdu) -> list[int]:
    return [s for s in range(pdu.start_symbol, pdu.start_symbol + pdu.nof_symbols)
            if s not in pdu.dmrs_symbols]


def pdsch_tbs(pdu) -> int:
    """TS 38.214 5.1.3.2 with 12 DM-RS REs per PRB per DM-RS symbol (two CDM
    groups without data) and no overhead."""
    n_re = min(156, 12 * len(data_symbols(pdu))) * pdu.rb_size
    return tbs_calculator(nof_re=n_re, target_code_rate=pdu.target_code_rate,
                          modulation_bits=QM[_name(pdu.modulation)], nof_layers=pdu.nof_layers)


def k0(bg: BaseGraph, rv: int, n_cb: int, z: int) -> int:
    """TS 38.212 Table 5.4.2.1-2."""
    num, den = ({0: 0, 1: 17, 2: 33, 3: 56}, 66) if bg == BaseGraph.BG1 else \
        ({0: 0, 1: 13, 2: 25, 3: 43}, 50)
    return (num[rv] * n_cb // (den * z)) * z


def pdsch_codeword(pdu, tb: np.ndarray, device) -> np.ndarray:
    """TB bits -> the G scrambled codeword bits (TS 38.212 7.2 with 5.4.2)."""
    qm, nl = QM[_name(pdu.modulation)], pdu.nof_layers
    g = len(data_symbols(pdu)) * pdu.rb_size * 12 * qm * nl
    seg = sch_segmentation_info(len(tb), pdu.target_code_rate)
    z, c = seg.lifting_size, seg.nof_cb
    cbs = segment_tx(torch.as_tensor(np.asarray(tb, np.uint8)[None], device=device), seg)[0]
    d = ldpc_encode(cbs, seg.base_graph, z)[:, 2 * z:].cpu().numpy()  # (C, N)
    n = d.shape[1]
    filler = np.zeros(n, bool)
    filler[seg.nof_payload_bits_per_cb - 2 * z:seg.nof_bits_per_cb - 2 * z] = True
    start = k0(seg.base_graph, pdu.rv, n, z)
    order = (start + np.arange(n)) % n
    order = order[~filler[order]]
    out = []
    for r in range(c):  # 5.4.2.1: E_r, bit selection; 5.4.2.2: bit interleaving
        short = r <= c - (g // (nl * qm)) % c - 1
        e = nl * qm * (g // (nl * qm * c) if short else -(-g // (nl * qm * c)))
        sel = d[r, np.resize(order, e)]
        out.append(sel.reshape(qm, e // qm).T.reshape(-1))
    bits = np.concatenate(out)
    assert len(bits) == g
    return bits ^ gold((pdu.rnti << 15) + pdu.n_id, g)


def map_pdsch(grid: np.ndarray, pdu, tb: np.ndarray, slot: int, device) -> None:
    qm, nl = QM[_name(pdu.modulation)], pdu.nof_layers
    nports = grid.shape[0]
    assert pdu.precoding is not None or nports >= nl
    w = pair(pdu.precoding) if pdu.precoding is not None else np.eye(nports, nl)
    x = qam(pdsch_codeword(pdu, tb, device), qm).reshape(-1, nl).T  # (L, M): layer mapping
    y = w @ x                                                       # (P, M)
    k = pdu.rb_start * 12 + np.arange(pdu.rb_size * 12)
    syms = data_symbols(pdu)
    y = y.reshape(nports, len(syms), len(k))
    for i, l in enumerate(syms):
        grid[:, l, k] += y[:, i]
    npil = 6 * pdu.rb_size
    kp = np.arange(npil) % 2  # k' of each pilot
    for l in pdu.dmrs_symbols:
        c_init = ((1 << 17) * (14 * slot + l + 1) * (2 * pdu.n_id + 1) + 2 * pdu.n_id) % (1 << 31)
        r = qpsk_pilots(c_init, npil, skip=6 * pdu.rb_start)
        layers = np.stack([r * np.where((kp == 1) & (p % 2 == 1), -1.0, 1.0)
                           for p in range(nl)])  # ports 1000 + p, CDM groups 0 (and 1)
        delta = np.array([(p // 2) for p in range(nl)])
        for p in range(nl):
            grid[:, l, pdu.rb_start * 12 + 2 * np.arange(npil) + delta[p]] += \
                w[:, p:p + 1] * layers[p][None]


# ----------------------------------------------------------------- PDCCH --


def cce_regs(pdu) -> list[int]:
    """TS 38.211 7.3.2.2: the candidate's REG indices within its CORESET."""
    nreg = pdu.coreset_nof_rb * pdu.duration
    bsize = pdu.reg_bundle_size if pdu.interleaved else 6
    per_cce = 6 // bsize
    xs = range(pdu.cce_index * per_cce, (pdu.cce_index + pdu.aggregation_level) * per_cce)
    if pdu.interleaved:
        r_sz = pdu.interleaver_size
        c_sz = nreg // (bsize * r_sz)

        def f(x):
            return ((x % r_sz) * c_sz + x // r_sz + pdu.shift_index) % (nreg // bsize)
    else:
        def f(x):
            return x
    return sorted(reg for x in xs for reg in range(f(x) * bsize, (f(x) + 1) * bsize))


def map_pdcch(grid: np.ndarray, pdu, slot: int) -> None:
    prbs = sorted({pdu.coreset_rb_start + reg // pdu.duration for reg in cce_regs(pdu)})
    e = pdu.aggregation_level * 6 * 9 * 2
    payload = getattr(pdu, "payload", None)
    bits = pdcch_encode(np.asarray(payload if payload is not None
                                   else np.zeros(pdu.nof_dci_bits), np.uint8), pdu.rnti, e)
    syms = qam(bits ^ gold(((pdu.n_rnti << 16) + pdu.n_id) % (1 << 31), e), 2)
    w = port_vector(pdu.precoding, grid.shape[0])[:, None]
    data_k = np.array([12 * p + k for p in prbs for k in range(12) if k % 4 != 1])
    per_sym = len(data_k)
    for i, l in enumerate(range(pdu.start_symbol, pdu.start_symbol + pdu.duration)):
        grid[:, l, data_k] += w * syms[i * per_sym:(i + 1) * per_sym][None]
        c_init = ((1 << 17) * (14 * slot + l + 1) * (2 * pdu.n_id + 1) + 2 * pdu.n_id) % (1 << 31)
        r = qpsk_pilots(c_init, 3 * (max(prbs) + 1))
        dm_k = np.array([12 * p + 4 * kp + 1 for p in prbs for kp in range(3)])
        grid[:, l, dm_k] += w * r[np.array([3 * p + kp for p in prbs for kp in range(3)])][None]


# ------------------------------------------------------------------- SSB --


def m_sequence(taps: tuple[int, ...], init: list[int]) -> np.ndarray:
    """x(i + 7) = sum of x(i + t) for t in taps, mod 2; init = x(0..6)."""
    x = list(init)
    for i in range(127 - 7):
        x.append(sum(x[i + t] for t in taps) % 2)
    return np.asarray(x, np.float64)


def ssb_block(pdu) -> np.ndarray:
    """(4, 240) complex: TS 38.211 7.4.2.2, 7.4.2.3, 7.3.3, 7.4.1.4, Table 7.4.3.1-1."""
    nid = pdu.phys_cell_id
    nid1, nid2 = nid // 3, nid % 3
    blk = np.zeros((4, 240), np.complex128)
    n = np.arange(127)
    x = m_sequence((4, 0), [0, 1, 1, 0, 1, 1, 1])
    blk[0, 56:183] = 1 - 2 * x[(n + 43 * nid2) % 127]
    x0, x1 = m_sequence((4, 0), [1, 0, 0, 0, 0, 0, 0]), m_sequence((1, 0), [1, 0, 0, 0, 0, 0, 0])
    m0, m1 = 15 * (nid1 // 112) + 5 * nid2, nid1 % 112
    blk[2, 56:183] = (1 - 2 * x0[(n + m0) % 127]) * (1 - 2 * x1[(n + m1) % 127])
    res = [(1, k) for k in range(240)] + [(2, k) for k in range(48)] + \
        [(2, k) for k in range(192, 240)] + [(3, k) for k in range(240)]  # increasing k, then l
    v = nid % 4
    dmrs = [(l, k) for l, k in res if k % 4 == v]
    data = [(l, k) for l, k in res if k % 4 != v]
    i_ssb = pdu.ssb_block_index % (4 if pdu.l_max == 4 else 8)
    i_bar = i_ssb + (4 if pdu.l_max == 4 and pdu.half_radio_frame else 0)
    c_init = ((1 << 11) * (i_bar + 1) * (nid // 4 + 1) + (1 << 6) * (i_bar + 1) + v) % (1 << 31)
    blk[tuple(np.array(dmrs).T)] = qpsk_pilots(c_init, len(dmrs))
    msg = PbchMessage(sfn=pdu.sfn, ssb_idx=pdu.ssb_block_index,
                      half_radio_frame=pdu.half_radio_frame, n_id=nid, l_max=pdu.l_max,
                      mib_payload=pdu.mib_payload)
    bits = pbch_encode(msg)  # 38.212 7.1: the E = 864 coded bits
    vv = pdu.ssb_block_index % (4 if pdu.l_max == 4 else 8)
    blk[tuple(np.array(data).T)] = qam(bits ^ gold(nid, 864 * (vv + 1))[864 * vv:], 2)
    return blk


# ----------------------------------------------------------------- CSI-RS --


def map_csi_rs(grid: np.ndarray, pdu, slot: int) -> None:
    """Row 2 (one port, density 1 or 0.5) on port 0: TS 38.211 7.4.1.5.3,
    r(m') with m' = floor(n rho), n the CRB."""
    assert pdu.row == 2, "the reference maps CSI-RS row 2"
    kbar = pdu.k_ref[0] if pdu.k_ref else pdu.subcarrier_offset
    l = pdu.symbol
    c_init = ((1 << 10) * (14 * slot + l + 1) * (2 * pdu.scrambling_id + 1)
              + pdu.scrambling_id) % (1 << 31)
    rbs = np.arange(pdu.prb_start, pdu.prb_start + pdu.nof_rb)
    if pdu.density != "one":
        rbs = rbs[rbs % 2 == (0 if pdu.density == "dot5_even" else 1)]
    m = rbs if pdu.density == "one" else rbs // 2
    grid[0, l, 12 * rbs + kbar] += qpsk_pilots(c_init, int(m.max()) + 1)[m]


# ------------------------------------------------------------------ slot --


def cp_lengths(dft: int, mu: int, slot: int) -> list[int]:
    base, extra = 144 * dft // 2048, 16 * (1 << mu) * dft // 2048
    return [base + (extra if (slot % (1 << mu)) * NSYM + l in (0, 7 * (1 << mu)) else 0)
            for l in range(NSYM)]


def ofdm(grid: np.ndarray, dft: int, mu: int, slot: int) -> np.ndarray:
    """(P, 14, nsubc) -> (P, nsamples) complex: TS 38.211 5.3.1 at baseband."""
    nsubc = grid.shape[-1]
    bins = np.zeros(grid.shape[:-1] + (dft,), np.complex128)
    bins[..., (np.arange(nsubc) - nsubc // 2) % dft] = grid
    x = np.fft.ifft(bins, axis=-1) * dft
    return np.concatenate([np.concatenate([x[:, l, dft - cp:], x[:, l]], axis=-1)
                           for l, cp in enumerate(cp_lengths(dft, mu, slot))], axis=-1)


def store(grid: np.ndarray, precision: str) -> np.ndarray:
    """The grid rounded to bfloat16 or (the control) float8 e4m3, per real part."""
    dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}[precision]
    pairs = torch.as_tensor(np.stack([grid.real, grid.imag], -1).astype(np.float32))
    r = pairs.to(dtype).to(torch.float64).numpy()
    return r[..., 0] + 1j * r[..., 1]


def assemble(request, tx_data, cell: dict, device, precision: str = "bf16"):
    """(grid complex64 (P, 14, nsubc), samples float32 (P, nsamples, 2)) of
    one DL slot on `cell`; `precision` is how the grid is stored: "bf16"
    as the configuration states, "fp8" for the control.  `device` runs the
    LDPC encoder."""
    nsubc = cell["nof_rb"] * 12
    grid = np.zeros((cell["nof_tx_ports"], NSYM, nsubc), np.complex128)
    for pdu, tb in zip(request.pdsch, tx_data.tb_bits):
        map_pdsch(grid, pdu, tb, request.slot, device)
    for pdu in request.pdcch:
        map_pdcch(grid, pdu, request.slot)
    for pdu in request.ssb:
        k = cell.get("ssb_subc_offset", 0) + 12 * pdu.ssb_offset_pointa + pdu.ssb_subcarrier_offset
        grid[:, 0:4, k:k + 240] += port_vector(pdu.precoding, grid.shape[0])[:, None, None] * \
            ssb_block(pdu)[None]
    for pdu in request.csi_rs:
        map_csi_rs(grid, pdu, request.slot)
    grid = store(grid, precision)
    x = ofdm(grid, cell["dft_size"], cell["numerology"], request.slot)
    return (grid.astype(np.complex64),
            np.stack([x.real, x.imag], -1).astype(np.float32))
