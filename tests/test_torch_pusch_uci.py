"""PyTorch port, UCI on PUSCH against the JAX package: the transmitter with
HARQ-ACK and CSI fields, the one-phase receiver, and the CSI part-1 ->
part-2 protocol (phase A, phase B, `PuschUciProcessor`).

Slots are made at 12 PRB, DFT 256, 30 kHz (the polar codes stay at N <= 256):
the JAX transmitter's layer grids go through the receive-slot tests' fixed
mix onto 4 rx ports, noise, a 1-sample delay and a 300 Hz CFO
(`tests/test_torch_pusch_rx._Slots`), and the same samples go through both
receivers.

Tolerances and why:
  * Tx grids: 1e-5 absolute (mapper and DM-RS values copied; the placement,
    scrambling and UCI codewords are bit work and equal).
  * SCH outputs: as `tests/test_torch_pusch_rx._compare` (CRC verdicts and TB
    bits equal; `harq_soft` equal up to demapper quantization ties).
  * UCI bits and polar CRC verdicts: equal.  Short-block metrics: within
    rtol 1e-5 (exact integer correlations, normalised in another order).
  * Phase B: fed the same codeword LLRs in both packages, every output
    (CSI part 2, CRCs, TB bits, `harq_soft`, iterations) is equal.
  * Placements: equal to `tests/vectors/ulsch_demux_reference.npz`, the
    reference C++ demultiplexer's output.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig as JaxConfig
from srsran_projectvtlmo_tpu.models.pusch_rx import cached_pusch_phase_b as jax_phase_b
from srsran_projectvtlmo_tpu.models.pusch_rx import cached_pusch_rx_from_grid as jax_from_grid
from srsran_projectvtlmo_tpu.models.pusch_rx import build_pusch_rx_slot as jax_rx_slot
from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot as jax_tx_slot
from srsran_projectvtlmo_tpu.phy.pusch_uci import PuschUciConfig as JaxUciConfig
from srsran_projectvtlmo_tpu.phy.pusch_uci import PuschUciProcessor as JaxUciProcessor
from srsran_projectvtlmo_tpu.ran.modulation import Modulation

from srsran_projectvtlmo_tpu_torch.models.pusch_rx import (
    PuschRxConfig, build_pusch_phase_b, build_pusch_rx_from_grid, build_pusch_rx_slot,
    cached_demux_plan, dmrs_reference, flatten_tb_bits)
from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu_torch.ops import prg
from srsran_projectvtlmo_tpu_torch.ops.ulsch_demux import (
    build_ulsch_demux_plan, placeholder_fix_signs)
from srsran_projectvtlmo_tpu_torch.phy.pusch_uci import PuschUciConfig, PuschUciProcessor
from srsran_projectvtlmo_tpu_torch.ran.modulation import bits_per_symbol
from srsran_projectvtlmo_tpu_torch.ran.sch import sch_segmentation_info
from srsran_projectvtlmo_tpu_torch.ran.ulsch_info import get_ulsch_information
from srsran_projectvtlmo_tpu_torch.utils.cplx import np_to_pair
from tests.test_torch_host_copies import port_rx_kw
from tests.test_torch_pusch_rx import _compare, _mix

T = torch.as_tensor
VECTORS = Path(__file__).parent / "vectors"
BASE = dict(nof_rb=12, modulation=Modulation.QAM16, target_code_rate=0.5, nof_rx_ports=4,
            dft_size=256, numerology=1, dmrs_symbols=(2, 11), rnti=0x3C21, n_id=301, slot=1)
UCI_KEYS = ("csi1_bits", "csi1_metric", "csi2_bits", "csi2_metric", "harq_ack_bits",
            "harq_ack_metric")

#: (name, configuration, payload sizes): all three fields with a 2-bit ACK
#: that punctures the SCH, CRC11 polar CSI part 1 and part 2; a 40-bit polar
#: ACK rate-matched around the SCH at 1 layer; 1-bit ACK placeholders with
#: short-block CSI on QPSK.
CASES = {
    "ack2_csi20_48": dict(nof_layers=2, nof_harq_ack_bits=2, nof_csi_part1_bits=20,
                          nof_csi_part2_bits=48),
    "ack40": dict(nof_layers=1, nof_harq_ack_bits=40),
    "ack1_csi5_3_qpsk": dict(nof_layers=1, modulation=Modulation.QPSK, nof_harq_ack_bits=1,
                             nof_csi_part1_bits=5, nof_csi_part2_bits=3),
}


def _configs(**kw):
    cfg = {**BASE, **kw}
    return JaxConfig(**cfg), PuschRxConfig(**port_rx_kw(cfg))


def _payloads(cfg, batch, rng, csi2=None):
    sizes = {"ack_bits": cfg.nof_harq_ack_bits, "csi1_bits": cfg.nof_csi_part1_bits,
             "csi2_bits": cfg.nof_csi_part2_bits if csi2 is None else csi2}
    return {k: rng.integers(0, 2, (batch, n)).astype(np.uint8) for k, n in sizes.items() if n}


def _samples(jcfg, grid, seed, sigma=0.03, delay=1, cfo_hz=300.0):
    """JAX Tx grid (B[, L], 14, S, 2) -> 4-port samples with noise, delay, CFO."""
    from srsran_projectvtlmo_tpu.ops import ofdm as jax_ofdm

    g = grid if jcfg.nof_layers > 1 else grid[:, None]
    clean = _mix(g[..., 0] + 1j * g[..., 1], jcfg.nof_rx_ports)
    rng = np.random.default_rng(seed)
    rx = clean + sigma * (rng.normal(size=clean.shape) + 1j * rng.normal(size=clean.shape))
    pair = np.stack([rx.real, rx.imag], -1).astype(np.float32)
    s = np.asarray(jax_ofdm.ofdm_modulate(jnp.asarray(pair), jcfg.dft_size, 1, jcfg.slot % 2))
    sc = np.roll(s[..., 0] + 1j * s[..., 1], delay, axis=-1)
    sc = sc * np.exp(2j * np.pi * cfo_hz * np.arange(sc.shape[-1]) / (jcfg.dft_size * jcfg.scs_hz))
    return np.stack([sc.real, sc.imag], -1).astype(np.float32), pair


def compare_uci(jo, to, seg):
    """The module docstring's tolerances for a result with UCI fields."""
    j = {k: jo.pop(k) for k in UCI_KEYS if k in jo}
    t = {k: to.pop(k) for k in UCI_KEYS if k in to}
    assert set(j) == set(t)
    for key in j:
        a, b = t[key].numpy(), np.asarray(j[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        if key.endswith("bits"):
            np.testing.assert_array_equal(a, b, err_msg=key)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0, err_msg=key)
    to["harq_ack_bits"], jo["harq_ack_bits"] = t["harq_ack_bits"], j["harq_ack_bits"]
    to["harq_ack_metric"] = torch.as_tensor(np.array(j["harq_ack_metric"]))
    jo["harq_ack_metric"] = j["harq_ack_metric"]
    if seg is not None:
        _compare(jo, to, seg)
    return t


def dynamic_inputs(rx_cfg, ue_cfgs):
    """Per-row call inputs of a `dynamic_params` receiver, built on the host
    as the multi-cell path builds them: DM-RS references, descrambling signs
    from cinit = (rnti << 15) + n_id, and UCI placeholder fix signs."""
    qm = bits_per_symbol(rx_cfg.modulation)
    plan, _ = cached_demux_plan(rx_cfg)
    refs, signs, fixes = [], [], {"ack": [], "csi1": [], "csi2": []}
    for ue in ue_cfgs:
        refs.append(np_to_pair(dmrs_reference(ue)))
        scr = prg.gold_sequence_bits(ue.scrambling_cinit(), rx_cfg.nof_codeword_bits)
        signs.append(1 - 2 * scr.astype(np.int8))
        for name, payload in (("ack", rx_cfg.nof_harq_ack_bits),
                              ("csi1", rx_cfg.nof_csi_part1_bits),
                              ("csi2", rx_cfg.nof_csi_part2_bits)):
            if payload:
                fixes[name].append(placeholder_fix_signs(plan.field_bit_idx(name), payload, qm,
                                                         scr).astype(np.int8))
    uci_fix = tuple(np.stack(fixes[n]) if fixes[n] else None for n in ("ack", "csi1", "csi2"))
    return np.stack(refs), np.stack(signs), uci_fix


class _Case:
    """One configuration's JAX and port Tx outputs, and a noisy slot."""

    def __init__(self, kw, batch=2, seed=3):
        self.jcfg, self.tcfg = _configs(**kw)
        rng = np.random.default_rng(seed)
        self.tb = rng.integers(0, 2, (batch, self.tcfg.tbs)).astype(np.uint8)
        self.uci = _payloads(self.tcfg, batch, rng)
        self.jgrid = np.asarray(jax_tx_slot(self.jcfg)(
            jnp.asarray(self.tb), **{k: jnp.asarray(v) for k, v in self.uci.items()})[0])
        self.samples, _ = _samples(self.jcfg, self.jgrid, seed + 1)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    return _Case(CASES[request.param])


def test_ulsch_tx_with_uci_matches_jax(case):
    grid, samples = build_ulsch_tx_slot(case.tcfg, device="cpu")(
        torch.as_tensor(case.tb), **{k: torch.as_tensor(v) for k, v in case.uci.items()})
    assert grid.shape == case.jgrid.shape and samples.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), case.jgrid, rtol=0, atol=1e-5)


def test_rx_with_uci_matches_jax(case):
    jo = dict(jax_rx_slot(case.jcfg)(jnp.asarray(case.samples)))
    to = dict(build_pusch_rx_slot(case.tcfg, device="cpu")(torch.as_tensor(case.samples)))
    t = compare_uci(jo, to, case.tcfg.segmentation)
    assert to["tb_crc_ok"].all()
    np.testing.assert_array_equal(flatten_tb_bits(to["tb_bits_cb"].numpy(), case.tcfg.tbs),
                                  case.tb)
    for name, sent in case.uci.items():
        key = "harq_ack_bits" if name == "ack_bits" else name
        np.testing.assert_array_equal(t[key].numpy(), sent, err_msg=key)


def test_ulsch_tx_and_rx_take_a_part2_size_bucket():
    """`nof_csi_part2_bits` of the Tx overrides the configured size, as a
    two-phase bucket does (held against JAX's in the `two_phase` fixture);
    a one-phase receiver of that size decodes it."""
    jcfg, tcfg = _configs(nof_layers=1, nof_csi_part1_bits=3)
    rng = np.random.default_rng(8)
    tb = rng.integers(0, 2, (1, tcfg.tbs)).astype(np.uint8)
    uci = _payloads(tcfg, 1, rng, csi2=14)
    grid, _ = build_ulsch_tx_slot(tcfg, device="cpu", nof_csi_part2_bits=14)(
        torch.as_tensor(tb), **{k: torch.as_tensor(v) for k, v in uci.items()})
    rx_cfg = dataclasses.replace(tcfg, nof_csi_part2_bits=14)
    samples, _ = _samples(jcfg, grid.numpy(), seed=9)
    out = build_pusch_rx_slot(rx_cfg, device="cpu")(torch.as_tensor(samples))
    np.testing.assert_array_equal(out["csi2_bits"].numpy(), uci["csi2_bits"])
    assert out["tb_crc_ok"].all() and out["csi2_metric"].numpy().all()


#: Two-phase protocol: 6-bit CSI part 1 whose value picks the part-2 size.
PART2_MAP = tuple((0, 20, 9, 12)[v % 4] for v in range(64))


@pytest.fixture(scope="module")
def two_phase():
    jcfg, tcfg = _configs(nof_layers=2, nof_harq_ack_bits=2, nof_csi_part1_bits=6)
    rng = np.random.default_rng(11)
    batches = []
    for csi1_value in (5, 4):  # -> part 2 of 20 bits (polar), and none
        size = PART2_MAP[csi1_value]
        tb = rng.integers(0, 2, (2, tcfg.tbs)).astype(np.uint8)
        uci = _payloads(tcfg, 2, rng, csi2=size)
        uci["csi1_bits"][:] = [(csi1_value >> (5 - i)) & 1 for i in range(6)]
        grid = np.asarray(jax_tx_slot(jcfg, size)(
            jnp.asarray(tb), **{k: jnp.asarray(v) for k, v in uci.items()})[0])
        tgrid = build_ulsch_tx_slot(tcfg, device="cpu", nof_csi_part2_bits=size)(
            torch.as_tensor(tb), **{k: torch.as_tensor(v) for k, v in uci.items()})[0]
        np.testing.assert_allclose(tgrid.numpy(), grid, rtol=0, atol=1e-5)
        _, rx_grid = _samples(jcfg, grid, seed=12 + csi1_value, delay=0, cfo_hz=0.0)
        batches.append((size, tb, uci, rx_grid))
    return jcfg, tcfg, batches


def test_phase_a_then_phase_b_match_jax(two_phase):
    """Phase A's codeword LLRs agree up to demapper ties; phase B, fed the
    same LLRs in both packages, agrees exactly.  The JAX programs are the
    cached ones its processor runs, so they compile once for both tests."""
    jcfg, tcfg, batches = two_phase
    ja = jax_from_grid(dataclasses.replace(jcfg, decode_sch=False))
    ta = build_pusch_rx_from_grid(dataclasses.replace(tcfg, decode_sch=False), device="cpu")
    for size, tb, uci, grid in batches:
        jo, to = dict(ja(jnp.asarray(grid))), dict(ta(torch.as_tensor(grid)))
        llr_j, llr_t = np.asarray(jo.pop("codeword_llr")), to.pop("codeword_llr").numpy()
        assert llr_t.dtype == np.int8 and llr_t.shape == (2, tcfg.nof_codeword_bits)
        ties = llr_t != llr_j
        assert ties.sum() <= 1e-3 * ties.size and np.abs(llr_t - llr_j.astype(int)).max() <= 1
        t = compare_uci(jo, to, None)
        np.testing.assert_array_equal(t["csi1_bits"].numpy(), uci["csi1_bits"])
        np.testing.assert_array_equal(t["harq_ack_bits"].numpy(), uci["ack_bits"])
        for key in ("snr_db", "evm", "ta_s"):
            np.testing.assert_allclose(to[key].numpy(), np.asarray(jo[key]), rtol=0, atol=1e-3)

        jb = dict(jax_phase_b(jcfg, size)(jnp.asarray(llr_j)))
        tb_out = dict(build_pusch_phase_b(tcfg, size, device="cpu")(torch.as_tensor(llr_j.copy())))
        assert set(jb) == set(tb_out)
        for key, val in jb.items():
            np.testing.assert_array_equal(tb_out[key].numpy(), np.asarray(val), err_msg=key)
        np.testing.assert_array_equal(flatten_tb_bits(tb_out["tb_bits_cb"].numpy(), tcfg.tbs), tb)
        if size:
            np.testing.assert_array_equal(tb_out["csi2_bits"].numpy(), uci["csi2_bits"])


def test_uci_processor_matches_jax(two_phase):
    jcfg, tcfg, batches = two_phase
    jproc = JaxUciProcessor(JaxUciConfig(rx=jcfg, part2_size_map=PART2_MAP))
    tproc = PuschUciProcessor(PuschUciConfig(rx=tcfg, part2_size_map=PART2_MAP), device="cpu")
    for size, tb, uci, grid in batches:
        jo, to = jproc.process(jnp.asarray(grid)), tproc.process(torch.as_tensor(grid))
        assert set(jo) == set(to) and to["csi2_size"] == jo["csi2_size"] == size
        np.testing.assert_array_equal(to["tb_bits"], tb)
        np.testing.assert_array_equal(to["csi1_bits"], uci["csi1_bits"])
        np.testing.assert_array_equal(to["harq_ack_bits"], uci["ack_bits"])
        for key in ("tb_bits", "csi1_bits", "csi1_valid", "harq_ack_bits", "tb_crc_ok",
                    "cb_crc_ok") + (("csi2_bits", "csi2_valid", "csi2_metric") if size else ()):
            np.testing.assert_array_equal(np.asarray(to[key]), np.asarray(jo[key]), err_msg=key)
        if size:
            np.testing.assert_array_equal(np.asarray(to["csi2_bits"]), uci["csi2_bits"])


def test_uci_processor_dynamic_inputs_match_static(two_phase):
    """In dynamic mode the processor takes the DM-RS references, the
    descrambling and ACK/CSI-1 fix signs and the scrambling rows as inputs and
    makes the phase-B CSI-2 fix signs itself: the same decisions and bits as
    the static processor, whose tables are baked from the configuration."""
    _, tcfg, batches = two_phase
    static = PuschUciProcessor(PuschUciConfig(rx=tcfg, part2_size_map=PART2_MAP), device="cpu")
    dyn_cfg = dataclasses.replace(tcfg, dynamic_params=True)
    dyn = PuschUciProcessor(PuschUciConfig(rx=dyn_cfg, part2_size_map=PART2_MAP), device="cpu")
    scr = prg.gold_sequence_bits(tcfg.scrambling_cinit(), tcfg.nof_codeword_bits)
    ref, signs, uci_fix = dynamic_inputs(dyn_cfg, [tcfg, tcfg])
    for size, tb, uci, grid in batches:
        a = static.process(T(grid))
        b = dyn.process(T(grid), None, T(ref), T(signs), tuple(None if f is None else T(f)
                                                             for f in uci_fix), [scr, scr])
        assert set(a) == set(b) and b["csi2_size"] == size
        for key in ("tb_bits", "csi1_bits", "harq_ack_bits", "tb_crc_ok", "harq_soft") + \
                (("csi2_bits", "csi2_metric") if size else ()):
            np.testing.assert_array_equal(np.asarray(b[key]), np.asarray(a[key]), err_msg=key)
        np.testing.assert_array_equal(b["tb_bits"], tb)


def test_uci_processor_rejects_mixed_sizes_and_no_part1(two_phase):
    """As the JAX processor: one part-2 size per batch, and part-1 bits needed."""
    _, tcfg, batches = two_phase
    with pytest.raises(ValueError):
        PuschUciProcessor(PuschUciConfig(rx=dataclasses.replace(tcfg, nof_csi_part1_bits=0),
                                         part2_size_map=(0,)), device="cpu")
    proc = PuschUciProcessor(PuschUciConfig(rx=tcfg, part2_size_map=PART2_MAP), device="cpu")
    assert proc.csi2_sizes(np.array([[0, 0, 0, 1, 0, 1], [0, 0, 0, 1, 1, 0]])) == [20, 9]
    mixed = np.concatenate([batches[0][3][:1], batches[1][3][:1]])  # part 2 of 20 and of 0
    with pytest.raises(ValueError, match="mixed csi2 sizes"):
        proc.process(T(mixed))


with np.load(VECTORS / "ulsch_demux_reference.npz") as _z:
    _DEMUX = {k: _z[k] for k in _z.files}
_DEMUX_KEYS = sorted({k.split("_")[0] for k in _DEMUX}, key=lambda k: int(k[3:]))


def _lcg_stream(nof_bits: int, state: int = 0x5EED0001):
    """The reference dumper's LCG: per bit an LLR in [-90, 90] without 0 and a
    scrambling bit (as tests/test_ulsch_demux_parity.py)."""
    llr = np.empty(nof_bits, np.int8)
    scr = np.empty(nof_bits, np.uint8)
    for i in range(nof_bits):
        state = (state * 1664525 + 1013904223) & 0xFFFFFFFF
        val = (state >> 8) % 181 - 90
        llr[i] = 1 if val == 0 else val
        scr[i] = (state >> 24) & 1
    return llr, scr


@pytest.mark.parametrize("key", _DEMUX_KEYS)
def test_uci_placement_matches_reference_vectors(key):
    """The port's UCI budgets and placement plan, and the receiver's field
    steps on torch tensors (gather, placeholder fix signs, the <= 2-bit ACK
    puncture zeroing), against the reference demultiplexer."""
    prb, qm, layers, rate_x1000, tbs, o_ack, o_csi1, o_csi2 = (int(v) for v in _DEMUX[f"{key}_meta"])
    dmrs = tuple(int(s) for s in _DEMUX[f"{key}_dmrs"])
    seg = sch_segmentation_info(tbs, rate_x1000 / 1000.0)
    info = get_ulsch_information(
        nof_rb=prb, start_symbol_index=0, nof_symbols=14, dmrs_symbols=dmrs, nof_layers=layers,
        qm=qm, target_code_rate=rate_x1000 / 1000.0, tbs=tbs,
        sum_nof_cb_size=seg.nof_cb * seg.nof_bits_per_cb, nof_harq_ack_bits=o_ack,
        nof_csi_part1_bits=o_csi1, nof_csi_part2_bits=o_csi2)
    for name, field in (("G_sch", "nof_ul_sch_bits"), ("G_ack", "nof_harq_ack_bits"),
                        ("G_ack_rvd", "nof_harq_ack_rvd"), ("G_csi1", "nof_csi_part1_bits"),
                        ("G_csi2", "nof_csi_part2_bits")):
        assert getattr(info, field) == _DEMUX[f"{key}_{name}"][0], name
    plan = build_ulsch_demux_plan(
        nof_prb=prb, start_symbol_index=0, nof_symbols=14, dmrs_symbols=dmrs, qm=qm,
        nof_layers=layers, nof_harq_ack_bits=o_ack, nof_enc_harq_ack_bits=info.nof_harq_ack_bits,
        nof_harq_ack_rvd=info.nof_harq_ack_rvd, nof_csi_part1_bits=o_csi1,
        nof_enc_csi_part1_bits=info.nof_csi_part1_bits, nof_csi_part2_bits=o_csi2,
        nof_enc_csi_part2_bits=info.nof_csi_part2_bits)
    llr_np, scr = _lcg_stream((14 - len(dmrs)) * prb * 12 * qm * layers)
    llr = torch.as_tensor(llr_np)[None]

    def field(name, payload):
        idx = plan.field_bit_idx(name)
        fix = torch.as_tensor(placeholder_fix_signs(idx, payload, qm, scr).astype(np.int32))
        return (llr[:, torch.as_tensor(idx)].to(torch.int32) * fix).to(torch.int8)[0].numpy()

    if o_ack:
        np.testing.assert_array_equal(field("ack", o_ack), _DEMUX[f"{key}_ack"])
    llr[:, torch.as_tensor(plan.punct_bit_idx)] = 0
    if o_csi1:
        np.testing.assert_array_equal(field("csi1", o_csi1), _DEMUX[f"{key}_csi1"])
    if o_csi2:
        np.testing.assert_array_equal(field("csi2", o_csi2), _DEMUX[f"{key}_csi2"])
    np.testing.assert_array_equal(llr[0, torch.as_tensor(plan.sch_bit_idx)].numpy(),
                                  _DEMUX[f"{key}_sch"])


def test_demux_plan_sizes_the_sch_from_ulsch_info():
    """UCI takes bits from the SCH: the codeblocks are rate matched to
    `ulsch_info().nof_ul_sch_bits`, and the cached plan is the plan."""
    jcfg, tcfg = _configs(**CASES["ack2_csi20_48"])
    plan, info = tcfg.demux_plan()
    jplan, jinfo = jcfg.demux_plan()
    assert dataclasses.asdict(info) == dataclasses.asdict(jinfo)
    for f in dataclasses.fields(jplan):
        np.testing.assert_array_equal(getattr(plan, f.name), getattr(jplan, f.name))
    assert info.nof_ul_sch_bits < tcfg.nof_codeword_bits
    assert sum(tcfg.cb_rate_match_sizes(info.nof_ul_sch_bits)) == info.nof_ul_sch_bits
    assert cached_demux_plan(tcfg)[1] == info
