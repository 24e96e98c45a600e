"""PyTorch port, the whole PUSCH receive slot against the JAX program.

Slots come from the JAX transmitter (`models/ulsch_tx.build_ulsch_tx_slot`)
at 24 PRB, DFT 512, 30 kHz: the layer grids are mixed onto 4 rx ports by a
fixed well-conditioned matrix, noise is added, the JAX OFDM modulator makes
the samples, and a delay of a few samples and a 300 Hz frequency offset
exercise the TA and CFO estimators.  The same samples go through the JAX
`build_pusch_rx_slot` (its default CPU path) and the port's.

Tolerances and why:
  * tb_crc_ok, cb_crc_ok, tb_bits_cb: equal.
  * harq_soft: equal except at positions traced to demapper quantization
    ties (the two float32 pipelines differ in the last ulp, which can move a
    value across a rounding midpoint by +/-1 LSB, and a HARQ promotion sum can
    then push one side past +/-120 to +/-127); at most 0.1% of positions.
  * ldpc_iterations: equal on every codeblock without such a position.
  * snr_db within 1e-3 dB, evm within 1e-5 (float32 summation order; both
    measured at ~1e-6); ta_s within 1e-8 s (one 4096-point IDFT sample is
    8.1 ns, so an argmax tie may move it by one sample).
"""

import importlib.util
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig as JaxConfig
from srsran_projectvtlmo_tpu.models.pusch_rx import build_pusch_rx_slot as jax_rx_slot
from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu.ops import ofdm as jax_ofdm
from srsran_projectvtlmo_tpu.ran.modulation import Modulation

from srsran_projectvtlmo_tpu_torch.fixture import load_fixture
from srsran_projectvtlmo_tpu_torch.models.pusch_rx import (
    PuschRxConfig, build_pusch_rx_from_grid, build_pusch_rx_slot, flatten_tb_bits)
from srsran_projectvtlmo_tpu_torch.ops import ofdm
from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode
from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import BaseGraph
from tests.test_torch_host_copies import port_kw, port_mod

REPO = Path(__file__).resolve().parent.parent
CFO_HZ = 300.0


def _configs(**kw):
    base = dict(nof_rb=24, modulation=Modulation.QAM64, target_code_rate=0.6, nof_rx_ports=4,
                dft_size=512, numerology=1)
    base.update(kw)
    return JaxConfig(**base), PuschRxConfig(**port_kw(base))


def _mix(layers: np.ndarray, nports: int) -> np.ndarray:
    """(B, L, 14, S) complex layer grids -> (B, P, 14, S) through a fixed matrix."""
    nl = layers.shape[1]
    m = np.exp(-2j * np.pi * np.outer(np.arange(nports), np.arange(nl)) / 4) / 2.0
    return np.einsum("pl,blsk->bpsk", m, layers)


class _Slots:
    """Tx grids of one config; samples at a noise level from a seed."""

    def __init__(self, jcfg, batch, seed):
        rng = np.random.default_rng(seed)
        self.tb = rng.integers(0, 2, (batch, jcfg.tbs)).astype(np.uint8)
        g = np.asarray(build_ulsch_tx_slot(jcfg)(jnp.asarray(self.tb))[0])
        if jcfg.nof_layers == 1:
            g = g[:, None]
        self.clean = _mix(g[..., 0] + 1j * g[..., 1], jcfg.nof_rx_ports)
        self.cfg = jcfg

    def samples(self, sigma, seed, delay, cfo_hz=CFO_HZ):
        """Noise of std `sigma` per component, a `delay`-sample delay, a CFO."""
        rng = np.random.default_rng(seed)
        rx = self.clean + sigma * (rng.normal(size=self.clean.shape)
                                   + 1j * rng.normal(size=self.clean.shape))
        pair = np.stack([rx.real, rx.imag], -1).astype(np.float32)
        s = np.asarray(jax_ofdm.ofdm_modulate(jnp.asarray(pair), self.cfg.dft_size, 1, 0))
        sc = np.roll(s[..., 0] + 1j * s[..., 1], delay, axis=-1)
        sc = sc * np.exp(2j * np.pi * cfo_hz * np.arange(sc.shape[-1])
                         / (self.cfg.dft_size * self.cfg.scs_hz))
        return np.stack([sc.real, sc.imag], -1).astype(np.float32)


def _compare(jax_out, port_out, seg, max_tie_share=1e-3):
    """Assert the module docstring's tolerances; returns the tie count."""
    assert set(jax_out) == set(port_out)
    if jax_out["harq_soft"] is None:  # emit_harq_soft=False
        assert port_out["harq_soft"] is None
        jax_out, port_out = dict(jax_out), dict(port_out)
        del jax_out["harq_soft"], port_out["harq_soft"]
    j = {k: np.asarray(v) for k, v in jax_out.items()}
    t = {k: v.numpy() for k, v in port_out.items()}
    for key in ("tb_crc_ok", "cb_crc_ok", "tb_bits_cb"):
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        assert t[key].dtype == j[key].dtype, key
    ties = np.zeros(j["cb_crc_ok"].shape + (1,), bool)
    if "harq_soft" in j:
        ties = t["harq_soft"] != j["harq_soft"]
        assert t["harq_soft"].dtype == np.int8 and t["harq_soft"].shape == j["harq_soft"].shape
    assert ties.sum() <= max_tie_share * ties.size, ties.sum()
    clean_cb = ~ties.any(axis=-1)
    np.testing.assert_array_equal(t["ldpc_iterations"][clean_cb], j["ldpc_iterations"][clean_cb])
    assert t["ldpc_iterations"].dtype == np.int32
    np.testing.assert_allclose(t["snr_db"], j["snr_db"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(t["evm"], j["evm"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(t["ta_s"], j["ta_s"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(t["harq_ack_bits"], j["harq_ack_bits"])
    np.testing.assert_array_equal(t["harq_ack_metric"], j["harq_ack_metric"])
    assert t["tb_bits_cb"].shape == (t["tb_crc_ok"].shape[0], seg.nof_cb,
                                     seg.nof_payload_bits_per_cb - seg.cb_crc_bits)
    return int(ties.sum())


@pytest.mark.parametrize("nof_layers,dmrs,delay,mod", [
    (2, (2, 11), 1, Modulation.QAM64), (1, (2, 7), 3, Modulation.QAM64),
    (4, (2, 11), 1, Modulation.QAM16)])
def test_slot_matches_jax(nof_layers, dmrs, delay, mod):
    """4 rx ports; 2 layers (the CDM-despreading estimator branch), 1 layer
    (the SIMO branch) and 4 layers (both CDM groups, the batched-inverse
    MMSE), each with two DM-RS symbols so the CFO is estimated and
    compensated."""
    jcfg, tcfg = _configs(nof_layers=nof_layers, dmrs_symbols=dmrs, modulation=mod)
    slots = _Slots(jcfg, batch=2, seed=4)
    x = slots.samples(0.05, seed=5, delay=delay)
    jo = jax_rx_slot(jcfg)(jnp.asarray(x))
    to = build_pusch_rx_slot(tcfg, device="cpu")(torch.as_tensor(x))
    _compare(jo, to, tcfg.segmentation)
    assert to["tb_crc_ok"].all()
    np.testing.assert_array_equal(flatten_tb_bits(to["tb_bits_cb"].numpy(), tcfg.tbs), slots.tb)
    np.testing.assert_allclose(to["ta_s"].numpy(), delay / (512 * 30e3), rtol=1e-5)


def test_slot_options_match_jax():
    """The non-default settings the port carries: float32 grid, no CFO
    compensation (on a slot without CFO), no soft-buffer output."""
    opts = dict(nof_layers=2, dmrs_symbols=(2, 11), grid_bf16=False, compensate_cfo=False,
                emit_harq_soft=False)
    jcfg, tcfg = _configs(**opts)
    slots = _Slots(jcfg, batch=1, seed=6)
    x = slots.samples(0.05, seed=7, delay=1, cfo_hz=0.0)
    to = build_pusch_rx_slot(tcfg, device="cpu")(torch.as_tensor(x))
    _compare(jax_rx_slot(jcfg)(jnp.asarray(x)), to, tcfg.segmentation)
    assert to["tb_crc_ok"].all()


def test_harq_combining_matches_jax():
    """Two transmissions at a noise level where the first decodes only some
    codeblocks: the second combines into the first's soft buffer.  The port's
    buffer and the JAX buffer (converted through numpy) give the same result."""
    jcfg, tcfg = _configs(nof_layers=2, dmrs_symbols=(2, 11))
    slots = _Slots(jcfg, batch=2, seed=4)
    x1, x2 = slots.samples(0.06, seed=1, delay=3), slots.samples(0.06, seed=2, delay=3)
    jrx, trx = jax_rx_slot(jcfg), build_pusch_rx_slot(tcfg, device="cpu")
    j1, t1 = jrx(jnp.asarray(x1)), trx(torch.as_tensor(x1))
    _compare(j1, t1, tcfg.segmentation)
    assert 0 < int(t1["cb_crc_ok"].sum()) < t1["cb_crc_ok"].numel()
    j2 = jrx(jnp.asarray(x2), j1["harq_soft"])
    _compare(j2, trx(torch.as_tensor(x2), t1["harq_soft"]), tcfg.segmentation)
    from_jax = trx(torch.as_tensor(x2), torch.as_tensor(np.asarray(j1["harq_soft"])))
    _compare(j2, from_jax, tcfg.segmentation)


def test_from_grid_rejects_wrong_shape_and_defers_other_settings():
    _, tcfg = _configs(nof_layers=2)
    rx = build_pusch_rx_from_grid(tcfg, device="cpu")
    with pytest.raises(ValueError):
        rx(torch.zeros((1, 3, 14, tcfg.nof_subc, 2)))
    for kw in (dict(nof_harq_ack_bits=2), dict(hop_symbol=7, second_hop_prb=4),
               dict(dmrs_config_type=2), dict(dynamic_params=True), dict(equalizer="zf"),
               dict(decode_sch=False)):
        with pytest.raises(NotImplementedError):
            build_pusch_rx_slot(_configs(**kw)[1], device="cpu")


def _fixture_tool():
    spec = importlib.util.spec_from_file_location("make_torch_fixture",
                                                  REPO / "tools" / "make_torch_fixture.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fixture_round_trip_and_decode(tmp_path):
    """A small-shape fixture written by the generator loads back intact, and
    the steps chip_smoke.py runs on it at the north-star shape (mix, noise,
    the port's OFDM modulator, the port's receiver) decode its TB bits; its
    LDPC codewords decode clean at the first iteration."""
    tool = _fixture_tool()
    arrays = tool.make_fixture(24, "QAM64", 0.6, 2, 4, 512, batch=2, seed=3,
                               ldpc_cases=((1, 64, 24), (2, 2, 16)), ldpc_count=2)
    path = os.path.join(tmp_path, "fx.npz")
    np.savez_compressed(path, **arrays)
    fx = load_fixture(path)
    assert fx["cfg"]["nof_rb"] == 24 and fx["cfg"]["modulation"] == "QAM64"
    jcfg, tcfg = _configs(nof_layers=2)
    assert fx["cfg"]["tbs"] == tcfg.tbs
    assert fx["layer_grids"].shape == (2, 2, 14, tcfg.nof_subc, 2)
    assert fx["tb_bits"].shape == (2, tcfg.tbs) and fx["tb_bits"].dtype == np.uint8

    layers = fx["layer_grids"][..., 0] + 1j * fx["layer_grids"][..., 1]
    rx = _mix(layers, 4) + 0.005 * np.random.default_rng(0).normal(size=(2, 4, 14, tcfg.nof_subc))
    pair = torch.as_tensor(np.stack([rx.real, rx.imag], -1).astype(np.float32))
    out = build_pusch_rx_slot(tcfg, device="cpu")(ofdm.ofdm_modulate(pair, 512, 1, 0))
    assert out["tb_crc_ok"].all() and out["cb_crc_ok"].all()
    np.testing.assert_array_equal(flatten_tb_bits(out["tb_bits_cb"].numpy(), tcfg.tbs), fx["tb_bits"])

    for case in fx["ldpc"]:
        z = case["z"]
        k = (22 if case["bg"] == 1 else 10) * z
        llr = ((1 - 2 * case["codewords"].astype(np.int32)) * 10).astype(np.int8)
        llr[:, k - 2 * z - case["filler"]:k - 2 * z] = 127
        hard, _, ok, iters = decode.ldpc_decode_es(torch.as_tensor(llr), BaseGraph(case["bg"]), z,
                                                   case["crc"], case["kp"], nof_iterations=3)
        assert ok.all() and (iters == 1).all()
        np.testing.assert_array_equal(hard.numpy()[:, 2 * z:k], case["codewords"][:, :k - 2 * z])


def test_committed_fixture_matches_north_star_shape():
    fx = load_fixture(REPO / "srsran_projectvtlmo_tpu_torch" / "data" / "northstar_fixture.npz")
    cfg = PuschRxConfig(nof_rb=273, modulation=port_mod(Modulation.QAM256),
                        target_code_rate=948 / 1024,
                        nof_rx_ports=4, nof_layers=2, dft_size=4096, numerology=1)
    assert fx["cfg"]["tbs"] == cfg.tbs == 638984
    assert fx["layer_grids"].shape[1:] == (2, 14, 3276, 2)
    assert fx["tb_bits"].shape == (fx["layer_grids"].shape[0], cfg.tbs)
    assert sorted((c["bg"], c["z"]) for c in fx["ldpc"]) == \
        [(1, 208), (1, 352), (1, 384), (2, 2), (2, 40), (2, 104)]
