"""PyTorch port, the UE-side UL-SCH transmitter, module by module against the
JAX package on the same numpy-seeded inputs, and against the stored
reference-C++ vectors where they exist.

Tolerances and why:
  * LDPC encode plan and codewords, segmentation, codeword bits, layer
    mapping, hard decisions: equal (integer and bit work).
  * modulate / modulate_planes / modulate_np: equal to JAX (the same float32
    operations in the same order); within 1e-6 of `mod_reference.npz`, the
    bound the JAX package's own reference test uses.
  * precode: 1e-6 absolute (complex float32 products summed in another order).
  * ulsch_tx grid: 1e-6 absolute (its values are the mapper's and the DM-RS
    table's, copied); samples: 1e-5 relative to the largest sample (the
    inverse FFT is pocketfft in both frameworks, summed in another order).
  * ChannelEmulator: equal (the same numpy code on the same seed).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models import channel as jax_channel
from srsran_projectvtlmo_tpu.models import sch_tx as jax_sch_tx
from srsran_projectvtlmo_tpu.models.pusch_rx import PuschRxConfig as JaxConfig
from srsran_projectvtlmo_tpu.models.ulsch_tx import build_ulsch_tx_slot as jax_ulsch_tx
from srsran_projectvtlmo_tpu.ops import demodulation as jax_demod
from srsran_projectvtlmo_tpu.ops import modulation as jax_mod
from srsran_projectvtlmo_tpu.ops import precoding as jax_prec
from srsran_projectvtlmo_tpu.ops.ldpc import graphs as jax_graphs
from srsran_projectvtlmo_tpu.ops.ldpc import segment as jax_segment
from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode as jax_encode
from srsran_projectvtlmo_tpu.ran.ldpc_params import ALL_LIFTING_SIZES, BaseGraph
from srsran_projectvtlmo_tpu.ran.modulation import Modulation, bits_per_symbol
from srsran_projectvtlmo_tpu.ran.sch import sch_segmentation_info

from srsran_projectvtlmo_tpu_torch.models import channel, sch_tx
from srsran_projectvtlmo_tpu_torch.models.pusch_rx import PuschRxConfig
from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu_torch.ops import demodulation, modulation, precoding
from srsran_projectvtlmo_tpu_torch.ops.ldpc import graphs, segment
from srsran_projectvtlmo_tpu_torch.ops.ldpc.encode import ldpc_encode
from tests.test_torch_host_copies import port_kw, port_mod

VECTORS = Path(__file__).parent / "vectors"


@pytest.mark.parametrize("bg", [BaseGraph.BG1, BaseGraph.BG2])
def test_encode_plan_equal_for_all_lifting_sizes(bg):
    for z in ALL_LIFTING_SIZES:
        a, b = jax_graphs.get_graph(bg, z).encode_plan, graphs.get_graph(bg, z).encode_plan
        assert (a.p0_shift, a.solve_order) == (b.p0_shift, b.solve_order), z
    for z in (2, 13):
        np.testing.assert_array_equal(graphs.lifted_parity_matrix(graphs.get_graph(bg, z)),
                                      jax_graphs.lifted_parity_matrix(jax_graphs.get_graph(bg, z)))


@pytest.mark.parametrize("batch", [2, 40])  # both sides of JAX's bit-packing switch at 8
@pytest.mark.parametrize("bg,z", [(BaseGraph.BG1, 13), (BaseGraph.BG2, 16), (BaseGraph.BG2, 40)])
def test_encoder_bit_exact_vs_jax(bg, z, batch):
    g = graphs.get_graph(bg, z)
    info = np.random.default_rng(z * batch).integers(0, 2, (batch, g.k)).astype(np.uint8)
    got = ldpc_encode(torch.as_tensor(info), bg, z).numpy()
    assert got.dtype == np.uint8 and got.shape == (batch, g.n_full * z)
    np.testing.assert_array_equal(got, np.asarray(jax_encode(jnp.asarray(info), bg, z)))
    syndrome = graphs.lifted_parity_matrix(g).astype(np.int64) @ got.T.astype(np.int64)
    assert not (syndrome % 2).any()


with np.load(VECTORS / "ldpc_reference.npz") as _z:
    _LDPC = {k: _z[k] for k in _z.files}


@pytest.mark.parametrize("key", sorted({k.rsplit("_", 1)[0] for k in _LDPC}))
def test_encoder_matches_reference_vectors(key):
    """Codewords of the reference C++ encoder (tools/ref_crossval)."""
    bg, z = BaseGraph(int(key.split("_")[0][2:])), int(key.split("_")[1][1:])
    cw = ldpc_encode(torch.as_tensor(_LDPC[f"{key}_msg"][None]), bg, z).numpy()[0]
    np.testing.assert_array_equal(cw[2 * z:], _LDPC[f"{key}_enc"], err_msg=key)


@pytest.mark.parametrize("tbs,rate", [(3000, 0.5), (20000, 0.6), (200, 0.3)])
def test_segmentation_bit_exact_vs_jax(tbs, rate):
    """Several codeblocks with CB CRCs, and one codeblock with a CRC16 TB CRC."""
    seg = sch_segmentation_info(tbs, rate)
    tb = np.random.default_rng(tbs).integers(0, 2, tbs).astype(np.uint8)
    cbs = segment.segment_tx(torch.as_tensor(tb), seg)
    np.testing.assert_array_equal(cbs.numpy(), np.asarray(jax_segment.segment_tx(tb, seg)))
    bad = cbs.clone()
    bad[0, 3] ^= 1
    for bits in (cbs, bad):
        got = segment.desegment_rx(bits, seg, tbs)
        want = jax_segment.desegment_rx(jnp.asarray(bits.numpy()), seg, tbs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert bool(segment.desegment_rx(cbs, seg, tbs)[1])
    assert not bool(segment.desegment_rx(bad, seg, tbs)[1])


@pytest.mark.parametrize("mod", list(Modulation))
def test_modulate_and_hard_demap_vs_jax(mod):
    qm = bits_per_symbol(mod)
    bits = np.random.default_rng(qm).integers(0, 2, (3, 30 * qm)).astype(np.uint8)
    tmod = port_mod(mod)
    got = modulation.modulate(torch.as_tensor(bits), tmod)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_mod.modulate(jnp.asarray(bits), mod)))
    np.testing.assert_array_equal(modulation.modulate_np(bits[0], tmod),
                                  jax_mod.modulate_np(bits[0], mod))
    llr = np.random.default_rng(5).integers(-127, 128, 300).astype(np.int8)
    np.testing.assert_array_equal(demodulation.hard_demap(torch.as_tensor(llr)).numpy(),
                                  np.asarray(jax_demod.hard_demap(jnp.asarray(llr))))
    if mod in (Modulation.QPSK, Modulation.QAM16, Modulation.QAM64, Modulation.QAM256):
        planes = bits.reshape(3, 30, qm).transpose(0, 2, 1).copy()  # (B, Qm, nsym)
        p_got = modulation.modulate_planes(torch.as_tensor(planes), tmod)
        np.testing.assert_array_equal(p_got.numpy(), got.numpy())
        np.testing.assert_array_equal(
            p_got.numpy(), np.asarray(jax_mod.modulate_planes(jnp.asarray(planes), mod)))


with np.load(VECTORS / "mod_reference.npz") as _m:
    _MOD = {k: _m[k] for k in _m.files}


@pytest.mark.parametrize("key", sorted({k.rsplit("_", 1)[0] for k in _MOD}))
def test_modulate_matches_reference_vectors(key):
    mod = {1: Modulation.BPSK, 2: Modulation.QPSK, 4: Modulation.QAM16,
           6: Modulation.QAM64, 8: Modulation.QAM256}[int(key.split("_")[0][2:])]
    bits = torch.as_tensor(_MOD[f"{key}_bits"][None])
    sym = modulation.modulate(bits, port_mod(mod))[0].numpy()
    got = np.stack([sym.real, sym.imag], -1).astype(np.float32)
    np.testing.assert_allclose(got, _MOD[f"{key}_sym"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("nof_layers,nof_ports", [(1, 1), (2, 4), (3, 4), (4, 4)])
def test_layer_mapping_and_precoding_vs_jax(nof_layers, nof_ports):
    rng = np.random.default_rng(nof_layers)
    sym = (rng.normal(size=(2, 12 * nof_layers)) + 1j * rng.normal(size=(2, 12 * nof_layers))
           ).astype(np.complex64)
    mapped = precoding.layer_map(torch.as_tensor(sym), nof_layers)
    np.testing.assert_array_equal(mapped.numpy(), np.asarray(jax_prec.layer_map(jnp.asarray(sym),
                                                                               nof_layers)))
    np.testing.assert_array_equal(precoding.layer_demap(mapped).numpy(), sym)
    np.testing.assert_array_equal(precoding.identity_precoder(nof_ports, nof_layers),
                                  jax_prec.identity_precoder(nof_ports, nof_layers))
    layers = np.stack([mapped.numpy().real, mapped.numpy().imag], -1).astype(np.float32)
    w = rng.normal(size=(nof_ports, nof_layers, 2)).astype(np.float32)
    got = precoding.precode(torch.as_tensor(layers), torch.as_tensor(w)).numpy()
    assert got.shape == (2, nof_ports, 12, 2)
    np.testing.assert_allclose(got, np.asarray(jax_prec.precode(jnp.asarray(layers), jnp.asarray(w))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("kw,reduced_g", [
    (dict(nof_rb=24, modulation=Modulation.QAM64, target_code_rate=0.6, nof_layers=2), True),
    (dict(nof_rb=6, modulation=Modulation.QAM16, target_code_rate=0.5, rv=2, nof_layers=4), False),
    (dict(nof_rb=4, modulation=Modulation.QPSK, target_code_rate=0.1, rv=3), False)])
def test_sch_codeword_bit_exact_vs_jax(kw, reduced_g):
    """Several codeblocks with two E sizes (and a G reduced as UCI would),
    rv 2 over 4 layers, repetition at a low rate with rv 3."""
    jcfg, tcfg = JaxConfig(**kw), PuschRxConfig(**port_kw(kw))
    tb = np.random.default_rng(tcfg.tbs).integers(0, 2, (2, tcfg.tbs)).astype(np.uint8)
    qm = bits_per_symbol(jcfg.modulation)
    g = tcfg.nof_codeword_bits - 3 * qm * tcfg.nof_layers if reduced_g else None
    got = sch_tx.build_sch_codeword_tx(tcfg, g)(torch.as_tensor(tb))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_sch_tx.build_sch_codeword_tx(jcfg, g)(jnp.asarray(tb))))
    assert sch_tx.sch_rate_match_groups(tcfg, g) == jax_sch_tx.sch_rate_match_groups(jcfg, g)
    assert len(sch_tx.sch_rate_match_groups(tcfg, g)) == (2 if reduced_g else 1)


def test_sch_symbols_bit_exact_vs_jax():
    kw = dict(nof_rb=4, modulation=Modulation.QAM16, target_code_rate=0.4, rnti=0x1234, n_id=77)
    jcfg, tcfg = JaxConfig(**kw), PuschRxConfig(**port_kw(kw))
    tb = np.random.default_rng(2).integers(0, 2, (2, tcfg.tbs)).astype(np.uint8)
    np.testing.assert_array_equal(
        sch_tx.build_sch_symbols_tx(tcfg)(torch.as_tensor(tb)).numpy(),
        np.asarray(jax_sch_tx.build_sch_symbols_tx(jcfg)(jnp.asarray(tb))))


@pytest.mark.parametrize("nof_layers,dmrs", [(1, (2,)), (2, (2, 11)), (4, (2, 7, 11))])
def test_ulsch_tx_matches_jax(nof_layers, dmrs):
    kw = dict(nof_rb=24, modulation=Modulation.QAM64, target_code_rate=0.6, nof_layers=nof_layers,
              nof_rx_ports=4, dft_size=512, numerology=1, dmrs_symbols=dmrs, n_id=7, slot=3)
    jcfg, tcfg = JaxConfig(**kw), PuschRxConfig(**port_kw(kw))
    tb = np.random.default_rng(nof_layers).integers(0, 2, (2, tcfg.tbs)).astype(np.uint8)
    grid, samples = build_ulsch_tx_slot(tcfg, device="cpu")(torch.as_tensor(tb))
    j_grid, j_samples = (np.asarray(a) for a in jax_ulsch_tx(jcfg)(jnp.asarray(tb)))
    assert grid.shape == j_grid.shape and samples.shape == j_samples.shape
    assert grid.dtype == samples.dtype == torch.float32
    np.testing.assert_allclose(grid.numpy(), j_grid, rtol=0, atol=1e-6)
    np.testing.assert_allclose(samples.numpy(), j_samples, rtol=0,
                               atol=1e-5 * np.abs(j_samples).max())


def test_ulsch_tx_rejects_deferred_settings():
    """UCI fields, hopping and DM-RS type 2 now build and transmit; a
    hopping configuration without its second hop's PRB, a missing UCI payload
    and a wrong TB shape raise."""
    base = dict(nof_rb=24, modulation=Modulation.QAM64, target_code_rate=0.6, dft_size=512)
    tb = torch.zeros((1, PuschRxConfig(**port_kw(base)).tbs), dtype=torch.uint8)
    for kw, payloads in ((dict(nof_harq_ack_bits=2), dict(ack_bits=torch.ones((1, 2)))),
                         (dict(nof_csi_part1_bits=5), dict(csi1_bits=torch.ones((1, 5)))),
                         (dict(hop_symbol=7, second_hop_prb=4), {}),
                         (dict(dmrs_config_type=2), {})):
        cfg = PuschRxConfig(**port_kw(base), **kw)
        grid, samples = build_ulsch_tx_slot(cfg, device="cpu")(
            torch.zeros((1, cfg.tbs), dtype=torch.uint8), **payloads)
        assert grid.shape == (1, 14, cfg.nof_subc, 2) and bool(torch.isfinite(samples).all())
    with pytest.raises(ValueError, match="second_hop_prb"):
        build_ulsch_tx_slot(PuschRxConfig(**port_kw(base), hop_symbol=7), device="cpu")
    with pytest.raises(ValueError, match="ack payload"):
        build_ulsch_tx_slot(PuschRxConfig(**port_kw(base), nof_harq_ack_bits=2),
                            device="cpu")(tb)
    tx = build_ulsch_tx_slot(PuschRxConfig(**port_kw(base)), device="cpu")
    with pytest.raises(ValueError):
        tx(torch.zeros((1, 10), dtype=torch.uint8))


@pytest.mark.parametrize("profile", ["AWGN", "TDLA", "TDLC"])
def test_channel_emulator_equal_to_jax(profile):
    assert channel.TDL_PROFILES == jax_channel.TDL_PROFILES
    rng = np.random.default_rng(1)
    grid = (rng.normal(size=(2, 14, 72)) + 1j * rng.normal(size=(2, 14, 72))).astype(np.complex64)
    a = channel.ChannelEmulator(profile, 12.0, 4, 72, 30e3, seed=9)
    b = jax_channel.ChannelEmulator(profile, 12.0, 4, 72, 30e3, seed=9)
    for got, want in zip(a.run(grid[0]) + a.run_mimo(grid), b.run(grid[0]) + b.run_mimo(grid)):
        np.testing.assert_array_equal(got, want)
