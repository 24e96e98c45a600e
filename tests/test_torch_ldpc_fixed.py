"""PyTorch port, fixed-iteration LDPC decoding and the receive slot that runs
it (`PuschRxConfig(ldpc_early_stop=False)`).

The plain decoder (`decode.ldpc_decode`) is held bit-exact against the JAX
XLA decoder and the reference vectors in tests/test_torch_ldpc.py; here it is
also held against the three fixed-iteration Pallas kernels and the plain
early-stop decoder against the transposed early-stop Pallas kernel, all in
interpret mode at the sizes the JAX package's own tests use (marked slow, as
JAX marks its own: interpret mode takes minutes on a CPU).  The CUDA kernel
is held against the plain decoder on the card by chip_smoke.py.

Slice tolerances are those of tests/test_torch_pusch_rx.py (CRC verdicts, TB
bits and cb_crc_ok equal; harq_soft equal apart from counted demapper ties).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.models.pusch_rx import build_pusch_rx_slot as jax_rx_slot
from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode as jax_encode
from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph

from srsran_projectvtlmo_tpu_torch.models.pusch_rx import build_pusch_rx_slot, flatten_tb_bits
from srsran_projectvtlmo_tpu_torch.models.ulsch_tx import build_ulsch_tx_slot
from srsran_projectvtlmo_tpu_torch.ops import ofdm
from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode, decode_cuda
from srsran_projectvtlmo_tpu_torch.utils.cplx import from_cplx, to_cplx
from tests.test_torch_ldpc import _codewords, _noisy
from tests.test_torch_pusch_rx import _compare, _configs, _Slots


def test_fixed_wrapper_dispatch_on_cpu_and_input_checks():
    bg, z = BaseGraph.BG2, 16
    _, llr, _ = _codewords(bg, z, 3, seed=12)
    decode_cuda.reset_launch_counts()
    got = decode_cuda.ldpc_decode(torch.as_tensor(llr), bg, z, nof_iterations=2)
    want = decode.ldpc_decode(torch.as_tensor(llr), bg, z, nof_iterations=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert decode_cuda.LAUNCHES == {"ldpc_decode_es": 0, "ldpc_decode": 0}
    with pytest.raises(ValueError):
        decode_cuda.ldpc_decode_cuda(torch.as_tensor(llr), bg, z)
    with pytest.raises(ValueError):
        decode_cuda.ldpc_decode(torch.as_tensor(llr).to("meta"), bg, z)


@pytest.mark.parametrize("bg,z,crc", [(BaseGraph.BG1, 24, "CRC24B"), (BaseGraph.BG2, 2, "CRC16")])
def test_modes_differ_exactly_on_early_converging_rows(bg, z, crc):
    """Fixed iterations keep sweeping a codeblock whose CRC passed, so its
    soft bits move on; a row that used the whole budget is the same in both
    modes.  chip_smoke.py holds the kernel's two modes to this on the card."""
    _, llr, kp = _codewords(bg, z, 10, seed=z + 2, crc=crc)
    noisy = torch.as_tensor(_noisy(llr, seed=z + 3))
    for iters in (2, 6):
        _, soft, ok, used = decode.ldpc_decode_es(noisy, bg, z, crc, kp,
                                                  nof_iterations=iters)
        _, fixed_soft = decode.ldpc_decode(noisy, bg, z, nof_iterations=iters)
        differs = (soft != fixed_soft).any(dim=1)
        early = ok & (used < iters)
        assert early.any() and differs[early].all()
        assert not differs[~early].any()


@pytest.mark.slow
@pytest.mark.parametrize("bg,z", [(BaseGraph.BG1, 13), (BaseGraph.BG2, 16)])
@pytest.mark.parametrize("variant", ["v1", "v2", "v3"])
def test_plain_fixed_matches_pallas_kernels_interpret(bg, z, variant):
    """Rows #4-#6 of the kernel table (the input of tests/test_ldpc.py's
    test_pallas_matches_xla): hard and soft bits equal."""
    from srsran_projectvtlmo_tpu.ops.ldpc.decode_pallas import (
        ldpc_decode_pallas, ldpc_decode_pallas_v3)
    from srsran_projectvtlmo_tpu.ops.ldpc.decode_pallas_v2 import ldpc_decode_pallas_v2

    kernel = {"v1": ldpc_decode_pallas, "v2": ldpc_decode_pallas_v2,
              "v3": ldpc_decode_pallas_v3}[variant]
    rng = np.random.default_rng(z + 5)
    info = rng.integers(0, 2, (2, (22 if bg == BaseGraph.BG1 else 10) * z)).astype(np.uint8)
    cw = np.asarray(jax_encode(jnp.asarray(info), bg, z))[:, 2 * z:]
    noisy = (1 - 2 * cw.astype(np.float64)) * 7 + rng.normal(0, 3.0, cw.shape)
    llr = np.clip(np.round(noisy), -20, 20).astype(np.int8)
    want = kernel(jnp.asarray(llr), bg, z, 3)
    got = decode.ldpc_decode(torch.as_tensor(llr), bg, z, nof_iterations=3)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.slow
def test_plain_early_stop_matches_transposed_pallas_kernel_interpret():
    """Row #3 of the kernel table, `ldpc_decode_pallas_es` (the (nv-2, B, z)
    layout), on partly converging input: all four outputs equal."""
    from srsran_projectvtlmo_tpu.ops.ldpc.decode_pallas import ldpc_decode_pallas_es

    bg, z = BaseGraph.BG2, 16
    _, llr, kp = _codewords(bg, z, 4, seed=21)
    noisy = _noisy(llr, seed=22)
    want = ldpc_decode_pallas_es(jnp.asarray(noisy), bg, z, "CRC24B", kp, 3)
    got = decode.ldpc_decode_es(torch.as_tensor(noisy), bg, z, "CRC24B", kp, nof_iterations=3)
    for name, a, b in zip(("hard", "soft", "crc_ok", "iterations"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert got[2].numpy().any() and (got[3].numpy() == 3).any()


def test_fixed_iteration_slot_matches_jax():
    """JAX Tx at 24 PRB QAM64, 2 layers over 4 ports; the JAX receiver and
    the port's, both with ldpc_early_stop=False, on a slot where every
    codeblock decodes and on one where only some do."""
    jcfg, tcfg = _configs(nof_layers=2, dmrs_symbols=(2, 11), ldpc_early_stop=False,
                          nof_ldpc_iterations=4)
    slots = _Slots(jcfg, batch=2, seed=4)
    jrx, trx = jax_rx_slot(jcfg), build_pusch_rx_slot(tcfg)
    for delay in (1, 3):  # a 3-sample delay at this noise leaves some CBs undecoded
        x = slots.samples(0.05, seed=5, delay=delay)
        to = trx(torch.as_tensor(x))
        _compare(jrx(jnp.asarray(x)), to, tcfg.segmentation)
        assert (to["ldpc_iterations"] == 4).all()
        decoded = int(to["cb_crc_ok"].sum())
        if delay == 1:
            assert to["tb_crc_ok"].all() and decoded == to["cb_crc_ok"].numel()
            np.testing.assert_array_equal(flatten_tb_bits(to["tb_bits_cb"].numpy(), tcfg.tbs),
                                          slots.tb)
        else:
            assert 0 < decoded < to["cb_crc_ok"].numel()


def test_port_tx_to_port_rx_fixed_iterations():
    """The slice chip_smoke.py runs at the north-star shape, at 24 PRB: the
    port's Tx, a fixed 4x2 mix, AWGN, the port's OFDM modulator and the
    port's fixed-iteration receiver decode every TB with 0 bit errors."""
    _, tcfg = _configs(nof_layers=2, dmrs_symbols=(2, 11), ldpc_early_stop=False)
    tb = np.random.default_rng(8).integers(0, 2, (2, tcfg.tbs)).astype(np.uint8)
    layers = to_cplx(build_ulsch_tx_slot(tcfg)(torch.as_tensor(tb))[0])  # (B, L, 14, S)
    mix = torch.polar(torch.full((4, 2), 0.5), -2.0 * np.pi * torch.outer(
        torch.arange(4.0), torch.arange(2.0)) / 4.0)
    grid = torch.einsum("pl,blsk->bpsk", mix, layers)
    gen = torch.Generator().manual_seed(9)
    grid = grid + 0.02 * torch.complex(torch.randn(grid.shape, generator=gen),
                                       torch.randn(grid.shape, generator=gen))
    out = build_pusch_rx_slot(tcfg)(ofdm.ofdm_modulate(from_cplx(grid), 512, 1, 0))
    assert out["tb_crc_ok"].all() and out["cb_crc_ok"].all()
    assert (out["ldpc_iterations"] == tcfg.nof_ldpc_iterations).all()
    np.testing.assert_array_equal(flatten_tb_bits(out["tb_bits_cb"].numpy(), tcfg.tbs), tb)
