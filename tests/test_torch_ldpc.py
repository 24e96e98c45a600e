"""PyTorch port, LDPC decoding: the plain torch decoder against the JAX XLA
decoders, the stored reference-C++ vectors and (one case) the Pallas kernel in
interpret mode; the CUDA wrapper's dispatch and tables.  The kernel itself is
held against the plain decoder on the card by chip_smoke.py (these tests
import JAX, which the card's machine does not have)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu.ops.crc import crc_host
from srsran_projectvtlmo_tpu.ops.ldpc import decode as jax_dec
from srsran_projectvtlmo_tpu.ops.ldpc.encode import ldpc_encode
from srsran_projectvtlmo_tpu.ran.ldpc_params import BaseGraph

from srsran_projectvtlmo_tpu_torch.ops.ldpc import decode, decode_cuda

VECTORS = Path(__file__).parent / "vectors" / "ldpc_reference.npz"


def _codewords(bg: BaseGraph, z: int, batch: int, seed: int, crc: str = "CRC24B",
               filler: int = 0):
    """CRC-terminated random codeblocks (with trailing filler) and their LLRs
    at +/-8, filler at +127; returns (info, llr (B, N) int8, kp)."""
    kb = 22 if bg == BaseGraph.BG1 else 10
    kp = kb * z - filler
    order = 24 if crc.startswith("CRC24") else 16
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, (batch, kp - order)).astype(np.uint8)
    info = np.concatenate([payload, np.stack([crc_host(p, crc) for p in payload]),
                           np.zeros((batch, filler), np.uint8)], -1)
    cw = np.asarray(ldpc_encode(jnp.asarray(info), bg, z))[:, 2 * z:]
    llr = ((1 - 2 * cw.astype(np.int32)) * 8).astype(np.int8)
    llr[:, kb * z - 2 * z - filler:kb * z - 2 * z] = 127
    return info, llr, kp


def _noisy(llr: np.ndarray, seed: int) -> np.ndarray:
    """Flip-and-halve a growing share of LLRs per row (clean to undecodable),
    and make the last row uniform random over all of int8."""
    rng = np.random.default_rng(seed)
    p = np.linspace(0.0, 0.12, llr.shape[0])[:, None]
    out = np.where(rng.random(llr.shape) < p, -llr // 2, llr).astype(np.int8)
    out[-1] = rng.integers(-128, 128, llr.shape[1])
    return out


@pytest.mark.parametrize("bg,z,filler", [(BaseGraph.BG1, 64, 0), (BaseGraph.BG1, 13, 7),
                                         (BaseGraph.BG2, 40, 10), (BaseGraph.BG2, 52, 0)])
def test_plain_early_stop_bit_exact_vs_jax(bg, z, filler):
    info, llr, kp = _codewords(bg, z, 8, seed=z, filler=filler)
    noisy = _noisy(llr, seed=z + 1)
    want = jax_dec.ldpc_decode_es(jnp.asarray(noisy), bg, z, "CRC24B", kp, nof_iterations=4)
    got = decode.ldpc_decode_es(torch.as_tensor(noisy), bg, z, "CRC24B", kp, nof_iterations=4)
    for name, a, b in zip(("hard", "soft", "crc_ok", "iterations"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    its = got[3].numpy()
    assert got[2].numpy()[0] and its.min() == 1 and (its > 1).any() and not got[2].numpy()[-1]
    ok = got[2].numpy()
    np.testing.assert_array_equal(got[0].numpy()[ok, :kp], info[ok, :kp])


@pytest.mark.parametrize("bg,z", [(BaseGraph.BG1, 64), (BaseGraph.BG2, 40)])
def test_plain_fixed_iterations_bit_exact_vs_jax(bg, z):
    _, llr, _ = _codewords(bg, z, 6, seed=3)
    noisy = _noisy(llr, seed=4)
    for iters in (1, 3):
        want = jax_dec.ldpc_decode(jnp.asarray(noisy), bg, z, nof_iterations=iters)
        got = decode.ldpc_decode(torch.as_tensor(noisy), bg, z, nof_iterations=iters)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


with np.load(VECTORS) as _z:
    _KEYS = sorted({k.rsplit("_", 1)[0] for k in _z.files})
    _DATA = {k: _z[k] for k in _z.files}


@pytest.mark.parametrize("key", [k for k in _KEYS if "_it6_" in k or "_it2_" in k])
def test_plain_decoder_matches_reference_vectors(key):
    """Hard bits of the reference C++ decoder (tools/ref_crossval)."""
    bg = BaseGraph(int(key.split("_")[0][2:]))
    z = int(key.split("_")[1][1:])
    it = int(key.split("_")[2][2:])
    hard, _ = decode.ldpc_decode(torch.as_tensor(_DATA[f"{key}_llr"][None]), bg, z,
                                 nof_iterations=it)
    np.testing.assert_array_equal(hard.numpy()[0], _DATA[f"{key}_dec"], err_msg=key)


def test_plain_matches_pallas_kernel_interpret():
    """The Pallas kernel the CUDA kernel replaces, in interpret mode, at the
    shape the JAX package's own tier-1 test runs it (BG2 z=40, batch 5; the
    packed-lane route), on partly converging input."""
    from srsran_projectvtlmo_tpu.ops.ldpc.decode_pallas import ldpc_decode_pallas_es_bm

    bg, z = BaseGraph.BG2, 40
    _, llr, kp = _codewords(bg, z, 5, seed=7)
    rng = np.random.default_rng(8)
    noisy = np.where(rng.random(llr.shape) < np.linspace(0, 0.1, 5)[:, None],
                     -llr // 2, llr).astype(np.int8)
    want = ldpc_decode_pallas_es_bm(jnp.asarray(noisy), bg, z, "CRC24B", kp, 2, 0.8, 2)
    got = decode.ldpc_decode_es(torch.as_tensor(noisy), bg, z, "CRC24B", kp, nof_iterations=2)
    for name, a, b in zip(("hard", "soft", "crc_ok", "iterations"), want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    assert (got[3].numpy() == 2).any()


def test_scale_table_is_float32_round_half_up():
    """floor(mag * 0.8 + 0.5) with float32 products, as the JAX decoders."""
    mags = np.arange(128, dtype=np.float32)
    want = np.floor(mags * np.float32(0.8) + np.float32(0.5)).astype(np.int32)
    np.testing.assert_array_equal(decode.scale_table(0.8), want)
    assert decode.scale_table(0.8)[120] == 96


def test_wrapper_dispatch_on_cpu_and_input_checks():
    bg, z = BaseGraph.BG2, 16
    _, llr, kp = _codewords(bg, z, 3, seed=11)
    decode_cuda.reset_launch_counts()
    got = decode_cuda.ldpc_decode_es(torch.as_tensor(llr), bg, z, "CRC24B", kp,
                                     nof_iterations=2)
    want = decode.ldpc_decode_es(torch.as_tensor(llr), bg, z, "CRC24B", kp, nof_iterations=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert decode_cuda.LAUNCHES["ldpc_decode_es"] == 0  # the plain path is not a launch
    with pytest.raises(ValueError):
        decode_cuda.ldpc_decode_es_cuda(torch.as_tensor(llr), bg, z, "CRC24B", kp)
    with pytest.raises(ValueError):
        decode_cuda.ldpc_decode_es(torch.as_tensor(llr).to("meta"), bg, z, "CRC24B", kp)
    with pytest.raises(ValueError):
        decode.ldpc_decode_es(torch.as_tensor(llr[:, :-1]), bg, z, "CRC24B", kp)


def test_kernel_tables_match_graph():
    """The kernel's CSR edge table ((shift, column * z) per edge) and CRC
    mask; tests/test_torch_ldpc_plan.py checks them at every z."""
    from srsran_projectvtlmo_tpu_torch.ops.ldpc.graphs import get_graph

    for bg, z in [(BaseGraph.BG1, 384), (BaseGraph.BG2, 2)]:
        g = get_graph(bg, z)
        row_ptr, edges = decode_cuda.row_ptr_table(bg, z), decode_cuda.edge_table(bg, z)
        mask = decode.packed_crc_mask(bg, z, "CRC24B", g.k - 5)
        assert row_ptr[-1] == (g.shifts >= 0).sum() and len(edges) == row_ptr[-1]
        for r in range(g.m):
            e = edges[row_ptr[r]:row_ptr[r + 1]]
            deg = (g.row_cols[r] >= 0).sum()
            np.testing.assert_array_equal(e[:, 1], g.row_cols[r, :deg] * z)
            np.testing.assert_array_equal(e[:, 0], g.row_shifts[r, :deg])
        assert mask.shape == (g.k,) and (mask[g.k - 5:] == 0).all()
    smem = 384 * (5 * 46 + 68)
    assert smem <= 232448 // 2 - 1024  # two CTAs per SM at BG1 z=384
