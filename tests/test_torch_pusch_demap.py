"""PyTorch port, the PUSCH receiver's demap stage (`ops/pusch_demap`): max-log
demapping, LLR quantisation and descrambling, its plain torch version and
its hand-written CUDA kernel (`csrc/pusch_demap.cu`).

On the CPU: the plain version is the receiver's former expression
(`soft_demap` times the descrambling signs), in both layouts and for every
modulation; the kernel's parameter layout and Gray bit derivation agree with
the host tables; the FAPI entry counts its demapped rows.  On the card
(marker `cuda`, skipped without one): the kernel equals the plain version
bit for bit, eagerly and replayed in a CUDA graph.  This file imports no
JAX, so the card's tests run without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_pusch_demap.py
"""

import re

import numpy as np
import pytest
import torch

from srsran_projectvtlmo_tpu_torch.fapi.pdus import PuschPdu, UlTtiRequest
from srsran_projectvtlmo_tpu_torch.ops import ofdm
from srsran_projectvtlmo_tpu_torch.ops import pusch_demap as pd
from srsran_projectvtlmo_tpu_torch.ops.demodulation import demap_min_plan, soft_demap
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu_torch.ran.modulation import Modulation, bits_per_symbol
from srsran_projectvtlmo_tpu_torch.utils import tracing

MODS = list(Modulation)
#: The cell's demap shape: 4 rows of 12 data symbols x 3276 subcarriers x 2 layers.
CELL_ROWS, CELL_N = 4, 12 * 3276 * 2


def inputs(mod: Modulation, rows: int, n: int, seed: int, device="cpu", shared=False):
    """(eq (rows, n, 2), noise (rows, n), signs int8) with values far beyond
    the clip, noise of 0 and below on some positions (a whole row of 0 in
    the first), subnormal noise, and signs of both values; `shared` gives
    one row of signs for every row."""
    rng = np.random.default_rng(seed)
    eq = rng.normal(size=(rows, n, 2)).astype(np.float32) * 1.3
    eq[:, ::7] *= 40.0
    noise = np.abs(rng.normal(0.05, 0.04, (rows, n))).astype(np.float32)
    noise[:, ::11] = 0.0
    noise[:, 5::13] = -0.01
    noise[:, 3::17] = 1e-39
    noise[:, 1::19] = 1e-4
    noise[0] = 0.0
    g = n * bits_per_symbol(mod)
    signs = (1 - 2 * rng.integers(0, 2, g if shared else (rows, g))).astype(np.int8)
    return (torch.as_tensor(eq, device=device), torch.as_tensor(noise, device=device),
            torch.as_tensor(signs, device=device))


def former(eq, noise, signs, mod, bit_major):
    """The receiver's demap and descrambling as written before the kernel."""
    qm = bits_per_symbol(mod)
    if bit_major:
        llr = soft_demap(eq, noise, mod, bit_major=True)
        sg = signs.reshape(eq.shape[0], eq.shape[1], qm).transpose(1, 2).to(torch.int32)
    else:
        llr = soft_demap(eq, noise, mod)
        sg = signs.to(torch.int32)
    return torch.clamp(llr.to(torch.int32) * sg, -127, 127).to(torch.int8)


# ------------------------------------------------------------------ CPU --

@pytest.mark.parametrize("bit_major", [True, False], ids=["bit_major", "symbol_major"])
@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_plain_is_the_former_expression(mod, bit_major):
    """The entry point on CPU tensors equals the former expression, with
    per-row and with shared signs; the two layouts hold the same LLRs; the
    rows without noise demap to 0."""
    qm = bits_per_symbol(mod)
    eq, noise, signs = inputs(mod, 3, 37, seed=qm)
    got = pd.demap_descramble(eq, noise, signs, mod, bit_major)
    assert torch.equal(got, former(eq, noise, signs, mod, bit_major))
    shared = signs[1]
    assert torch.equal(pd.demap_descramble(eq, noise, shared, mod, bit_major),
                       former(eq, noise, shared.expand(3, -1), mod, bit_major))
    other = pd.demap_descramble_plain(eq, noise, signs, mod, not bit_major)
    bm, sm = (got, other) if bit_major else (other, got)
    assert bm.shape == (3, qm, 37) and sm.shape == (3, 37 * qm)
    assert torch.equal(bm.transpose(1, 2).reshape(3, -1), sm)
    assert not sm[0].any() and sm[1:].abs().max() == 120


def test_tables_dtype_matches_the_source():
    """The .cu file's offsetof/sizeof assertions on `Tables` (which nvcc
    checks) agree with TABLES_DTYPE field by field."""
    src = pd.SOURCE.read_text()
    offsets = {m[0]: int(m[1]) for m in
               re.findall(r"static_assert\(offsetof\(Tables, (\w+)\) == (\d+)", src)}
    assert offsets == {f: pd.TABLES_DTYPE.fields[f][1] for f in pd.TABLES_DTYPE.names}
    assert list(offsets) == list(pd.TABLES_DTYPE.names)
    assert int(re.search(r"static_assert\(sizeof\(Tables\) == (\d+)", src)[1]) \
        == pd.TABLES_DTYPE.itemsize
    assert int(re.search(r"kMaxLevels = (\d+)", src)[1]) == pd.MAX_LEVELS


def kernel_cover(k: int, j: int, val: int) -> list[tuple[int, int]]:
    """The kernel's dyadic cover of (axis bit j, value val) (`make_cover`):
    the aligned blocks inside the set whose parent is not."""
    def block_in(lev, blk):
        return all(pd.pam_bit(k, j, i) == val for i in range(blk << lev, (blk + 1) << lev))
    return [(lev, blk) for lev in range(k + 1) for blk in range(1 << (k - lev))
            if block_in(lev, blk) and (lev == k or not block_in(lev + 1, blk >> 1))]


@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_kernel_tables_and_covers(mod):
    """Every modulation has its kernel tables (the constellation checked
    against the kernel's Gray derivation); for square QAM the kernel takes
    each set minimum over the blocks of `demap_min_plan`'s covers."""
    qm = bits_per_symbol(mod)
    t = pd.kernel_tables(mod)
    assert t["limit"] == (24.0 if qm <= 2 else 20.0)
    assert t["inv_limit"] == np.float32(1.0) / t["limit"]
    if qm == 1:
        assert t["point"][0].sum() > 0 > t["point"][1].sum()
        return
    _, covers = demap_min_plan(mod)
    for b in range(qm):
        for val in (False, True):
            assert sorted(covers[(b, val)]) == kernel_cover(qm // 2, b // 2, int(val))


def test_wrapper_checks_its_inputs():
    eq, noise, signs = inputs(Modulation.QPSK, 2, 8, seed=1)
    with pytest.raises(ValueError, match="on one card"):
        pd.demap_descramble_cuda(eq, noise, signs, Modulation.QPSK, True)
    with pytest.raises(ValueError, match="no demap kernel"):
        pd.demap_descramble(eq.to("meta"), noise, signs, Modulation.QPSK, True)


def test_fapi_entry_counts_its_demapped_rows():
    """One PUSCH through `UpperPhy` on the CPU: one row demapped, none by
    the kernel."""
    phy = UpperPhy(CellConfig(nof_rb=24, dft_size=512, numerology=1), device="cpu")
    pdu = PuschPdu(rnti=0x4601, rb_start=0, rb_size=2, modulation=Modulation.QPSK,
                   target_code_rate=0.3, n_id=3, dmrs_symbols=(2,))
    samples = np.zeros((1, ofdm.slot_sample_count(512, 1, 1), 2), np.float32)
    phy.process_ul_slot(UlTtiRequest(slot=1, pusch=(pdu,)), samples)
    rec = tracing.last_calls(1)[0]
    assert rec["ul_demap_rows"] == 1 and rec["ul_demap_kernel_rows"] == 0


# ----------------------------------------------------------------- card --

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the demap kernel runs only there")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [CELL_N, 1001], ids=["cell", "ragged"])
@pytest.mark.parametrize("bit_major", [True, False], ids=["bit_major", "symbol_major"])
@pytest.mark.parametrize("mod", MODS, ids=lambda m: m.name)
def test_kernel_equals_plain(card, mod, bit_major, n):
    """The kernel's LLRs equal the plain version's on the card bit for bit,
    with per-row and with shared signs, and each call is one launch."""
    for shared in (False, True):
        eq, noise, signs = inputs(mod, CELL_ROWS, n, seed=n + bits_per_symbol(mod),
                                  device=card, shared=shared)
        want = pd.demap_descramble_plain(eq, noise, signs, mod, bit_major)
        before = pd.LAUNCHES["pusch_demap"]
        got = pd.demap_descramble(eq, noise, signs, mod, bit_major)
        torch.cuda.synchronize()
        assert pd.LAUNCHES["pusch_demap"] == before + 1
        assert got.shape == want.shape and got.dtype == torch.int8
        diff = (got != want).sum().item()
        assert diff == 0, f"{diff} LLRs differ"


@pytest.mark.cuda
@pytest.mark.parametrize("bit_major", [True, False], ids=["bit_major", "symbol_major"])
def test_kernel_replayed_in_a_graph_equals_eager(card, bit_major):
    """Captured once in a CUDA graph and replayed on new inputs copied into
    the static ones: the plain version's LLRs bit for bit; the replays
    launch nothing the counter sees."""
    mod = Modulation.QAM256
    static = inputs(mod, CELL_ROWS, CELL_N, seed=7, device=card)
    pd.demap_descramble(*static, mod, bit_major)  # builds and loads the library
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pd.demap_descramble(*static, mod, bit_major)
    before = pd.LAUNCHES["pusch_demap"]
    for seed in (8, 9):
        new = inputs(mod, CELL_ROWS, CELL_N, seed=seed, device=card)
        for s, x in zip(static, new):
            s.copy_(x)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, pd.demap_descramble_plain(*new, mod, bit_major))
    assert pd.LAUNCHES["pusch_demap"] == before
