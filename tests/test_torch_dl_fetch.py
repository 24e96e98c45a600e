"""PyTorch port, the DL fetch through pinned staging on the card
(`utils.tables.fetch_dl_outputs`): its arrays equal the blocking `.cpu()`
copy bit for bit at the benchmark's 273-PRB shape, for both OFDM phases and
both grid precisions, also when the device is still busy as the fetch
starts; they are ordinary memory that later calls leave alone; it counts
`dl_pinned_fetches` and `d2h_bytes` per call and records its wait as
`upper_phy.dl_fetch_wait`; `MultiCellUpperPhy`'s fetch keeps its float32
real pairs.

Every test needs an NVIDIA card and skips without one.  This file imports no
JAX, so it runs where the card is, without the JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_dl_fetch.py
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy
from srsran_projectvtlmo_tpu_torch.utils import tables, tracing
from tests.test_torch_dl_graph import CELL, request

pytestmark = pytest.mark.cuda

#: The bytes one north-star DL call fetches: the bf16 grid pair and the
#: float32 samples.
D2H_BYTES = 2_699_904


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the DL fetch stages through pinned memory only there")
    return torch.device("cuda", torch.cuda.current_device())


def warm_phy(card, cell=CELL) -> UpperPhy:
    """An `UpperPhy` whose DL graphs of both OFDM phases are captured."""
    phy = UpperPhy(cell, device=card)
    for slot in (4, 5):
        for seed in range(3):
            phy.process_dl_slot(*request(slot, seed))
    return phy


def blocking_fetch(grid_pair: torch.Tensor, samples: torch.Tensor):
    """The outputs through `.cpu()`: the grid widened to float32 and viewed as
    complex64, the samples as they are."""
    g = grid_pair.cpu().float().numpy()
    return g.view(np.complex64)[..., 0], samples.cpu().numpy()


def same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "float32"])
@pytest.mark.parametrize("slot", [4, 5])
def test_pinned_fetch_equals_the_blocking_copy(card, slot, bf16):
    """Both OFDM phases, both grid precisions: `fetch_dl_outputs` on a
    replayed slot, and `process_dl_slot(fetch=True)` issued behind 50 ms of
    device work, give the `.cpu()` copy's arrays bit for bit (a one-port
    squeeze aside, the same dtype and shape as before staging)."""
    cell = dataclasses.replace(CELL, grid_bf16=bf16)
    phy = warm_phy(card, cell)
    req, data = request(slot, 11)
    grid_pair, samples = phy.process_dl_slot(req, data, fetch=False)
    want = blocking_fetch(grid_pair, samples)
    with tracing.entry("test.dl_fetch") as rec:
        got = tables.fetch_dl_outputs(grid_pair, samples, complex_grid=True)
    assert rec["dl_pinned_fetches"] == 1
    assert rec["d2h_bytes"] == sum(t.numel() * t.element_size() for t in (grid_pair, samples))
    assert got[0].shape == (4, 14, 3276) and got[1].dtype == np.float32
    assert all(same_bits(a, w) for a, w in zip(got, want))
    torch.cuda._sleep(100_000_000)  # about 50 ms of device work queued ahead
    entry_got = phy.process_dl_slot(req, data)
    assert all(same_bits(a, w) for a, w in zip(entry_got, want))
    g = grid_pair.cpu().float().numpy()
    np.testing.assert_array_equal(entry_got[0], g[..., 0] + 1j * g[..., 1])


def test_returned_arrays_survive_later_calls(card):
    """The arrays of a call are ordinary (pageable) memory of the caller's
    own: ten later calls of other slots, both phases, leave them as they
    were."""
    phy = warm_phy(card)
    first = phy.process_dl_slot(*request(4, 20))
    kept = [a.copy() for a in first]
    for k in range(10):
        later = phy.process_dl_slot(*request(4 + k % 2, 21 + k))
        assert not np.array_equal(later[1][..., :64], first[1][..., :64])
    for a, k in zip(first, kept):
        assert same_bits(a, k)
        assert not torch.from_numpy(a.view(np.float32)).is_pinned()


def test_counter_wait_span_and_pinned_copies_under_the_profiler(card):
    """Three traced calls: each record counts one pinned fetch and the
    north-star bytes; each `upper_phy.dl_fetch` holds one
    `upper_phy.dl_fetch_wait`; the device-to-host copies land in pinned
    memory, none in pageable."""
    phy = warm_phy(card)
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for seed in range(calls):
            phy.process_dl_slot(*request(4, 30 + seed))
        torch.cuda.synchronize()
    for rec in tracing.last_calls(calls):
        assert rec["dl_pinned_fetches"] == 1 and rec["d2h_bytes"] == D2H_BYTES
    events = prof.events()
    host = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]
    fetches = [e.time_range for e in host if e.name == "upper_phy.dl_fetch"]
    waits = [e.time_range for e in host if e.name == "upper_phy.dl_fetch_wait"]
    assert len(fetches) == len(waits) == calls
    assert all(f.start <= w.start and w.end <= f.end for f, w in zip(fetches, waits))
    d2h = {e.name for e in events if e.name.startswith("Memcpy DtoH")}
    assert d2h and all("Pinned" in n for n in d2h), d2h


def test_multi_cell_fetch_keeps_float32_pairs(card):
    """Two north-star cells in one batched `MultiCellUpperPhy` call: the
    fetch gives float32 real pairs, bit for bit the `.cpu()` copy of the
    call's tensors, and counts one pinned fetch for the call; the grids are
    each cell's own."""
    multi = MultiCellUpperPhy(CELL, 2, device=card)
    one = UpperPhy(CELL, device=card)
    for seed in range(3):
        (r0, d0), (r1, d1) = request(4, seed), request(4, seed + 100)
        multi.process_dl_slot([r0, r1], [d0, d1])
    (r0, d0), (r1, d1) = request(4, 40), request(4, 41)
    grid_t, samples_t = multi.process_dl_slot([r0, r1], [d0, d1])
    with tracing.entry("test.multi_cell") as rec:
        grids, samples = multi.process_dl_slot([r0, r1], [d0, d1], fetch=True)
    assert rec["dl_pinned_fetches"] == 1 and rec["d2h_bytes"] == 2 * D2H_BYTES
    assert grids.dtype == samples.dtype == np.float32 and grids.shape == (2, 4, 14, 3276, 2)
    assert same_bits(grids, grid_t.cpu().float().numpy())
    assert same_bits(samples, samples_t.cpu().numpy())
    for c, (req, data) in enumerate(((r0, d0), (r1, d1))):
        assert torch.equal(one.process_dl_slot(req, data, fetch=False)[0], grid_t[c])
