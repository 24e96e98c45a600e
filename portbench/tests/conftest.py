"""The benchmark's CPU tests: small cells on the CPU, the port's plain paths."""

import copy
import sys
from pathlib import Path

import pytest
import torch

# Several test workers share the machine: a few threads each.
torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: Small carriers for the CPU: (nof_rb, dft_size, CORESET RBs).
SMALL = {"dl_slot": (24, 512, 24)}


def small_cell(name: str, nof_cells: int | None = None):
    """(bench, workload, config, traffic) of a BENCHMARK.json cell cut to a
    24-PRB carrier for the CPU (and to `nof_cells` cells, where given)."""
    from portbench import harness

    bench = harness.load_benchmark()
    workload, config, traffic = harness.find_cell(bench, name)
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    nrb, dft, coreset = SMALL[traffic["kind"]]
    config["cell"].update(nof_rb=nrb, dft_size=dft)
    if nof_cells is not None:
        config["nof_cells"] = nof_cells
    traffic["pdsch"]["rb_size"] = nrb
    traffic["pdcch"]["coreset_nof_rb"] = coreset
    return bench, workload, config, traffic


@pytest.fixture
def cell_of():
    return small_cell
