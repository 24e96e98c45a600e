"""The reference's frozen tables equal the port's tables."""

from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
FROZEN = ROOT / "portbench" / "reference" / "data"
PORT = ROOT / "srsran_projectvtlmo_tpu_torch" / "data"


@pytest.mark.parametrize("name", sorted(p.name for p in FROZEN.glob("*.npz")))
def test_frozen_table_equals_the_port(name):
    with np.load(FROZEN / name) as a, np.load(PORT / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(a[key], b[key])


def test_the_tables_the_reference_reads_are_there():
    assert {p.name for p in FROZEN.glob("*.npz")} == {"ldpc_base_graphs.npz", "polar_tables.npz"}
