"""The check fails what it must: the control, and a run with the timed path
broken underneath (an answer altered where it is produced, half of the
ports left out, a step that returns its previous state), driven through the
harness's own set-up, loop and check on the CPU at 24 PRB."""

import time

import numpy as np
import pytest


def run_with(cell_of, monkeypatch, name, patch):
    from portbench import harness

    bench, workload, config, traffic = cell_of(name)
    patch(monkeypatch)
    result, numbers = harness.run(bench, workload, config, traffic, 31, 0.3, False, "cpu",
                                  time.perf_counter())
    return result, numbers


def flip_tb_bit(monkeypatch):
    """A TB bit flipped where the port takes the slot's values."""
    from srsran_projectvtlmo_tpu_torch.phy import dl_slot

    orig = dl_slot.build_dl_slot_inputs

    def broken(program, request, tx_data, slot):
        values = orig(program, request, tx_data, slot)
        tb = values[0][0].copy()
        tb[len(tb) // 2] ^= 1
        return ([tb] + list(values[0][1:]),) + tuple(values[1:])

    monkeypatch.setattr(dl_slot, "build_dl_slot_inputs", broken)


def half_ports(monkeypatch):
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    orig = UpperPhy.process_dl_slot

    def broken(self, *a, **k):
        grid, samples = orig(self, *a, **k)
        grid, samples = grid.copy(), samples.copy()
        grid[grid.shape[0] // 2:] = 0
        samples[samples.shape[0] // 2:] = 0
        return grid, samples

    monkeypatch.setattr(UpperPhy, "process_dl_slot", broken)


def altered_re(monkeypatch):
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    orig = UpperPhy.process_dl_slot

    def broken(self, *a, **k):
        grid, samples = orig(self, *a, **k)
        grid = grid.copy()
        grid[0, 5, 100] += 0.1
        return grid, samples

    monkeypatch.setattr(UpperPhy, "process_dl_slot", broken)


def stale_dl(monkeypatch):
    from srsran_projectvtlmo_tpu_torch.phy.upper_phy import UpperPhy

    orig = UpperPhy.process_dl_slot

    def broken(self, *a, **k):
        out = orig(self, *a, **k)
        prev = getattr(self, "_prev", None)
        self._prev = out
        return prev or out

    monkeypatch.setattr(UpperPhy, "process_dl_slot", broken)


@pytest.mark.parametrize("patch", [flip_tb_bit, half_ports, altered_re, stale_dl],
                         ids=lambda p: p.__name__)
def test_fault_is_not_correct(cell_of, monkeypatch, patch):
    from portbench import harness

    result, numbers = run_with(cell_of, monkeypatch, "dl_full_1cell", patch)
    limits = harness.kind_of(cell_of("dl_full_1cell")[3]).LIMITS
    assert not result["correct"]
    assert numbers["dl_grid_err"] > limits["dl_grid_err"]


def test_controls(cell_of):
    """The program passes; the control, the reference with its grid in
    float8, fails both of the DL numbers."""
    from portbench import control, harness

    bench, workload, config, traffic = cell_of("dl_full_1cell")
    limits = harness.kind_of(traffic).LIMITS
    r = control.readings(workload, config, traffic, 41, 1, "cpu")
    assert harness.judge(r["program"], limits)
    assert set(r) == {"program", "ref_fp8"}
    for number in ("dl_grid_err", "dl_samples_rel_rms"):
        assert r["ref_fp8"][number] > limits[number]
    assert np.isfinite(r["program"]["dl_grid_err"])
