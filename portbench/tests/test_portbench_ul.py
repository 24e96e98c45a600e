"""The `ul_pusch` kind on the CPU at 24 PRB: its pool, a small run through the
harness that is correct, the controls that must fail, the refusal at set-up
of a program whose CRC indication carries no channel state, and the
readers of the UL per-layer metrics."""

import copy
import importlib
import time
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, trace as trace_mod
from portbench.layer_metrics import (
    ldpc_decode_roofline, ldpc_iterations_per_cb, ul_fetch_host_ms, ul_graph_replay_share,
    ul_values_host_ms)
from srsran_projectvtlmo_tpu_torch.utils import tracing


def ul_cell(nof_cells: int = 2, dft: int = 4096, pool_slots: int = 2):
    """(bench, workload, config, traffic) of `ul_pusch_4cell` cut to a 24-PRB
    carrier and `nof_cells` cells for the CPU.  At the cell's DFT of 4096
    the sample rate, the delays and the grid's amplitudes are the cell's; at
    DFT 512 a sample lasts 65 ns, so the delays are cut to 0-1 samples."""
    bench = harness.load_benchmark()
    workload, config, traffic = harness.find_cell(bench, "ul_pusch_4cell")
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["cell"].update(nof_rb=24, dft_size=dft)
    config["nof_cells"] = nof_cells
    traffic["pusch"]["rb_size"] = 24
    traffic["pool_slots"] = pool_slots
    if dft == 512:
        traffic["delay_samples"] = [0, 1]
    return bench, workload, config, traffic


#: At 24 PRB the reference's TA (a phase slope over 11 times fewer pilot
#: pairs than the cell's) reads 0.14-0.31 ns off the port's on six seeds of
#: 16 cell-slots, against 0.02-0.05 ns at the cell's 273 PRB, for which
#: `ul_ta_vs_ref_ns`'s limit is set; here it is held to 1 ns instead.
SMALL_TA_VS_REF_NS = 1.0


def judge_small(numbers: dict, limits: dict) -> bool:
    """`harness.judge` with `ul_ta_vs_ref_ns` held to `SMALL_TA_VS_REF_NS`."""
    return harness.judge(numbers, dict(limits, ul_ta_vs_ref_ns=SMALL_TA_VS_REF_NS))


def pool_of(seed: int, **kw):
    _, _, config, traffic = ul_cell(**kw)
    fapi, _, _ = harness.port_modules()
    return harness.kind_of(traffic).make_pool(traffic, config, seed, "cpu", fapi)


def digest(pool):
    out = []
    for e in pool:
        out.append(e.slot)
        for req, t in zip(e.args[0], e.truth):
            out += [req.pusch[0].rnti, req.pusch[0].n_id, t["ta_ns"], t["tb"].tobytes()]
        out.append(e.args[1].numpy().tobytes())
    return out


def test_same_seed_same_pool_other_seed_other_pool():
    big = 2 ** 31 + 777
    a, b, c = pool_of(big), pool_of(big), pool_of(big + 1)
    assert digest(a) == digest(b) and digest(a) != digest(c)
    assert {e.slot % 2 for e in a} == {0, 1}
    sinr = [t["sinr_db"] for t in a[0].truth]
    assert sinr[0] > sinr[1] + 1.5  # cells 0 and 1: noise 0.005 and 0.0071
    for e in a:
        assert e.args[1].shape[:2] == (2, 4) and e.args[1].dtype == torch.float32
        assert [len(t["tb"]) for t in e.truth] == [len(a[0].truth[0]["tb"])] * 2


@pytest.mark.parametrize("trace", [False, True], ids=["untraced", "traced"])
def test_small_run_is_correct(trace, monkeypatch):
    bench, workload, config, traffic = ul_cell()
    monkeypatch.setattr(harness, "TRACE_POOL_PASSES", 1)
    result, numbers = harness.run(bench, workload, config, traffic, 2 ** 40 + 11, 0.3, trace,
                                  "cpu", time.perf_counter())
    assert judge_small(numbers, harness.kind_of(traffic).LIMITS), numbers
    assert result["failed"] == 0 and result["attempted"] % 2 == 0
    assert numbers["ul_tb_wrong"] == 0 and numbers["ul_ta_vs_truth_ns"] < 1.0
    if trace:
        metrics = result["metrics"]
        assert metrics["ul_values_host_ms"]["value"] > 0
        assert metrics["ul_fetch_host_ms"]["value"] > 0
        assert metrics["ldpc_iterations_per_cb"]["value"] >= 1.0
        assert "ul_graph_replay_share" not in metrics  # the CPU path replays no graph
    else:
        assert set(result["metrics"]) == {"cell_slots_per_s", "setup_s"}


def test_controls_fail():
    """The program passes; the stale indications fail on the TBs, the
    constant channel state on the TA and the SINR, and the reference with a
    float8 grid on the TBs."""
    from portbench import control

    _, workload, config, traffic = ul_cell()
    limits = harness.kind_of(traffic).LIMITS
    r = control.readings(workload, config, traffic, 51, 1, "cpu")
    assert set(r) == {"program", "stale", "constant_state", "ref_fp8"}
    assert judge_small(r["program"], limits), r["program"]
    assert r["stale"]["ul_tb_wrong"] > limits["ul_tb_wrong"]
    assert r["constant_state"]["ul_ta_vs_truth_ns"] > limits["ul_ta_vs_truth_ns"]
    assert r["constant_state"]["ul_sinr_vs_truth_db"] > limits["ul_sinr_vs_truth_db"]
    assert r["constant_state"]["ul_tb_wrong"] == 0
    assert r["ref_fp8"]["ul_tb_wrong"] > limits["ul_tb_wrong"]


def test_program_without_channel_state_is_refused_at_set_up(monkeypatch):
    """A port whose CRC indication has no channel state (no
    `fapi.indications`): the kind raises, naming the fields, before a single
    call."""
    bench, workload, config, traffic = ul_cell(pool_slots=1)
    real = importlib.import_module
    calls = []

    def without(name, *a, **k):
        if name.endswith(".fapi.indications"):
            raise ModuleNotFoundError(name)
        return real(name, *a, **k)

    kind = harness.kind_of(traffic)
    monkeypatch.setattr(kind.importlib, "import_module", without)
    monkeypatch.setattr(harness, "run_window", lambda *a, **k: calls.append(a))
    with pytest.raises(RuntimeError, match="ul_sinr_db, timing_advance_ns"):
        harness.run(bench, workload, config, traffic, 3, 0.1, False, "cpu", time.perf_counter())
    assert calls == []


def traced_records(counts: list[dict]):
    for c in counts:
        with tracing.entry("test.ul_call"):
            for k, n in c.items():
                tracing.count(k, n)
    return SimpleNamespace(calls=list(range(len(counts))), cell_slots=4 * len(counts))


def test_record_readers():
    ctx = traced_records([{"ul_graph_replays": 1, "pusch_cbs": 304, "ldpc_sweeps": 608},
                          {"ul_graph_replays": 0, "pusch_cbs": 304, "ldpc_sweeps": 912}])
    assert ul_graph_replay_share.read(ctx) == 0.5
    assert ldpc_iterations_per_cb.read(ctx) == 2.5
    none = traced_records([{}, {}])
    assert ul_graph_replay_share.read(none) is None
    assert ldpc_iterations_per_cb.read(none) is None


def test_span_and_roofline_readers():
    t = trace_mod.Trace()
    for base in (0.0, 1000.0):
        t.spans += [("portbench.call", base, 900.0), ("upper_phy.ul_values", base + 10, 200.0),
                    ("upper_phy.ul_fetch", base + 300, 400.0)]
        t.kernels.append(("void ldpc_decode_kernel<true>(Plan, int)", base + 400, 100.0))
    ctx = SimpleNamespace(trace=t, cell_slots=8, calls=[0, 1],
                          cell=SimpleNamespace(ldpc_work=lambda i: (304, 608)))
    assert ul_values_host_ms.read(ctx) == pytest.approx(0.05)
    assert ul_fetch_host_ms.read(ctx) == pytest.approx(0.1)
    # 2 calls x 608 sweeps x 10 x 121,344 operations at 33.5 T/s over 200 us.
    want = 100.0 * 2 * 608 * 10 * 121344 / 33.5e12 / 200e-6
    assert ldpc_decode_roofline.read(ctx) == pytest.approx(want)
    assert ldpc_decode_roofline.read(SimpleNamespace(trace=trace_mod.Trace(), cell_slots=8,
                                                     calls=[0], cell=ctx.cell)) is None
    assert ldpc_decode_roofline.read(SimpleNamespace(trace=t, cell_slots=8, calls=[0],
                                                     cell=object())) is None
