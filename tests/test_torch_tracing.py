"""PyTorch port, its tracing (`utils/tracing`): spans on torch.profiler's
clock, the FAPI entries' counter records and the byte counters of
`utils/tables`, the spans of the DL and UL entries, and the benchmark's
readers of them (`portbench/layer_metrics`).

Every check is exact: span names and nesting, byte counts (the counted
arrays' `nbytes`), and the readers' numbers on a synthetic trace.
"""

import copy
import importlib
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness
from portbench import trace as trace_mod
from srsran_projectvtlmo_tpu_torch.fapi.pdus import PrachPdu, PucchPdu, UlTtiRequest
from srsran_projectvtlmo_tpu_torch.ops import ofdm
from srsran_projectvtlmo_tpu_torch.parallel.multi_cell_phy import MultiCellUpperPhy
from srsran_projectvtlmo_tpu_torch.phy import dl_slot
from srsran_projectvtlmo_tpu_torch.phy.upper_phy import CellConfig, UpperPhy
from srsran_projectvtlmo_tpu_torch.utils import tracing

DL_CHILDREN = ("upper_phy.dl_validate", "upper_phy.dl_plan", "upper_phy.dl_values",
               "dl_slot.run", "upper_phy.dl_fetch")
NEW_READERS = ("dl_launch_host_ms", "dl_fetch_host_ms", "dl_entry_self_host_ms",
               "h2d_bytes_per_slot", "d2h_bytes_per_slot")


def dl_bench(nof_rb=None, dft=None, nof_cells=1):
    """(bench, workload, config, traffic) of the benchmark's DL cell, at its
    own carrier or cut to `nof_rb` / `dft` (the CORESET and the PDSCH
    follow)."""
    bench = harness.load_benchmark()
    workload, config, traffic = harness.find_cell(bench, "dl_full_1cell")
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    if nof_rb is not None:
        config["cell"].update(nof_rb=nof_rb, dft_size=dft)
        traffic["pdsch"]["rb_size"] = nof_rb
        traffic["pdcch"]["coreset_nof_rb"] = nof_rb
    config["nof_cells"] = nof_cells
    return bench, workload, config, traffic


def dl_cell(nof_rb=None, dft=None, seed=2 ** 40 + 11):
    """(config, pool) of `dl_bench`'s cell, with the port's FAPI classes."""
    _, _, config, traffic = dl_bench(nof_rb, dft)
    fapi, _, _ = harness.port_modules()
    return config, harness.kind_of(traffic).make_pool(traffic, config, seed, "cpu", fapi)


def traced(tmp_path, fn):
    """fn() under a CPU torch.profiler: (its result, the trace's host spans
    as (name, start, end), sorted by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"), key=lambda x: (x[1], -x[2]))
    return out, spans


def inside(spans, outer):
    """The names of the spans within the first span named `outer`, in order."""
    _, s0, e0 = next(s for s in spans if s[0] == outer)
    return [n for n, s, e in spans if s0 <= s and e <= e0 and n != outer]


# ------------------------------------------------------------- the module --

def test_span_is_a_shared_noop_off_and_a_user_annotation_on(tmp_path):
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("a") is tracing.span("b")
    with tracing.span("a"):
        pass

    def body():
        with tracing.span("outer.span"):
            with tracing.span("inner.span"):
                torch.ones(4).sum()

    _, spans = traced(tmp_path, body)
    assert [n for n, _, _ in spans] == ["outer.span", "inner.span"]
    assert spans[0][1] <= spans[1][1] and spans[1][2] <= spans[0][2]


def test_records_open_and_close_at_depth_zero_only():
    tracing.CALLS.clear()
    tracing.count("h2d_bytes", 7)  # outside any entry: counts nothing
    with tracing.entry("outer") as rec:
        tracing.count("h2d_bytes", 3)
        with tracing.entry("inner") as inner_rec:
            assert inner_rec is rec
            tracing.count("h2d_bytes", 4)
            tracing.count("d2h_bytes", 5)
        assert len(tracing.CALLS) == 0
    assert len(tracing.CALLS) == 1
    assert tracing.last_calls(1) == [{"entry": "outer", "h2d_bytes": 7, "d2h_bytes": 5}]


def test_a_record_closes_when_the_entry_raises():
    with pytest.raises(ValueError):
        with tracing.entry("raising"):
            tracing.count("d2h_bytes", 2)
            raise ValueError("x")
    assert tracing.last_calls(1) == [{"entry": "raising", "d2h_bytes": 2}]
    with tracing.entry("next"):
        pass
    assert tracing.last_calls(1) == [{"entry": "next"}]


def test_last_calls_returns_the_newest_oldest_first():
    for k in range(5):
        with tracing.entry(f"call{k}"):
            tracing.count("h2d_bytes", k)
    assert [r["entry"] for r in tracing.last_calls(3)] == ["call2", "call3", "call4"]
    assert tracing.last_calls(0) == []
    assert tracing.CALLS.maxlen == 4096


def test_records_are_per_thread():
    """An entry on another thread opens its own record, at its own depth."""
    done = threading.Event()
    go = threading.Event()

    def other():
        with tracing.entry("other"):
            go.set()
            tracing.count("h2d_bytes", 100)
            done.wait(10)

    with tracing.entry("main"):
        t = threading.Thread(target=other)
        t.start()
        go.wait(10)
        tracing.count("h2d_bytes", 1)
        done.set()
        t.join(10)
    records = {r["entry"]: r for r in tracing.last_calls(2)}
    assert records["main"]["h2d_bytes"] == 1 and records["other"]["h2d_bytes"] == 100


def test_records_stay_whole_under_thread_switches():
    """More threads than cores, each nesting entries and counting, with the
    interpreter switching threads every few microseconds: no count lands in
    another thread's record and no record is lost."""
    import sys

    nthreads, calls = 32, 50
    tracing.CALLS.clear()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def worker(k):
            for i in range(calls):
                with tracing.entry(f"w{k}"):
                    tracing.count("h2d_bytes", k)
                    with tracing.entry("nested"):
                        tracing.count("h2d_bytes", k)
                        tracing.count("d2h_bytes", i)

        threads = [threading.Thread(target=worker, args=(k,)) for k in range(nthreads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    records = list(tracing.CALLS)
    assert len(records) == nthreads * calls
    for r in records:
        assert r["h2d_bytes"] == 2 * int(r["entry"][1:])
    assert sorted(r["d2h_bytes"] for r in records) == sorted(list(range(calls)) * nthreads)


# ------------------------------------------------------------ the entries --

def test_dl_entry_counts_the_bytes_it_moves_at_the_north_star_width():
    """One warm DL call on a 273-PRB 4-port cell: `h2d_bytes` is the stacked
    value arrays' nbytes, `d2h_bytes` the fetched bf16 grid pair and float32
    samples' (1,142,752 and 2,699,904 bytes); on the CPU no fetch is pinned;
    one encode per PDCCH and SSB PDU, each a lookup in a built table."""
    config, pool = dl_cell()
    phy = harness.make_phy(config, "cpu")
    req, data = pool[0].args
    phy.process_dl_slot(req, data)
    grid, samples = phy.process_dl_slot(req, data, fetch=True)
    rec = tracing.last_calls(1)[0]
    program = dl_slot.get_dl_slot_program(req, phy.cfg, "cpu")
    args = program.value_args(req, dl_slot.build_dl_slot_inputs(program, req, data, req.slot))
    stacked = dl_slot._arrays(dl_slot._stack(args))
    grid_pair_bytes = grid.size * 2 * torch.bfloat16.itemsize
    encodes = len(req.pdcch) + len(req.ssb)
    assert encodes == 2
    assert rec == {"entry": "upper_phy.process_dl_slot",
                   "h2d_bytes": sum(a.nbytes for a in stacked),
                   "d2h_bytes": grid_pair_bytes + samples.nbytes, "dl_pinned_fetches": 0,
                   "dl_encodes": encodes, "dl_table_encodes": encodes}
    assert grid.shape == (4, 14, 3276) and samples.dtype == np.float32
    assert (rec["h2d_bytes"], rec["d2h_bytes"]) == (1_142_752, 2_699_904)


def test_dl_entry_spans_nest_as_documented(tmp_path):
    config, pool = dl_cell(24, 512)
    phy = harness.make_phy(config, "cpu")
    req, data = pool[1].args
    phy.process_dl_slot(req, data, fetch=True)
    _, spans = traced(tmp_path, lambda: phy.process_dl_slot(req, data, fetch=True))
    assert spans[0][0] == "upper_phy.process_dl_slot"
    names = inside(spans, "upper_phy.process_dl_slot")
    assert [n for n in names if n in DL_CHILDREN] == list(DL_CHILDREN)
    assert inside(spans, "upper_phy.dl_values") == ["dl_slot.host_values", "dl_slot.upload"]
    assert set(names) == set(DL_CHILDREN) | {"dl_slot.host_values", "dl_slot.upload"}
    _, spans = traced(tmp_path, lambda: phy.process_dl_slot(req, data, fetch=False))
    assert "upper_phy.dl_fetch" not in [n for n, _, _ in spans]


def test_plan_and_scrambling_spans_only_on_a_cache_miss(tmp_path):
    config, pool = dl_cell(24, 512, seed=2 ** 33 + 5)
    phy = harness.make_phy(config, "cpu")
    req, data = pool[0].args
    dl_slot._cached_program.cache_clear()
    dl_slot._scramble_planes.cache_clear()
    _, first = traced(tmp_path, lambda: phy.process_dl_slot(req, data))
    _, second = traced(tmp_path, lambda: phy.process_dl_slot(req, data))
    assert inside(first, "upper_phy.dl_plan") == ["dl_slot.build_plan"]
    assert inside(first, "dl_slot.host_values") == ["dl_slot.scramble_planes"]
    assert not {"dl_slot.build_plan", "dl_slot.scramble_planes"} & {n for n, _, _ in second}


def test_multi_cell_dl_is_one_record_with_nested_cell_entries(tmp_path):
    """Two cells of different slot structures take the per-cell fallback:
    their `UpperPhy` entries nest in the multi-cell entry and add to its one
    record; the fetch moves the bf16 grids as such."""
    config, pool = dl_cell(24, 512)
    cell = CellConfig(**{k: v for k, v in config["cell"].items()
                         if k in CellConfig.__dataclass_fields__})
    multi = MultiCellUpperPhy(cell, 2, device="cpu")
    (req, data), (req2, data2) = pool[0].args, pool[1].args
    req2 = type(req2)(slot=req.slot, pdcch=req2.pdcch, pdsch=req2.pdsch)  # no SSB, no CSI-RS
    data2 = type(data2)(slot=req.slot, tb_bits=data2.tb_bits)
    grids, samples = multi.process_dl_slot([req, req2], [data, data2], fetch=True)
    rec = tracing.last_calls(1)[0]
    assert rec["entry"] == "multi_cell_phy.process_dl_slot"
    assert rec["d2h_bytes"] == grids.size * torch.bfloat16.itemsize + samples.nbytes
    assert grids.dtype == np.float32 and grids.shape[:2] == (2, 4)
    _, spans = traced(tmp_path, lambda: multi.process_dl_slot([req, req2], [data, data2],
                                                               fetch=True))
    names = inside(spans, "multi_cell_phy.process_dl_slot")
    assert names.count("upper_phy.process_dl_slot") == 2 and names.count("dl_slot.run") == 2
    assert names[-1] == "upper_phy.dl_fetch"


def test_ul_entry_spans_and_counters(tmp_path):
    cell = CellConfig(nof_rb=24, dft_size=512, numerology=1)
    phy = UpperPhy(cell, device="cpu")
    pucch = PucchPdu(format=0, rnti=0x4601, prb_start=3, nof_prb=1, start_symbol=13,
                     nof_symbols=1, nof_harq_bits=1, n_id=1)
    req = UlTtiRequest(slot=1, pucch=(pucch,), prach=(PrachPdu(),))
    samples = np.zeros((1, ofdm.slot_sample_count(512, 1, 1), 2), np.float32)
    occasion = np.zeros((839, 2), np.float32)
    phy.process_ul_slot(req, samples, occasion)
    rec = tracing.last_calls(1)[0]
    assert rec["entry"] == "upper_phy.process_ul_slot"
    assert rec["h2d_bytes"] == samples.nbytes + occasion.nbytes and rec["d2h_bytes"] > 0
    _, spans = traced(tmp_path, lambda: phy.process_ul_slot(req, samples, occasion))
    names = inside(spans, "upper_phy.process_ul_slot")
    assert [n for n in names if n.startswith("upper_phy.")] == [
        "upper_phy.ul_validate", "upper_phy.ul_ofdm", "upper_phy.pucch", "upper_phy.prach"]


# ---------------------------------------------------------- the readers --

def synthetic_trace() -> trace_mod.Trace:
    """Two calls, each a harness span around an entry of 100 us whose named
    children cover 91 us: validate 2, plan 6, values 40 (host values 30 and
    upload 10 inside), run 20, fetch 23."""
    t = trace_mod.Trace()
    for base in (0.0, 1000.0):
        t.spans.append(("portbench.call", base, 120.0))
        for name, s, e in (("upper_phy.process_dl_slot", 10, 110),
                           ("upper_phy.dl_validate", 12, 14), ("upper_phy.dl_plan", 14, 20),
                           ("upper_phy.dl_values", 20, 60), ("dl_slot.host_values", 20, 50),
                           ("dl_slot.upload", 50, 60), ("dl_slot.run", 60, 80),
                           ("upper_phy.dl_fetch", 85, 108)):
            t.spans.append((name, base + s, float(e - s)))
    t.window = (0.0, 1120.0)
    return t


@pytest.mark.parametrize("name, want", [
    ("dl_launch_host_ms", 0.020), ("dl_fetch_host_ms", 0.023),
    ("dl_entry_self_host_ms", 0.009), ("h2d_bytes_per_slot", 1500.0),
    ("d2h_bytes_per_slot", 250.0)])
def test_reader_on_a_synthetic_trace(name, want):
    for k in range(2):
        with tracing.entry("upper_phy.process_dl_slot"):
            tracing.count("h2d_bytes", 1000 * (k + 1))
            tracing.count("d2h_bytes", 250)
    ctx = harness.TraceContext(synthetic_trace(), 2, None, [0, 1])
    reader = importlib.import_module(f"portbench.layer_metrics.{name}")
    assert reader.read(ctx) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NEW_READERS + ("dl_fetch_wait_host_ms", "dl_pinned_fetch_share",
                                                "dl_table_encode_share"))
def test_reader_reads_nothing_from_a_program_without_the_labels(name, monkeypatch):
    """A program without the spans or `last_calls` (the benchmark also runs
    older revisions): the reader returns None and does not raise."""
    monkeypatch.delattr(tracing, "last_calls")
    t = trace_mod.Trace(spans=[("portbench.call", 0.0, 50.0)], window=(0.0, 50.0))
    ctx = harness.TraceContext(t, 1, None, [0])
    assert importlib.import_module(f"portbench.layer_metrics.{name}").read(ctx) is None


def test_traced_harness_run_reports_every_reader():
    """A traced run of the DL cell on a 24-PRB carrier on the CPU: the five
    readers report, the byte counts are whole per call, and the named
    children cover all but a sliver of the entry."""
    bench, workload, config, traffic = dl_bench(24, 512)
    result, _ = harness.run(bench, workload, config, traffic, 2 ** 35 + 9, 0.5, True, "cpu",
                            0.0)
    m = {k: v["value"] for k, v in result["metrics"].items()}
    assert result["correct"] and set(NEW_READERS) <= set(m)
    # The pool alternates the two OFDM phases; 4 ports, real pairs.
    mean_samples = (ofdm.slot_sample_count(512, 1, 0) + ofdm.slot_sample_count(512, 1, 1)) / 2
    assert m["d2h_bytes_per_slot"] == 4 * 14 * 288 * 2 * 2 + 4 * mean_samples * 2 * 4
    assert m["h2d_bytes_per_slot"] > 0 and m["dl_launch_host_ms"] > 0
    assert m["dl_entry_self_host_ms"] < m["dl_launch_host_ms"] + m["dl_values_host_ms"]
    # On the CPU the fetch takes no pinned staging and has no wait to time.
    assert m["dl_pinned_fetch_share"] == 0.0 and "dl_fetch_wait_host_ms" not in m
    # Warm-up built the encode tables: every traced encode is a lookup.
    assert m["dl_table_encode_share"] == 1.0
