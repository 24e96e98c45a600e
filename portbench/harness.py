"""One run of one cell: set-up, the closed-loop window, the check against the
reference, the result line.

The cell's configuration (`configs/<config>.json`), traffic mix
(`traffic/<traffic>.json`, whose `kind` names `traffic/<kind>.py`: the
generator, the check and its limits) and per-layer metrics
(`layer_metrics/<name>.py`) are found by the names in BENCHMARK.json.  The
program under test is the port's FAPI entry: `UpperPhy` for one cell,
`MultiCellUpperPhy` for more, with the method the traffic kind calls.  A
call ends when its outputs are on the host.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import math
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PORT = "srsran_projectvtlmo_tpu_torch"
#: Top-level module names that may not be loaded in a run.
FORBIDDEN = ("jax", "jaxlib", "flax", "srsran_projectvtlmo_tpu")
#: FAPI calls profiled in a `--trace 1` run: three passes over the pool.
TRACE_POOL_PASSES = 3
#: Warm-up passes over the pool in set-up.
WARMUP_PASSES = 2


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration dict, traffic dict) of a cell name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    with open(ROOT / entry["file"]) as f:
        config = json.load(f)
    with open(HERE / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return w, config, traffic


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def kind_of(traffic: dict):
    """The traffic kind's module, `portbench/traffic/<kind>.py`."""
    return importlib.import_module(f"portbench.traffic.{traffic['kind']}")


def judge(numbers: dict, limits: dict) -> bool:
    return all(v is not None and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())


def port_modules():
    """The port's modules the harness drives (imported after the card check):
    (its FAPI classes, `phy.upper_phy`, `parallel.multi_cell_phy`)."""
    fapi = importlib.import_module(f"{PORT}.fapi.pdus")
    upper = importlib.import_module(f"{PORT}.phy.upper_phy")
    multi = importlib.import_module(f"{PORT}.parallel.multi_cell_phy")
    return fapi, upper, multi


def make_phy(config: dict, device):
    _, upper, multi = port_modules()
    fields = upper.CellConfig.__dataclass_fields__
    cell = upper.CellConfig(**{k: v for k, v in config["cell"].items() if k in fields})
    expert = upper.ExpertPhyConfig(**config["expert"])
    if config["nof_cells"] == 1:
        return upper.UpperPhy(cell, expert, device=device)
    return multi.MultiCellUpperPhy(cell, config["nof_cells"], expert=expert, device=device)


def make_cell(traffic: dict, config: dict, pool: list, phy, device, seed: int):
    return kind_of(traffic).Cell(traffic, config, pool, phy, device, seed)


# ------------------------------------------------------------ the run --


@dataclass
class TraceContext:
    """What a per-layer reader gets: the reduced trace, the cell-slots the
    traced window served, the traffic kind's `Cell` and the pool index of
    each traced call (for a reader that needs the work of those slots)."""

    trace: object
    cell_slots: int
    cell: object
    calls: list


def run_window(cell, seconds: float, pool_len: int, max_calls: int | None = None):
    """The closed loop: one call in flight, back to back, cycling the pool,
    for `seconds` (or `max_calls` calls).  Returns (latencies s, window s,
    the pool index of each call); a call that raised has latency inf."""
    from torch.profiler import record_function

    lat, calls = [], []
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while True:
        if max_calls is not None and i >= max_calls:
            break
        if max_calls is None and time.perf_counter() - t_start >= seconds:
            break
        k = i % pool_len
        t0 = time.perf_counter()
        try:
            with record_function("portbench.call"):
                out = cell.call(k)
            t1 = time.perf_counter()
            bad = cell.record(k, out)
            lat.append(math.inf if bad else t1 - t0)
        except Exception as exc:  # a call that raises counts as failed; the loop goes on
            print(f"call {i} (pool slot {k}) raised {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            sync(cell.device)
            cell.record(k, None)
            lat.append(math.inf)
            t1 = time.perf_counter()
        t_end = t1
        calls.append(k)
        i += 1
    return lat, t_end - t_start, calls


def device_info(device, count: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":  # the CPU tests' runs
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def read_layer_metrics(bench: dict, workload: str, ctx: TraceContext) -> dict:
    out = {}
    for m in bench["per_layer"]:
        if workload not in m.get("workloads", [workload]):
            continue
        value = importlib.import_module(f"portbench.layer_metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse_args(argv):
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(bench: dict, workload: dict, config: dict, traffic: dict, seed: int, seconds: float,
        trace: bool, device, t0: float) -> tuple[dict, dict]:
    """Everything of a run after the look for the card: set-up, the window,
    the check.  Returns (the result line's object, the numbers compared)."""
    import torch

    kind = kind_of(traffic)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    fapi, _, _ = port_modules()
    phy = make_phy(config, device)
    pool = kind.make_pool(traffic, config, seed, device, fapi)
    cell = kind.Cell(traffic, config, pool, phy, device, seed)
    run_window(cell, 0.0, len(pool), max_calls=WARMUP_PASSES * len(pool))
    sync(device)
    cell.reset()
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's collections
    setup_s = time.perf_counter() - t0

    if trace:
        from torch.profiler import ProfilerActivity, profile

        out_dir = ROOT / ".portbench"
        out_dir.mkdir(exist_ok=True)
        trace_path = out_dir / "trace.json"
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            lat, window_s, calls = run_window(cell, seconds, len(pool),
                                              max_calls=TRACE_POOL_PASSES * len(pool))
            sync(device)
        prof.export_chrome_trace(str(trace_path))
    else:
        lat, window_s, calls = run_window(cell, seconds, len(pool))
    sync(device)
    dev = device_info(device, workload["chips"])

    # The check, once the window has closed and the peak has been read; the
    # reference runs in float32 without TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers = cell.check()
    ncell = config["nof_cells"]
    attempted = len(lat) * ncell
    result = {"correct": judge(numbers, kind.LIMITS), "attempted": attempted, "failed": cell.failed}
    if trace:
        from . import trace as trace_mod

        tr = trace_mod.load(str(trace_path))
        trace_path.unlink()
        ctx = TraceContext(tr, len(calls) * ncell, cell, calls)
        result["metrics"] = read_layer_metrics(bench, workload["name"], ctx)
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["device"] = dev
        result["breakdown"] = trace_mod.breakdown(tr)
    else:
        p95 = float(np.percentile(lat, 95)) * 1e3
        values = {"cell_slots_per_s": (attempted - cell.failed) / window_s,
                  "slot_latency_p95_ms": p95 if math.isfinite(p95) else None,
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in bench["end_to_end"]
                             if workload["name"] in m.get("workloads", [workload["name"]])}
        result["device"] = dev
    result["checks"] = {k: {"value": v, "limit": kind.LIMITS[k]} for k, v in numbers.items()}
    print(f"{workload['name']}: {len(lat)} calls in {window_s:.3f} s, seed {seed}",
          file=sys.stderr)
    return result, numbers


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    bench = load_benchmark()
    workload, config, traffic = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card and never falls back to the CPU",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < workload["chips"]:
        print(f"the cell needs {workload['chips']} cards, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    result, numbers = run(bench, workload, config, traffic, args.seed, args.seconds,
                          bool(args.trace), torch.device("cuda", 0), t0)
    found = forbidden_modules()
    if found:
        print(f"modules that a run may not load are loaded: {found}", file=sys.stderr)
        return 4
    limits = kind_of(traffic).LIMITS
    for k, v in numbers.items():
        print(f"check {k} {v!r} limit {limits[k]!r} {'ok' if judge({k: v}, limits) else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
