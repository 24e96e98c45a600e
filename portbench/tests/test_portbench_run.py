"""The run command: no card, no result; and one small run end to end on the
CPU through `harness.run` (everything after the look for a card)."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload", "dl_full_1cell",
                          "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_unknown_workload_exits(tmp_path):
    res = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "nope", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.parametrize("nof_cells", [1, 2])
def test_small_run_on_the_cpu_is_correct(cell_of, nof_cells):
    from portbench import harness

    name = "dl_full_1cell"
    bench, workload, config, traffic = cell_of(name, nof_cells)
    result, numbers = harness.run(bench, workload, config, traffic, 2 ** 40 + 3, 0.5, False,
                                  "cpu", time.perf_counter())
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert result["attempted"] % nof_cells == 0
    want = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    assert set(result["metrics"]) == want and {"cell_slots_per_s", "setup_s"} <= want
    assert list(result)[-1] == "checks"
    assert json.loads(json.dumps(result)) == result


def test_traced_small_run_reads_the_spans(cell_of):
    from portbench import harness

    bench, workload, config, traffic = cell_of("dl_full_1cell")
    result, _ = harness.run(bench, workload, config, traffic, 5, 0.5, True, "cpu",
                            time.perf_counter())
    assert result["correct"]
    assert result["metrics"]["dl_values_host_ms"]["value"] > 0
    assert result["device"]["window_s"] > 0 and "breakdown" in result
