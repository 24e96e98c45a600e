"""Readings that the check's limits are set from: the program's numbers and
the controls', over many seeds, in one process on the card.

    python3 portbench/control.py --workload <name> --seeds 11,12,13 [--passes 2] [--controls 3]

Per seed it makes the cell's pool afresh and drives, through the harness's
own loop and check, `passes` passes over the pool of the program, then of
each of the traffic kind's `CONTROLS` in the program's place (`dl_slot`: the
reference with its grid in float8).  Prints one JSON line per seed.  The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def readings(workload: dict, config: dict, traffic: dict, seed: int, passes: int,
             device, controls: bool = True) -> dict:
    """{"program": numbers, <control>: numbers, ...} of one seed (the
    program's alone without `controls`)."""
    kind = harness.kind_of(traffic)
    fapi, _, _ = harness.port_modules()
    pool = kind.make_pool(traffic, config, seed, device, fapi)

    def make_phy():
        return harness.make_phy(config, device)

    phys = {"program": make_phy()}
    for name, control in (kind.CONTROLS.items() if controls else ()):
        phys[name] = control(make_phy, pool, config, device)
    out = {}
    for name, phy in phys.items():
        cell = kind.Cell(traffic, config, pool, phy, device, seed)
        harness.run_window(cell, 0.0, len(pool), max_calls=len(pool))  # warm-up pass
        cell.reset()
        harness.run_window(cell, 0.0, len(pool), max_calls=passes * len(pool))
        harness.sync(device)
        out[name] = cell.check()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--passes", type=int, default=2)
    p.add_argument("--controls", type=int, default=3,
                   help="run the controls on the first this many seeds")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = harness.load_benchmark()
    workload, config, traffic = harness.find_cell(bench, args.workload)
    device = torch.device("cuda", 0)
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        line = readings(workload, config, traffic, seed, args.passes, device,
                        n < args.controls)
        print(json.dumps({"workload": args.workload, "seed": seed, "seconds":
                          round(time.perf_counter() - t0, 1), **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
