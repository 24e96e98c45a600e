"""Run one cell of BENCHMARK.json once on the card and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  Every build and kernel cache goes to a
fixed directory inside the checkout (`.portbench_cache/`; the port builds
its LDPC library into its own `_build/`), so only a cell's first run in a
checkout builds.  The process computes on one host thread.  Exits non-zero
and prints no result without a CUDA card.
"""

import os
import sys
import time
from pathlib import Path

T0 = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
# One process with one compute thread: torch's default pool spins on every
# core of the card's host between the port's small CPU operations.
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    from portbench.harness import main

    sys.exit(main(sys.argv[1:], T0))
