"""portbench: the benchmark of the PyTorch/CUDA port (`srsran_projectvtlmo_tpu_torch`).

One run drives one cell of BENCHMARK.json (a cell configuration under a
traffic mix) through the port's FAPI entry on one card, closed loop, and
prints one JSON result line.  `python3 portbench/run.py --help`.
"""
