"""Per-layer metric readers, one module per metric named in BENCHMARK.json:
`read(ctx) -> float | None`, None where the trace holds nothing to read.
`ctx` is a `portbench.harness.TraceContext`."""
