"""Traffic: mixes are data files `<mix>.json`; each names a `kind`, a module
`<kind>.py` beside them (see `portbench.pool`)."""
