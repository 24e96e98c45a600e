"""3GPP host-side constants and derivations (LDPC parameters, modulation, SCH
sizes): copies of the JAX package's `ran` modules the port needs, held equal
to the originals by tests/test_torch_host_copies.py."""
