"""Frozen copies of the coding parts of the port's `pbch` and `pdcch`."""
