"""The benchmark's plain reference.

`dl` is the reference of a DL slot, written from TS 38.211/38.212 in numpy:
every sequence, resource element and the OFDM modulation are its own; it
takes the channel coding (CRC and segmentation, the LDPC encoder, the TBS
formula, the polar coding of DCI and BCH) from the frozen copies beside it.

The rest are frozen copies of the port's plain torch code (`fapi/`, `ran/`,
`utils/`, `ops/`, the coding parts of `phy/pbch` and `phy/pdcch`) and of the
tables they read (`data/`), taken when the benchmark was defined, so that a
later change to the port cannot move the yardstick.  Nothing here imports
the port, JAX or the JAX package.
"""
