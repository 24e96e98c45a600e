"""The upper PHY's slot engine: the uplink FAPI entry point (`upper_phy`),
the HARQ arena, PUCCH, the PRACH buffers, the two-phase PUSCH UCI
processor, the realtime slot machinery and receiver warmup."""
