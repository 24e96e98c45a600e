"""The upper PHY's slot engine: the FAPI entry point (`upper_phy`), the DL
slot assembly (`dl_slot`, with `pbch` and `pdcch`), the HARQ arena, PUCCH,
the PRACH buffers, the two-phase PUSCH UCI processor, the realtime slot
machinery and receiver warmup."""
