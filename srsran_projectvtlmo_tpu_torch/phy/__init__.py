"""Upper-PHY processors built on the models: the two-phase PUSCH UCI processor."""
