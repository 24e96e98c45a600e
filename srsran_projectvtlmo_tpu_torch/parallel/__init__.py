"""Scaling across cells and cards: the multi-cell upper PHY
(`multi_cell_phy.MultiCellUpperPhy`), cell-batched slot programs
(`multi_cell`), codeblock- and sample-axis sharding (`cb_shard`,
`sample_shard`) and the (cell, sp) mesh over `torch.distributed`
(`distributed`, `mesh`)."""

from .mesh import cell_mesh, shard_leading
from .multi_cell import build_multi_cell_pusch_rx, build_multi_cell_ulsch_tx
