"""What the traffic kinds share: the pool slot and the spec per cell.

A traffic kind is a module `portbench/traffic/<kind>.py`, found by the
`kind` of a traffic mix `portbench/traffic/<mix>.json`.  It holds:

  * `make_pool(traffic, config, seed, device, fapi)`: the mix's pool of
    distinct FAPI slots for the configuration's cells, from the seed;
  * `Cell(traffic, config, pool, phy, device, seed)`: drives the program
    (`call`), judges each call's outputs (`record`, returning the number of
    wrong cell-slots; `failed` counts them), starts over (`reset`), and
    gives the numbers the check compares once the window has closed
    (`check`);
  * `LIMITS`: each number's limit;
  * `CONTROLS`: name -> fn(make_phy, pool, config, device) giving what the
    control puts in the program's place (`portbench/control.py` runs them).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PoolSlot:
    """One FAPI slot of the pool: `args` is what the program's entry gets
    (besides the PHY object), `truth` per cell what a correct call returns,
    `ref` the same slot as the reference's own classes."""

    slot: int
    args: tuple
    truth: list
    ref: dict = field(default_factory=dict)


def per_cell(spec, nof_cells: int) -> list:
    """A mix's spec for every cell: one dict for all, or a list cycled."""
    specs = spec if isinstance(spec, list) else [spec]
    return [specs[c % len(specs)] for c in range(nof_cells)]
