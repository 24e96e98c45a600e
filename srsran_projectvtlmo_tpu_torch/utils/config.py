"""YAML-surfaced configuration for cells and the PHY engine (port of
`srsran_projectvtlmo_tpu.utils.config`).

Keeps the reference's layered approach (YAML -> validated structs ->
per-subsystem configs; reference: apps/gnb/gnb_appconfig_cli11_schema.cpp,
apps/units/flexible_du/du_low/du_low_config.h) with dataclasses.  PyYAML is
imported by `load_config` only: the package, the app and the entry module
import without it, and a machine without it runs everything but `--config`.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields
from pathlib import Path

from ..phy.upper_phy import CellConfig, ExpertPhyConfig


@dataclass
class GnbConfig:
    cells: list[CellConfig] = field(default_factory=lambda: [CellConfig()])
    expert_phy: ExpertPhyConfig = field(default_factory=ExpertPhyConfig)


def _build(cls, data: dict):
    kwargs = {}
    names = {f.name for f in fields(cls)}
    for key, value in (data or {}).items():
        if key not in names:
            raise ValueError(f"unknown {cls.__name__} field: {key}")
        kwargs[key] = value
    return cls(**kwargs)


def load_config(path: str | Path) -> GnbConfig:
    try:
        import yaml
    except ImportError as e:
        raise ImportError("load_config reads YAML and needs PyYAML, which is not "
                          "installed") from e
    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    cells = [_build(CellConfig, c) for c in raw.get("cells", [{}])]
    expert = _build(ExpertPhyConfig, raw.get("expert_phy", {}))
    return GnbConfig(cells=cells, expert_phy=expert)
