"""Metrics hub: per-channel aggregation with stdout/JSON plotters.

Mirrors the reference's metrics_hub -> stdout/JSON plotter pipeline
(reference: apps/services/metrics_hub.cpp, metrics_plotter_stdout.cpp) for the
PHY-relevant counters: slot rates, CRC OK ratios, post-equalization SNR, EVM,
timing advance, PRACH detections.

The port's own copy of `srsran_projectvtlmo_tpu.phy.metrics`, unchanged;
tests/test_torch_host_copies.py holds it equal to the original.
"""

from __future__ import annotations

import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class ChannelMetrics:
    count: int = 0
    ok: int = 0
    snr_db_sum: float = 0.0
    ta_s_sum: float = 0.0
    evm_sum: float = 0.0

    @property
    def ok_ratio(self) -> float:
        return self.ok / self.count if self.count else 0.0

    @property
    def avg_snr_db(self) -> float:
        return self.snr_db_sum / self.count if self.count else 0.0


class MetricsHub:
    def __init__(self):
        self._channels: dict[str, ChannelMetrics] = defaultdict(ChannelMetrics)
        self._slots = 0
        self._t0 = time.perf_counter()

    def on_slot(self) -> None:
        self._slots += 1

    def on_pusch(self, crc_ok: bool, snr_db: float = 0.0, ta_s: float = 0.0,
                 evm: float = 0.0) -> None:
        m = self._channels["pusch"]
        m.count += 1
        m.ok += int(crc_ok)
        m.snr_db_sum += snr_db
        m.ta_s_sum += ta_s
        m.evm_sum += evm

    def on_uci(self, valid: bool) -> None:
        m = self._channels["uci"]
        m.count += 1
        m.ok += int(valid)

    def on_prach(self, nof_detections: int) -> None:
        m = self._channels["prach"]
        m.count += 1
        m.ok += int(nof_detections > 0)

    def snapshot(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        out = {
            "slots": self._slots,
            "slot_rate": self._slots / dt,
            "elapsed_s": dt,
        }
        for name, m in self._channels.items():
            out[name] = {
                "count": m.count,
                "ok_ratio": round(m.ok_ratio, 4),
                "avg_snr_db": round(m.avg_snr_db, 2),
            }
        return out

    def print_stdout(self) -> None:
        s = self.snapshot()
        line = f"slots={s['slots']} rate={s['slot_rate']:.1f}/s"
        for name in ("pusch", "uci", "prach"):
            if name in s:
                line += f" | {name}: n={s[name]['count']} ok={s[name]['ok_ratio']:.2%}"
                if name == "pusch":
                    line += f" snr={s[name]['avg_snr_db']:.1f}dB"
        print(line)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2)
