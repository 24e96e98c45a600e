"""Chrome-trace-format event tracer for slot-level host instrumentation.

Mirrors the reference's file_event_tracer (reference: lib/support/
event_tracing.cpp:36-78): trace points + named spans written as Chrome
`chrome://tracing` / Perfetto JSON, with a background writer thread and a
no-op variant compiled out when disabled.  Device-side profiling composes with
torch.profiler traces; this covers the host slot pipeline.  A copy of
`srsran_projectvtlmo_tpu.utils.tracing` (the same Chrome-trace JSON).
"""

from __future__ import annotations

import json
import queue
import threading
import time
from contextlib import contextmanager


class NullTracer:
    """No-op tracer (the disabled template specialization of the reference)."""

    def begin(self, name: str) -> None:
        pass

    def end(self, name: str) -> None:
        pass

    @contextmanager
    def span(self, name: str):
        yield

    def instant(self, name: str, **args) -> None:
        pass

    def close(self) -> None:
        pass


class FileEventTracer:
    """Asynchronous Chrome-trace JSON writer."""

    def __init__(self, path: str, process_name: str = "upper_phy"):
        self._path = path
        self._q: queue.Queue = queue.Queue(maxsize=65536)
        self._events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 0,
             "args": {"name": process_name}},
        ]
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _now_us(self) -> float:
        return time.perf_counter() * 1e6

    def begin(self, name: str) -> None:
        self._push({"name": name, "ph": "B", "pid": 0, "tid": threading.get_ident() % 1000,
                    "ts": self._now_us()})

    def end(self, name: str) -> None:
        self._push({"name": name, "ph": "E", "pid": 0, "tid": threading.get_ident() % 1000,
                    "ts": self._now_us()})

    @contextmanager
    def span(self, name: str):
        self.begin(name)
        try:
            yield
        finally:
            self.end(name)

    def instant(self, name: str, **args) -> None:
        self._push({"name": name, "ph": "i", "s": "g", "pid": 0,
                    "tid": threading.get_ident() % 1000, "ts": self._now_us(),
                    "args": args})

    def _push(self, ev: dict) -> None:
        try:
            self._q.put_nowait(ev)
        except queue.Full:
            pass  # overflow-safe: drop, like the reference's bounded queue

    def _run(self) -> None:
        while not self._stop.is_set() or not self._q.empty():
            try:
                self._events.append(self._q.get(timeout=0.1))
            except queue.Empty:
                continue

    def close(self) -> None:
        self._stop.set()
        self._worker.join(timeout=2)
        with open(self._path, "w") as f:
            json.dump({"traceEvents": self._events}, f)


#: Global per-domain tracer instances (reference: include/srsran/instrumentation/
#: traces/du_traces.h l1_tracer etc.). Enabled by calling enable_tracing().
l1_tracer = NullTracer()


def enable_tracing(path: str) -> FileEventTracer:
    global l1_tracer
    l1_tracer = FileEventTracer(path)
    return l1_tracer
