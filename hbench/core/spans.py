"""The harness's spans: host-clock intervals around each call into a
layer, by name. While a profiler runs they also enter its trace as
``hbench::<name>`` ranges, so the device's idle gaps can be labelled by
what the host was doing."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class Spans:
    def __init__(self):
        self.seconds = defaultdict(list)
        self.profiling = False
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            if self.profiling:
                from torch.profiler import record_function

                with record_function(f"hbench::{name}"):
                    yield
            else:
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name].append(dt)

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
