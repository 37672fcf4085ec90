"""Seconds of each stage of a cell's set-up, printed to standard error
before the check's lines (where set-up time goes, for PERF.md)."""
from __future__ import annotations

import time


class Stages:
    def __init__(self):
        self.seconds, self._t = {}, time.perf_counter()

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self._t, 4)
        self._t = now
