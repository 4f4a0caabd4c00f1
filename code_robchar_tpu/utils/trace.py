"""Tracing / profiling helpers.

The reference has no tracing (SURVEY.md §5 — tqdm + prints; its real cost
telemetry is function-call accounting, reproduced in the record protocol).
This module adds device-level observability on top:

- ``trace(logdir)``: context manager around jax.profiler for TensorBoard
  traces of the jitted programs.
- ``timed(tag)``: wall-clock section timer that waits for ``sync_on``
  (``jax.block_until_ready``) so numbers are honest on asynchronous
  backends.
- ``Stopwatch``: accumulating named timers for host-side loops.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import jax


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(tag: str, sync_on: Optional[object] = None,
          printer=print) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        if sync_on is not None:
            jax.block_until_ready(sync_on)
        printer(f"[{tag}] {time.perf_counter() - start:.3f}s")


class Stopwatch:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, tag: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[tag] += time.perf_counter() - start
            self.counts[tag] += 1

    def report(self) -> str:
        lines = [f"{tag}: {tot:.3f}s / {self.counts[tag]} calls"
                 for tag, tot in sorted(self.totals.items())]
        return "\n".join(lines)
