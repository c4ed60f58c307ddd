"""Tracing / profiling hooks (SURVEY.md section 6).

The reference has ad-hoc prints; the device build exposes:

  * ``device_trace(dir)`` — jax.profiler context writing a Perfetto
    trace of every kernel launch (view at ui.perfetto.dev);
  * ``StageTimer`` — wall-clock per-stage accounting with
    block_until_ready semantics, feeding the run manifest.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator


@contextlib.contextmanager
def device_trace(out_dir: str) -> Iterator[None]:
    import jax

    jax.profiler.start_trace(out_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StageTimer:
    """Accumulating per-stage timer: with timer('topk'): ..."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, stage: str, sync=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                import jax

                jax.block_until_ready(sync)
            self.seconds[stage] += time.perf_counter() - t0
            self.calls[stage] += 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"seconds": round(v, 4), "calls": self.calls[k]}
            for k, v in sorted(self.seconds.items())
        }
