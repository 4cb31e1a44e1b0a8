"""Per-stage wall-clock accounting (twin of StageTimer in
litcoder_core_tpu/utils/profiling.py)."""

import logging
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

logger = logging.getLogger(__name__)


class StageTimer:
    """Accumulates wall-clock per named stage.

    `sync_fn` runs at the end of each stage before the clock is read; on a
    card pass torch.cuda.synchronize, or asynchronous launches would count
    in whichever later stage waits for them."""

    def __init__(self, sync_fn=None):
        self._sync_fn = sync_fn
        self._stages: List[Tuple[str, float]] = []

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync_fn is not None:
                self._sync_fn()
            self._stages.append((name, time.perf_counter() - t0))

    def totals(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, dt in self._stages:
            out[name] = out.get(name, 0.0) + dt
        return out

    def report(self) -> Dict[str, float]:
        totals = self.totals()
        total = sum(totals.values()) or 1.0
        for name, dt in sorted(totals.items(), key=lambda kv: -kv[1]):
            logger.info("stage %-24s %8.3fs  (%4.1f%%)", name, dt,
                        100.0 * dt / total)
        logger.info("stage %-24s %8.3fs", "TOTAL", total)
        return totals
