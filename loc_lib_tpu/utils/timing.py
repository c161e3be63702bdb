"""Timing and profiling instruments.

Rebuild of the reference's performance tooling:

  * `TicToc` (/root/reference/LocUtils/include/LocUtils/tools/tic_toc.hpp:
    13-30) — wall-clock stopwatch returning milliseconds.
  * `evaluate_and_call` (/root/reference/LocUtils/include/LocUtils/common/
    sys_utils.h:23-32) — N-run average micro-benchmark logger.

Both are extended for the async XLA dispatch model: device work must be
fenced with `jax.block_until_ready` or the stopwatch only measures Python
dispatch. `trace` wraps `jax.profiler` so hot paths can be inspected in
TensorBoard/XProf — the structured tracing the reference lacks
(SURVEY.md section 5: "No structured tracing").
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Callable, Optional

import jax

log = logging.getLogger("loc_lib_tpu")


class TicToc:
    """Stopwatch in milliseconds (tic_toc.hpp:13-30); `toc()` restarts."""

    def __init__(self):
        self.tic()

    def tic(self) -> None:
        self._t0 = time.perf_counter()

    def toc(self, block_on=None) -> float:
        if block_on is not None:
            jax.block_until_ready(block_on)
        ms = (time.perf_counter() - self._t0) * 1e3
        self.tic()
        return ms


def evaluate_and_call(func: Callable, name: str = "method", times: int = 10,
                      warmup: int = 1) -> float:
    """Average ms per call over `times` runs (sys_utils.h:23-32), with
    compile warm-up runs excluded and device completion fenced. Returns the
    mean ms and logs it like the reference."""
    for _ in range(warmup):
        jax.block_until_ready(func())
    t0 = time.perf_counter()
    out = None
    for _ in range(times):
        out = func()
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) * 1e3 / max(times, 1)
    log.info("方法 %s 平均调用时间/次数: %.5f/%d 毫秒.", name, ms, times)
    return ms


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, name: str = "loc_lib_tpu"):
    """Structured device tracing: `with trace('/tmp/xprof'):` records an
    XLA profile viewable in TensorBoard; with no log_dir it is a cheap
    named annotation (`jax.profiler.TraceAnnotation`) that shows up inside
    an enclosing trace."""
    if log_dir is not None:
        jax.profiler.start_trace(log_dir)
        try:
            yield
        finally:
            jax.profiler.stop_trace()
    else:
        with jax.profiler.TraceAnnotation(name):
            yield


class StageTimer:
    """Per-stage ms accumulator for pipeline drivers (the replay harness's
    per-kernel timing, SURVEY.md section 5). Usage:

        st = StageTimer()
        with st.stage("match"): ...
        st.report()
    """

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                jax.block_until_ready(block_on)
            ms = (time.perf_counter() - t0) * 1e3
            self.totals[name] = self.totals.get(name, 0.0) + ms
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def report(self) -> dict[str, float]:
        out = {k: self.mean_ms(k) for k in self.totals}
        for k, v in sorted(out.items()):
            log.info("stage %-20s %8.3f ms/call x%d", k, v, self.counts[k])
        return out
