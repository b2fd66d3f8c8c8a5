"""Wall-clock accounting and the stall watchdog (framework-free; a copy of
navierstokes3d_tpu/utils/timers.py without its roofline): time per step
and Poisson iterations per second.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class StepRecord:
    it: int
    wall_s: float
    poisson_iters: int
    err: float


class RunTimer:
    def __init__(self):
        self.records: List[StepRecord] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.time()

    def stop(self, it: int, poisson_iters: int, err: float) -> StepRecord:
        rec = StepRecord(it=it, wall_s=time.time() - self._t0,
                         poisson_iters=poisson_iters, err=err)
        self.records.append(rec)
        return rec

    def summary(self, skip_first: int = 1) -> dict:
        recs = self.records[skip_first:] or self.records
        if not recs:
            return {}
        total = sum(r.wall_s for r in recs)
        iters = sum(r.poisson_iters for r in recs)
        return {
            "steps": len(recs),
            "time_per_step_s": total / len(recs),
            "poisson_iters_per_sec": iters / total if total else 0.0,
            "total_wall_s": total,
        }


class StallWatchdog:
    """Hard-exits the process when the run makes no progress for
    `timeout_s` seconds.

    A wedged device runtime can block forever inside a device call, where
    no Python exception, signal handler or timeout wrapper interrupts the
    blocked thread. The watchdog runs on a daemon thread; the run loop
    calls beat() after every completed host sync. On expiry it writes a
    diagnosis to stderr and os._exit(exit_code), so a supervisor can
    restart the SAME command with --resume (run.py's --nt is the total
    horizon, so the restart completes the run from the last checkpoint).

    Pick timeout_s well above the slowest legitimate gap between syncs:
    the first step's set-up (the kernels' build) plus --sync-every steps
    of compute.
    """

    def __init__(self, timeout_s: float, exit_code: int = 3,
                 message: str = ""):
        import threading
        self.timeout_s = float(timeout_s)
        self.exit_code = int(exit_code)
        self.message = message
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)

    def start(self) -> "StallWatchdog":
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()

    def _watch(self):
        import os as _os
        import sys as _sys
        poll = max(0.05, min(5.0, self.timeout_s / 4.0))
        while not self._stop.wait(poll):
            idle = time.monotonic() - self._last
            if idle > self.timeout_s:
                print(f"STALL: no progress for {idle:.0f}s "
                      f"(--stall-timeout {self.timeout_s:.0f}s); the "
                      f"device runtime is likely wedged. {self.message}",
                      file=_sys.stderr, flush=True)
                _os._exit(self.exit_code)
