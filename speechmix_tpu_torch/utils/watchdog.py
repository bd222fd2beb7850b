"""Stall watchdog (port of ``speechmix_tpu.utils.watchdog``): failure
detection for wedged device steps.

A hung training process (a device call that never returns) would block
forever with no signal.  This watchdog runs a daemon thread beside the
training loop; the loop calls `beat()` every iteration, and if no beat
arrives for `timeout_s` the watchdog invokes `on_stall` — by default
logging a JSONL record and hard-exiting with a distinctive status so a
supervisor can relaunch the training, which resumes from the latest
checkpoint (``Trainer.fit(resume=True)``).

Crash-consistent recovery = step-indexed checkpoints (training/checkpoint.py)
+ resume-from-latest + this detector.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional

STALL_EXIT_CODE = 98  # distinctive: supervisors treat it as "restart me"


class StallWatchdog:
    """Fires `on_stall(seconds_since_beat)` if `beat()` stops arriving.

    Usage:
        wd = StallWatchdog(timeout_s=300, on_stall=...)
        wd.start()
        for batch in ...:
            wd.beat()
            step(...)
        wd.stop()
    """

    def __init__(self, timeout_s: float,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: Optional[float] = None):
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall or self._default_on_stall
        self.poll_s = poll_s if poll_s is not None else \
            max(self.timeout_s / 10.0, 0.05)
        self._last = time.monotonic()
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.log_path: Optional[str] = None

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "StallWatchdog":
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="smx-stall-watchdog")
        self._thread.start()
        return self

    def beat(self):
        self._last = time.monotonic()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.poll_s + 1.0)

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    # -- internals -----------------------------------------------------------
    def _run(self):
        while not self._stop.wait(self.poll_s):
            idle = time.monotonic() - self._last
            if idle >= self.timeout_s:
                self._fired.set()
                self.on_stall(idle)
                return

    def _default_on_stall(self, idle: float):
        record = {"stall_detected": True, "idle_seconds": round(idle, 1),
                  "pid": os.getpid(), "exit_code": STALL_EXIT_CODE}
        try:
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(json.dumps(record) + "\n")
                    f.flush()
                    os.fsync(f.fileno())
        finally:
            os.write(2, (json.dumps(record) + "\n").encode())
            os._exit(STALL_EXIT_CODE)
