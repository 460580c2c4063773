"""Hang watchdog (echr_tpu/utils/watchdog.py), the port's copy: make a
silent stall of a long loop visible.

A loop that waits on a device fetch that never returns logs nothing.
The watchdog's daemon thread checks progress every ``deadline_s / 4``;
when no ``beat()`` landed within ``deadline_s`` it logs a WARNING naming
the loop and the stall's age and dumps every thread's Python stack to
stderr (``faulthandler``), so the call that never returned is named.  It
re-arms and warns again every deadline, and never kills the process:

    wd = HangWatchdog("eval", deadline_s=600).start()
    try:
        while ...:
            wd.beat()
            step(...)
    finally:
        wd.stop()
"""
from __future__ import annotations

import faulthandler
import logging
import sys
import threading
import time

log = logging.getLogger("echr_tpu_torch.watchdog")


class HangWatchdog:
    """Warn and dump all threads' stacks when a loop stops making progress.

    deadline_s <= 0 disables the watchdog (``start`` starts no thread), so
    callers can wire it unconditionally behind a config value.
    """

    def __init__(self, name: str, deadline_s: float, dump_stacks: bool = True):
        self.name = name
        self.deadline_s = float(deadline_s)
        self.dump_stacks = dump_stacks
        self.trips = 0  # warnings issued
        self._last = time.monotonic()
        self._suspended = False
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "HangWatchdog":
        if self.deadline_s > 0 and self._thread is None:
            self._stop.clear()  # restartable: stop() left the event set
            self._last = time.monotonic()
            self._thread = threading.Thread(target=self._run, name=f"hang-watchdog-{self.name}",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self) -> "HangWatchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def beat(self) -> None:
        """Mark progress: one clock read and one store; call once per
        iteration of the guarded loop."""
        self._last = time.monotonic()

    def suspend(self) -> None:
        """Pause stall detection across a long legitimate section without
        stopping the thread."""
        self._suspended = True

    def resume(self) -> None:
        self._last = time.monotonic()
        self._suspended = False

    def _run(self) -> None:
        poll = max(self.deadline_s / 4.0, 0.05)
        while not self._stop.wait(poll):
            if self._suspended:
                continue
            stalled = time.monotonic() - self._last
            if stalled < self.deadline_s:
                continue
            self.trips += 1
            log.warning(
                "%s loop has made no progress for %.0fs (deadline %.0fs): likely a wedged "
                "device launch or fetch; this watchdog only reports.  Dumping all thread "
                "stacks to stderr.", self.name, stalled, self.deadline_s)
            if self.dump_stacks:
                try:
                    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
                except Exception:  # never let observability kill the loop
                    log.exception("stack dump failed")
            self._last = time.monotonic()  # re-arm: warn once per deadline
