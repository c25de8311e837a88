"""Single-thread device executor: every device section runs on ONE OS thread.

All device-touching sections are shipped to one dedicated daemon thread
("device-executor") and the callers block on a Future. Two admission classes
keep the critical path fast: priority sections (the mapper's
register/triangulate/BA phases) are drained before background ones (matcher
chunks, extraction batches), and idle ones (prewarm compiles) run only when
the mapper has been quiet for a while — so a registration waits for at most
the one in-flight background section.

Cost: one cross-thread hop (~10 us) per section, and no host/device overlap
inside a section. Whether dispatching from several threads serves the GPU
better is ROADMAP D1's to measure; the mechanism is kept until then.

Usage:
    @device_lock.locked               # priority (mapper) section
    @device_lock.locked_background    # background-producer section

Nested decorated calls already running on the executor thread run inline.
"""

from __future__ import annotations

import functools
import threading
from collections import deque
from concurrent.futures import Future


class DeviceExecutor:
    # after a priority section completes, background sections yield for this
    # long. Off by default: with a hold-off the mapper's short inter-section
    # host gaps starved the frontend (extraction slowed, and mapping then
    # waited on the pair feed) while the mapper's queue wait barely fell —
    # that wait is dominated by in-flight section residuals, not admission.
    # Kept as a tunable (0 = no hold-off) because the trade-off flips when
    # matching has no slack (e.g. exhaustive matching on short sequences).
    BG_HOLDOFF = 0.0

    # idle sections (prewarm compiles) are admitted only after the priority
    # lane has been quiet for this long. Each journal replay compile holds
    # the device thread for seconds even on persistent-cache hits, and a
    # long journal outlives the rendering/extraction window it was meant to
    # hide in; without the gate every priority section queued behind an
    # in-flight compile. With it, prewarm runs during rendering/extraction
    # and genuine mapper stalls (pair-feed waits), and mid-mapping shapes
    # compile lazily on first use — paying only for shapes the run needs,
    # inside the phase that needs them.
    IDLE_HOLDOFF = 5.0

    def __init__(self):
        self._cv = threading.Condition()
        self._prio: deque = deque()
        self._bg: deque = deque()
        self._idle: deque = deque()
        self._thread: threading.Thread | None = None
        self._last_prio_end = 0.0

    def _ensure_thread(self):
        with self._cv:
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, daemon=True, name="device-executor"
                )
                self._thread.start()

    def _run(self):
        import time as _time

        while True:
            with self._cv:
                while True:
                    if self._prio:
                        kind = "prio"
                        fut, fn, args, kwargs = self._prio.popleft()
                        break
                    now = _time.monotonic()
                    holdoff = self._last_prio_end + self.BG_HOLDOFF - now
                    if self._bg and holdoff <= 0:
                        fut, fn, args, kwargs = self._bg.popleft()
                        kind = "bg"
                        break
                    idle_holdoff = self._last_prio_end + self.IDLE_HOLDOFF - now
                    if self._idle and not self._bg and idle_holdoff <= 0:
                        fut, fn, args, kwargs = self._idle.popleft()
                        kind = "bg"
                        break
                    timeout = None
                    if self._bg and holdoff > 0:
                        timeout = holdoff
                    elif self._idle and idle_holdoff > 0:
                        timeout = idle_holdoff
                    self._cv.wait(timeout=timeout)
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args, **kwargs))
            except BaseException as e:  # propagate to the submitting thread
                fut.set_exception(e)
            if kind == "prio":
                with self._cv:
                    self._last_prio_end = _time.monotonic()

    def cancel_idle(self):
        """Cancel every queued idle section (their callers see
        CancelledError); a running one is left to finish."""
        with self._cv:
            while self._idle:
                self._idle.popleft()[0].cancel()

    def run(self, fn, args=(), kwargs=None, priority=True, idle=False):
        """Run fn on the device thread, blocking until it completes.

        Re-entrant: calls made from the device thread itself run inline
        (a nested section must not deadlock waiting on its own queue)."""
        if threading.current_thread() is self._thread:
            return fn(*args, **(kwargs or {}))
        self._ensure_thread()
        fut: Future = Future()
        q = self._idle if idle else (self._prio if priority else self._bg)
        if priority and not idle:
            # account the mapper's queue wait (time a priority section spends
            # behind an in-flight background section) into the phase report —
            # it is wall-clock inside local/global refinement that no inner
            # phase sees (SURVEY §5.1 observability)
            import time as _time

            from .logging_utils import PHASES

            t_submit = _time.time()
            inner = fn

            def timed(*a, **k):
                wait = _time.time() - t_submit
                PHASES.totals["exec_wait_prio"] = (
                    PHASES.totals.get("exec_wait_prio", 0.0) + wait
                )
                PHASES.counts["exec_wait_prio"] = (
                    PHASES.counts.get("exec_wait_prio", 0) + 1
                )
                return inner(*a, **k)

            fn = timed
        with self._cv:
            q.append((fut, fn, args, kwargs or {}))
            self._cv.notify()
        return fut.result()


EXECUTOR = DeviceExecutor()


def locked(fn):
    """Run the wrapped callable on the device thread (priority class)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return EXECUTOR.run(fn, args, kwargs, priority=True)

    return wrapper


def locked_background(fn):
    """Run the wrapped callable on the device thread (background class):
    drained only when no priority section is queued."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return EXECUTOR.run(fn, args, kwargs, priority=False)

    return wrapper


def locked_idle(fn):
    """Run the wrapped callable on the device thread (idle class): drained
    only when BOTH the priority and background queues are empty — prewarm
    tracing/compiles (~6 s each even on persistent-cache hits) must never
    delay extraction, matching, or the mapper."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return EXECUTOR.run(fn, args, kwargs, priority=False, idle=True)

    return wrapper
