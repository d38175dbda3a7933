"""The engine clock and the time units of window specs (counterpart of
ekuiper_tpu/utils/timex.py).

One process-global Clock gives the engine's processing time and arms the
timers that drive window boundaries. The real clock is the wall clock and
fires each timer on a thread of its own. The mock clock only moves through
`set()` / `advance()`: timers whose deadline the move crosses fire
synchronously inside it, in deadline order, so a test or a benchmark can
feed batches, call `advance(10_000)` and see the tumbling window fire with
no real waiting.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Callable, Optional

MS = 1
SECOND = 1000
MINUTE = 60 * SECOND
HOUR = 60 * MINUTE
DAY = 24 * HOUR

_UNIT_MS = {"ms": MS, "ss": SECOND, "mi": MINUTE, "hh": HOUR, "dd": DAY}


def unit_to_ms(unit: str) -> int:
    """Window-size unit (as in TUMBLINGWINDOW(ss, 10)) to milliseconds."""
    try:
        return _UNIT_MS[unit.lower()]
    except KeyError:
        raise ValueError(f"unknown time unit {unit!r} (want dd/hh/mi/ss/ms)")


class Timer:
    """One-shot timer handle; `stop()` keeps it from firing."""

    def __init__(self) -> None:
        self.fired_at: Optional[int] = None
        self.stopped = False

    def _fire(self, now_ms: int) -> None:
        self.fired_at = now_ms

    def stop(self) -> None:
        self.stopped = True

    @property
    def fired(self) -> bool:
        return self.fired_at is not None


class Clock:
    """Interface. now_ms() is the engine-wide notion of processing time."""

    def now_ms(self) -> int:
        raise NotImplementedError

    def after(self, ms: int,
              callback: Optional[Callable[[int], None]] = None) -> Timer:
        raise NotImplementedError


class RealClock(Clock):
    def now_ms(self) -> int:
        return int(time.time() * 1000)

    def after(self, ms: int,
              callback: Optional[Callable[[int], None]] = None) -> Timer:
        timer = Timer()

        def run() -> None:
            time.sleep(ms / 1000.0)
            if not timer.stopped:
                now = self.now_ms()
                timer._fire(now)
                if callback is not None:
                    callback(now)

        threading.Thread(target=run, daemon=True).start()
        return timer


class MockClock(Clock):
    """Deterministic clock. Time only moves via set()/advance().

    Timers registered with `after()` fire synchronously inside the advancing
    thread, in deadline order; a callback that arms a new timer due within
    the same move sees it fire in that move too. A callback runs without
    the clock's lock held, so it may take its node's lock, and a node may
    read the clock or arm a timer while holding its own lock, with no
    order between the two locks to keep.
    """

    def __init__(self, start_ms: int = 0) -> None:
        self._now = start_ms
        self._lock = threading.Lock()
        self._counter = itertools.count()
        # heap of (deadline, seq, timer, callback)
        self._timers: list = []

    def now_ms(self) -> int:
        with self._lock:
            return self._now

    def set(self, ms: int) -> None:
        with self._lock:
            if ms < self._now:
                raise ValueError(
                    f"mock clock cannot go backwards ({ms} < {self._now})")
        self._fire_until(ms)

    def advance(self, ms: int) -> None:
        with self._lock:
            target = self._now + ms
        self._fire_until(target)

    def _fire_until(self, target_ms: int) -> None:
        # time moves to each deadline before its callback runs, so the
        # callback reads its own firing time from now_ms()
        while True:
            with self._lock:
                if not self._timers or self._timers[0][0] > target_ms:
                    self._now = max(self._now, target_ms)
                    return
                deadline, _, timer, callback = heapq.heappop(self._timers)
                if timer.stopped:
                    continue
                self._now = max(self._now, deadline)
            timer._fire(deadline)
            if callback is not None:
                callback(deadline)

    def after(self, ms: int,
              callback: Optional[Callable[[int], None]] = None) -> Timer:
        timer = Timer()
        with self._lock:
            heapq.heappush(self._timers, (self._now + ms,
                                          next(self._counter), timer,
                                          callback))
        return timer


_clock: Clock = RealClock()
_lock = threading.Lock()


def now_ms() -> int:
    return _clock.now_ms()


def after(ms: int, callback: Optional[Callable[[int], None]] = None) -> Timer:
    return _clock.after(ms, callback)


def set_mock_clock(start_ms: int = 0) -> MockClock:
    """Install (and return) a fresh mock clock."""
    global _clock
    with _lock:
        mock = MockClock(start_ms)
        _clock = mock
        return mock


def get_mock_clock() -> MockClock:
    if not isinstance(_clock, MockClock):
        raise RuntimeError(
            "mock clock not installed; call set_mock_clock() first")
    return _clock


def use_real_clock() -> None:
    global _clock
    with _lock:
        _clock = RealClock()


def align_to_window(now: int, interval_ms: int) -> int:
    """Next boundary of a tumbling/hopping interval at or after `now`:
    boundaries align to the epoch, so a 10 s tumbling window fires at
    :00, :10, :20 ..."""
    if interval_ms <= 0:
        raise ValueError("interval must be positive")
    rem = now % interval_ms
    return now if rem == 0 else now + (interval_ms - rem)
