"""Live streaming front-end: bounded latest-wins queueing.

The port's copy of ``loam_velodyne_tpu/io/live.py``.

The reference couples its pipeline to the sensor through ROS topic
queues of depth 2 (ScanRegistration.cpp:149-157, LaserOdometry.cpp:
147-163) polled at 100 Hz: when a stage falls behind, stale sweeps are
dropped and the newest wins. This module reproduces those semantics for
a live sensor feed: a producer thread (sensor driver callback) pushes
sweeps into a bounded deque; the consumer loop drains the NEWEST sweep
into the engine and counts what was shed.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Optional, Tuple

import numpy as np


class LiveFeeder:
    """Latest-wins bounded queue between a sensor thread and the engine.

    driver: any object with ``process_sweep(pts, stamp)`` (LoamDriver).
    """

    def __init__(self, driver, queue_depth: int = 2):
        self.driver = driver
        self.queue_depth = queue_depth
        self._buf: collections.deque = collections.deque(maxlen=queue_depth)
        self._lock = threading.Lock()
        self._new_data = threading.Event()
        self._stop = threading.Event()
        self.n_pushed = 0
        self.n_processed = 0
        self.n_dropped = 0

    # ------------------------------------------------------------------
    # producer side (sensor callback thread)
    # ------------------------------------------------------------------
    def push(self, pts: np.ndarray, stamp: Optional[float] = None) -> None:
        with self._lock:
            if len(self._buf) == self._buf.maxlen:
                self._buf.popleft()           # shed the stalest sweep
                self.n_dropped += 1
            self._buf.append((pts, stamp))
            self.n_pushed += 1
        self._new_data.set()

    # ------------------------------------------------------------------
    # consumer side (engine loop)
    # ------------------------------------------------------------------
    def _pop(self) -> Optional[Tuple[np.ndarray, Optional[float]]]:
        with self._lock:
            if not self._buf:
                self._new_data.clear()
                return None
            return self._buf.popleft()

    def spin_once(self) -> bool:
        """Process at most one queued sweep; returns True if one ran."""
        item = self._pop()
        if item is None:
            return False
        pts, stamp = item
        self.driver.process_sweep(pts, stamp)
        self.n_processed += 1
        return True

    def spin(self, timeout: Optional[float] = None) -> None:
        """Consume until stop() (or timeout); blocks on the event rather
        than the reference's 100 Hz poll."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop.is_set():
            if not self.spin_once():
                remaining = 0.05
                if deadline is not None:
                    remaining = min(remaining, deadline - time.monotonic())
                    if remaining <= 0:
                        return
                self._new_data.wait(remaining)

    def stop(self) -> None:
        self._stop.set()
        self._new_data.set()

    @property
    def stats(self) -> dict:
        return {"pushed": self.n_pushed, "processed": self.n_processed,
                "dropped": self.n_dropped, "queued": len(self._buf)}
