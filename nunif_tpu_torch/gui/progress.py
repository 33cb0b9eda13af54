"""Progress event hub: worker threads -> GUI subscribers (counterpart of
``nunif_tpu/gui/progress.py``).

Role parity target: reference nunif/gui/common.py:16-38 — ``TQDMGUI``
subclasses tqdm and posts ``EVT_TQDM`` wx events to the main window.  Here
workers publish :class:`ProgressEvent` into a :class:`ProgressBridge`;
subscribers (the browser via SSE, or any callable) consume them without the
worker blocking.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Optional


@dataclasses.dataclass
class ProgressEvent:
    job_id: str
    step: int
    total: int           # 0 = unknown
    desc: str = ""
    done: bool = False
    error: Optional[str] = None
    ts: float = 0.0

    @property
    def fraction(self) -> float:
        return self.step / self.total if self.total else 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ProgressBridge:
    """Thread-safe fan-out of progress events.

    ``tqdm_class(job_id)`` returns a tqdm-compatible shim so pipeline code
    written against tqdm publishes through the bridge unchanged (the exact
    trick the reference plays with TQDMGUI).
    """

    def __init__(self, history: int = 1):
        self._lock = threading.Lock()
        self._subscribers: list[queue.SimpleQueue] = []
        self._callbacks: list[Callable[[ProgressEvent], None]] = []
        self._latest: dict[str, ProgressEvent] = {}

    def publish(self, event: ProgressEvent):
        event.ts = time.time()
        with self._lock:
            self._latest[event.job_id] = event
            subs = list(self._subscribers)
            cbs = list(self._callbacks)
        for q in subs:
            q.put(event)
        for cb in cbs:
            cb(event)

    def update(self, job_id: str, step: int, total: int, desc: str = ""):
        self.publish(ProgressEvent(job_id, step, total, desc))

    def finish(self, job_id: str, error: Optional[str] = None):
        last = self._latest.get(job_id)
        total = last.total if last else 0
        self.publish(ProgressEvent(job_id, total, total, done=True,
                                   error=error))

    def latest(self, job_id: str) -> Optional[ProgressEvent]:
        with self._lock:
            return self._latest.get(job_id)

    def subscribe_callback(self, cb: Callable[[ProgressEvent], None]):
        with self._lock:
            self._callbacks.append(cb)

    def subscribe(self) -> "queue.SimpleQueue[ProgressEvent]":
        q: queue.SimpleQueue = queue.SimpleQueue()
        with self._lock:
            self._subscribers.append(q)
        return q

    def unsubscribe(self, q):
        with self._lock:
            if q in self._subscribers:
                self._subscribers.remove(q)

    def tqdm_class(self, job_id: str):
        """A tqdm-compatible progress class bound to this bridge."""
        bridge = self

        class _BridgeTqdm:
            def __init__(self, iterable=None, total=None, desc="", **kw):
                self.iterable = iterable
                self.total = total if total is not None else (
                    len(iterable) if hasattr(iterable, "__len__") else 0)
                self.desc = desc
                self.n = 0
                bridge.update(job_id, 0, self.total, desc)

            def __iter__(self):
                for x in self.iterable:
                    yield x
                    self.update(1)
                self.close()

            def update(self, n=1):
                self.n += n
                bridge.update(job_id, self.n, self.total, self.desc)

            def set_description(self, desc):
                self.desc = desc

            def close(self):
                bridge.finish(job_id)

            def __enter__(self):
                return self

            def __exit__(self, *a):
                self.close()
                return False

        return _BridgeTqdm
