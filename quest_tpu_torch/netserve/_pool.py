"""A fixed-size worker pool over a ``queue.SimpleQueue``.

Deliberately NOT ``concurrent.futures.ThreadPoolExecutor`` (and on the
server side, deliberately NOT asyncio's default executor, which IS
one): the executor's internal locks — shutdown lock, idle semaphore,
worker-thread start events, and the module-global shutdown lock — all
alias to single creation sites under the repo's runtime lock-order
validator (``quest_tpu_torch/testing/lockcheck.py`` attributes a lock to
the first quest_tpu_torch frame that created it). ``submit()`` holds the
shutdown lock while acquiring the module-global lock and the new
worker's start event, so two executors created from DIFFERENT
quest_tpu_torch sites (e.g. the netserve event loop's and one a checkpoint
library created) read as a site-level lock-order inversion the first
time both are live in one process. This pool never holds one lock
while acquiring another — ``SimpleQueue`` is C-implemented and the
``Future`` handoff is lock-at-a-time — so its order graph is empty by
construction.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future

__all__ = ["WorkerPool"]


class WorkerPool:
    """``submit(fn, *args) -> Future`` over ``max_workers`` daemon
    threads. No work queue bound, no idle reaping — workers live for
    the pool's lifetime and exit on :meth:`shutdown`."""

    def __init__(self, max_workers: int, name: str):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._threads = []
        for i in range(max_workers):
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"{name}-{i}")
            t.start()
            self._threads.append(t)

    def submit(self, fn, *args) -> Future:
        fut: Future = Future()
        self._q.put((fut, fn, args))
        return fut

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn, args = item
            if not fut.set_running_or_notify_cancel():
                continue
            try:
                fut.set_result(fn(*args))
            # quest: allow-broad-except(the exception belongs to the
            # Future's waiter, not this worker)
            except BaseException as exc:
                fut.set_exception(exc)

    def shutdown(self, wait: bool = True) -> None:
        for _ in self._threads:
            self._q.put(None)
        if wait:
            for t in self._threads:
                t.join()
