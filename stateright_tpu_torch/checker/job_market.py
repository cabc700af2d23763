"""Work-sharing market for host checker threads (ref: src/job_market.rs).

The reference coordinates checker threads through a mutex-protected job market:
`pop` blocks until work arrives or every thread goes idle with no jobs left
(global quiescence closes the market); `split_and_push` rebalances a busy
thread's local queue to idle peers; and any thread exiting — normal early
finish or panic — closes the market on the way out (the reference does this in
`Drop`, ref: src/job_market.rs:29-41), which is how "one thread found all
discoveries" propagates to the others.

The host checkers keep this protocol for semantics parity (Python threads share
the GIL, so it is scheduler logic, not CPU scaling — the device engines of
tensor/ replace it with batched steps on the card).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Generic, Optional, TypeVar

Job = TypeVar("Job")


class _Market(Generic[Job]):
    """Shared state (ref: src/job_market.rs:43-52)."""

    def __init__(self, thread_count: int, close_at: Optional[float]):
        self.cond = threading.Condition()
        self.open = True
        self.thread_count = thread_count
        self.open_count = thread_count  # threads currently working
        self.job_batches: list[Deque[Job]] = []
        self.close_at = close_at  # monotonic deadline, None = no timeout
        self.panic: Optional[BaseException] = None


class JobBroker(Generic[Job]):
    """Per-thread handle to the market (ref: src/job_market.rs:13-41)."""

    def __init__(self, market: _Market[Job]):
        self.market = market

    @staticmethod
    def new(thread_count: int, close_at: Optional[float]) -> "JobBroker[Job]":
        return JobBroker(_Market(thread_count, close_at))

    def push(self, jobs: Deque[Job]) -> None:
        """Publish a batch (ref: src/job_market.rs:133-145)."""
        m = self.market
        with m.cond:
            if not m.open or not jobs:
                return
            m.job_batches.append(jobs)
            m.cond.notify()

    def pop(self) -> Deque[Job]:
        """Blocks until jobs are available or the market closes; an empty deque
        means "shut down" (ref: src/job_market.rs:95-130)."""
        m = self.market
        with m.cond:
            while True:
                if m.close_at is not None and time.monotonic() >= m.close_at:
                    m.open = False
                    m.job_batches.clear()
                    m.cond.notify_all()
                if not m.open and not m.job_batches:
                    m.open_count = max(0, m.open_count - 1)
                    m.cond.notify_all()
                    return deque()
                if m.job_batches:
                    return m.job_batches.pop()
                m.open_count -= 1
                if m.open_count == 0:
                    # Last running thread and no jobs: global quiescence.
                    m.open = False
                    m.cond.notify_all()
                    return deque()
                timeout = 0.5
                if m.close_at is not None:
                    timeout = min(timeout, max(0.0, m.close_at - time.monotonic()))
                m.cond.wait(timeout=timeout)
                m.open_count += 1

    def split_and_push(self, jobs: Deque[Job]) -> None:
        """Splits the local queue into one piece per idle thread and publishes
        them; on a closed market the local queue is discarded so the caller
        stops promptly (ref: src/job_market.rs:149-176)."""
        m = self.market
        with m.cond:
            if not m.open:
                jobs.clear()
                return
            pieces = 1 + min(max(0, m.thread_count - m.open_count), len(jobs))
            size = len(jobs) // pieces
            for _ in range(pieces - 1):
                if size == 0:
                    break
                piece: Deque[Job] = deque()
                for _ in range(size):
                    piece.append(jobs.pop())
                m.job_batches.append(piece)
                m.cond.notify()

    def thread_exited(self, panic: Optional[BaseException] = None) -> None:
        """A checker thread is exiting: close the market and wake everyone,
        mirroring the reference's Drop impl (ref: src/job_market.rs:29-41)."""
        m = self.market
        with m.cond:
            m.open = False
            m.job_batches.clear()
            m.open_count = max(0, m.open_count - 1)
            if panic is not None and m.panic is None:
                m.panic = panic
            m.cond.notify_all()

    def deadline_passed(self) -> bool:
        """Whether the timeout deadline has passed; closes the market if so.
        Workers poll this between blocks — the reference instead runs a
        dedicated timeout thread that closes the market
        (ref: src/job_market.rs:69-86)."""
        m = self.market
        if m.close_at is None:
            return False
        if time.monotonic() < m.close_at:
            return False
        with m.cond:
            m.open = False
            m.job_batches.clear()
            m.cond.notify_all()
        return True

    def is_closed(self) -> bool:
        """ref: src/job_market.rs:179-183"""
        m = self.market
        with m.cond:
            return not m.open and not m.job_batches and m.open_count == 0
