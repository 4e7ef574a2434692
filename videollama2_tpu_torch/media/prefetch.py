"""Host-side media prefetching: overlap CPU video decode with TPU compute.

The reference hides decode latency behind torch DataLoader worker processes
(train.py num_workers, eval DataLoader num_workers=8). Equivalent here: a
bounded background prefetcher that decodes/preprocesses the next items while
the chip runs the current one — on the single-chip serving path this removes
decord-replacement decode from the critical path entirely (SURVEY.md §3.1
notes CPU decode is often wall-clock dominant).
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


class Prefetcher:
    """Maps `fn` over `items` in `num_workers` threads, yielding results in
    order with at most `buffer_size` items decoded ahead."""

    def __init__(self, items: Iterable[T], fn: Callable[[T], U],
                 buffer_size: int = 4, num_workers: int = 2):
        self.items = list(items)
        self.fn = fn
        self.buffer_size = buffer_size
        self.num_workers = max(1, num_workers)
        self._results: dict = {}
        self._done = threading.Event()
        self._cv = threading.Condition()
        self._next_to_schedule = 0
        self._next_to_yield = 0

    def __iter__(self) -> Iterator[U]:
        workers = [threading.Thread(target=self._worker, daemon=True)
                   for _ in range(self.num_workers)]
        for w in workers:
            w.start()
        try:
            for i in range(len(self.items)):
                with self._cv:
                    while i not in self._results:
                        self._cv.wait(timeout=0.1)
                    result = self._results.pop(i)
                    self._next_to_yield = i + 1
                    self._cv.notify_all()
                if isinstance(result, _Error):
                    raise result.exc
                yield result
        finally:
            self._done.set()

    def _worker(self):
        while not self._done.is_set():
            with self._cv:
                # backpressure: stay within buffer_size of the consumer
                while (self._next_to_schedule - self._next_to_yield
                       >= self.buffer_size and not self._done.is_set()):
                    self._cv.wait(timeout=0.1)
                if self._next_to_schedule >= len(self.items):
                    return
                idx = self._next_to_schedule
                self._next_to_schedule += 1
            try:
                result = self.fn(self.items[idx])
            except Exception as e:  # surfaced on the consumer side
                result = _Error(e)
            with self._cv:
                self._results[idx] = result
                self._cv.notify_all()


class _Error:
    def __init__(self, exc: Exception):
        self.exc = exc


def prefetch_map(items: Iterable[T], fn: Callable[[T], U],
                 buffer_size: int = 4, num_workers: int = 2) -> Iterator[U]:
    return iter(Prefetcher(items, fn, buffer_size, num_workers))
