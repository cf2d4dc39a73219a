"""Cross-request micro-batching (leader/follower, zero added idle latency).

The TPU search path is a single device program whose cost is almost flat in
the query-batch dimension (the DB scan dominates), so concurrent single-query
requests waste 10-100x throughput if dispatched one by one.  This batcher
aggregates them: requests enqueue; a worker takes whatever has accumulated
(never waiting on a timer — the previous device call IS the batching window)
and runs one fused embed+search for the whole set.

An idle server pays nothing: the first request is picked up immediately and
runs alone.  Under concurrency, arrivals during an in-flight device call form
the next batch.  (The reference stack had no equivalent; each request paid a
full encoder forward + ANN query — api/app.py:539-566.)

Adaptive hold (round-4, VERDICT r3 #6): pure drain-what-accumulated still
dispatched 88 size-1 windows at concurrency 256 (BENCH_r03 window_hist) — a
just-freed worker grabs a lone early arrival instead of letting stragglers
join.  The fix keeps the zero-idle-latency invariant with double-buffered
collection: while another worker has a window IN FLIGHT (the single chip is
busy anyway — dispatching early would only queue), a worker keeps its
sub-full batch open and accumulates arrivals, dispatching the moment the
device frees, the batch fills, or the hold_ms safety cap expires.  An idle
server (no window in flight) still dispatches immediately.

With workers > 1, that many windows are in flight at once: while one worker
blocks on its device readback (a full RTT on tunneled backends), another
tokenizes and dispatches the next window, so the device never idles between
windows.  Window sizes are recorded as a power-of-two histogram in
GLOBAL_METRICS ({name}_window_le_{2^k}_total) — the serving bench reads it
to prove the batching actually fills under load.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable

from tpu_rag_torch.utils.metrics import GLOBAL_METRICS


class MicroBatcher:
    """run_batch: list[item] -> list[result] (len-matched).  submit() blocks
    until the batch containing its item completes; exceptions propagate to
    every caller in the failed batch."""

    def __init__(self, run_batch: Callable[[list], list], *,
                 max_batch: int = 64, name: str = "microbatch",
                 workers: int = 1, hold_ms: float = 0.0) -> None:
        self._run = run_batch
        self.max_batch = max(1, int(max_batch))
        self.name = name
        self.workers = max(1, int(workers))
        self.hold_s = max(0.0, float(hold_ms)) / 1e3
        self._q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._start_lock = threading.Lock()
        # number of workers currently inside run_batch — the "is a window in
        # flight" signal the adaptive hold keys on (plain int mutations are
        # fine: both sites hold _inflight_lock)
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    def _ensure_worker(self) -> None:
        alive = [t for t in self._threads if t.is_alive()]
        if len(alive) >= self.workers:
            return
        with self._start_lock:
            self._threads = [t for t in self._threads if t.is_alive()]
            while len(self._threads) < self.workers:
                t = threading.Thread(
                    target=self._loop, daemon=True,
                    name=f"{self.name}-{len(self._threads)}")
                t.start()
                self._threads.append(t)

    def submit(self, item: Any, timeout: float | None = 120.0) -> Any:
        cell: dict[str, Any] = {"ev": threading.Event()}
        self._ensure_worker()
        self._q.put((item, cell))
        if not cell["ev"].wait(timeout):
            raise TimeoutError(f"{self.name}: batch did not complete in {timeout}s")
        if "error" in cell:
            raise cell["error"]
        return cell["result"]

    def stop(self) -> None:
        """Terminate the worker threads.  Without this, each daemon worker
        keeps the bound run_batch method — and through it the engine and its
        device arrays — alive forever, so embedding processes (bench, tests)
        could never release HBM by dropping the engine."""
        with self._start_lock:
            threads, self._threads = self._threads, []
            self.workers = 0  # _ensure_worker becomes a no-op
        for _ in threads:
            self._q.put((None, None))  # sentinel per worker
        for t in threads:
            t.join(timeout=5.0)

    def _drain(self, batch: list) -> bool:
        """Move every queued item into batch (up to max_batch).  Returns
        False if a stop sentinel was seen (left queued for a worker exit)."""
        while len(batch) < self.max_batch:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return True
            if item == (None, None):
                self._q.put(item)  # keep the sentinel for a worker exit
                return False
            batch.append(item)
        return True

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first == (None, None):  # stop() sentinel
                return
            batch = [first]
            keep_going = self._drain(batch)
            # adaptive hold (double-buffered collection): while another
            # worker's window is IN FLIGHT the device is busy anyway, so
            # dispatching a small batch now would only queue it — keep
            # accumulating instead, and dispatch the moment the device
            # frees (or the safety cap expires, or the batch fills).  An
            # idle server (no window in flight) never holds.  Measured on
            # v5e at concurrency 256: a fixed 2 ms hold still left 80
            # size-1 windows because device windows run ~120 ms — the
            # hold must track the in-flight window, not a constant.
            if keep_going and self.hold_s > 0 and len(batch) < self.max_batch:
                held = False
                deadline = time.monotonic() + self.hold_s
                while (len(batch) < self.max_batch
                       and time.monotonic() < deadline):
                    with self._inflight_lock:
                        busy = self._inflight > 0
                    if not busy:
                        break  # device is free: dispatch now, never idle it
                    held = True
                    try:
                        item = self._q.get(timeout=0.002)
                    except queue.Empty:
                        continue
                    if item == (None, None):
                        self._q.put(item)
                        break
                    batch.append(item)
                    if not self._drain(batch):
                        break  # sentinel seen: stop holding, dispatch now
                if held:
                    GLOBAL_METRICS.inc(f"{self.name}_held_total")
            GLOBAL_METRICS.inc(f"{self.name}_batches_total")
            GLOBAL_METRICS.inc(f"{self.name}_items_total", len(batch))
            # window-fill histogram (power-of-two buckets): le_1, le_2, ...
            bucket = 1
            while bucket < len(batch):
                bucket *= 2
            GLOBAL_METRICS.inc(f"{self.name}_window_le_{bucket}_total")
            with self._inflight_lock:
                self._inflight += 1
            try:
                results = self._run([item for item, _ in batch])
                if len(results) != len(batch):
                    raise RuntimeError(
                        f"{self.name}: run_batch returned {len(results)} results "
                        f"for {len(batch)} items")
                for (_, cell), result in zip(batch, results):
                    cell["result"] = result
                    cell["ev"].set()
            except Exception as e:  # propagate to every waiter in the batch
                for _, cell in batch:
                    cell["error"] = e
                    cell["ev"].set()
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
