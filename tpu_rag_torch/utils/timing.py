"""Lightweight per-stage latency instrumentation.

The reference has no tracing at all (SURVEY.md §5: "Tracing / profiling:
ABSENT").  This framework reports per-stage latencies in /search responses
and exposes them for the bench harness (`StageTimings`), and records the
training loop's spans (`SPANS`, off unless a caller enables it):

  train.sample     scripts/train_semantic.py's batch draw (step: the draw count)
  train.init       ContrastiveTrainer's constructor, with train.init.module
                   (the module built and moved to its device),
                   train.init.params (init_params loaded) and
                   train.init.optimizer (AdamW built)
  train.step       ContrastiveTrainer.train_step (step: the trainer's count),
                   with train.upload and train.readback (the loss to the
                   host), and between them, in an eager step, train.forward,
                   train.backward and train.optimizer, or in a step replayed
                   from a CUDA graph, train.replay (the graph's launch),
                   after train.capture in the step that captures it
  modernbert.attn_local, modernbert.attn_global
                   models/modernbert.py: each layer's banded (local) or
                   full (global) attention, where it runs eagerly (a graph
                   replay runs no Python; remat's recompute records again)

Counters go to utils/metrics.py's GLOBAL_METRICS:

  train_sample_real_tokens_total, train_sample_token_slots_total
                   the real tokens and the token slots of the batches drawn
  train_eager_steps_total     ContrastiveTrainer steps run eagerly
  train_graph_captures_total  CUDA graphs captured (one a step shape)
  train_graph_replays_total   steps replayed from a graph, the capturing one too
  attn_local_key_slots_total, attn_global_key_slots_total, attn_real_pairs_total
                   a ModernBERT step's query x key score slots on local and
                   global layers, as the attention on the trainer's device
                   scores them (on the card the forward kernel's visited
                   tiles), and the pairs among them inside the window and
                   between real tokens, added by ContrastiveTrainer from
                   the batch's host masks on every step, replayed ones too
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace
from typing import NamedTuple

import torch


class StageTimings:
    """Collects named stage durations (milliseconds)."""

    def __init__(self) -> None:
        self.stages: dict[str, float] = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (time.perf_counter() - t0) * 1000.0

    def as_dict(self) -> dict[str, float]:
        return {k: round(v, 3) for k, v in self.stages.items()}


class Span(NamedTuple):
    """One finished span: start and end on time.monotonic_ns(), the
    thread's native id, the enclosing span's id on that thread (None at the
    root) and the step it belongs to (inherited from the parent where the
    span names none)."""
    id: int
    parent: int | None
    name: str
    thread: int
    start_ns: int
    end_ns: int
    step: int | None


class _Open:
    """A span while it runs; pushed on its thread's stack on entry."""

    __slots__ = ("rec", "name", "step", "id", "parent", "start", "rf", "thread")

    def __init__(self, rec: "SpanRecorder", name: str, step: int | None) -> None:
        self.rec, self.name, self.step = rec, name, step

    def __enter__(self) -> "_Open":
        self.thread = th = self.rec._thread()
        self.parent = None
        if th.stack:
            parent = th.stack[-1]
            self.parent = parent.id
            if self.step is None:
                self.step = parent.step
        self.id = next(self.rec._ids)
        # under a running torch profiler the span is also a named range of
        # the trace (its kernels grouped under the same name)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        th.stack.append(self)
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.monotonic_ns()
        self.thread.stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._add((self.id, self.parent, self.name, self.thread.tid, self.start, end,
                       self.step))


class SpanRecorder:
    """Named host spans of the program's own work, kept in memory until
    drained.  Off by default: `span()` then hands back one shared no-op
    after a single flag check.  A span never synchronises the device or
    reads a device value; past `capacity` undrained spans, new ones are
    counted as dropped instead of kept."""

    def __init__(self, capacity: int = 1 << 16) -> None:
        self.capacity = capacity
        self.on = False
        self.dropped = 0
        self._spans: list[tuple] = []          # Span fields, made Spans on drain
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def span(self, name: str, step: int | None = None):
        if not self.on:
            return NOOP
        return _Open(self, name, step)

    def drain(self) -> tuple[list[Span], int]:
        """The finished spans since the last drain, and how many were dropped."""
        with self._lock:
            out, dropped = self._spans, self.dropped
            self._spans, self.dropped = [], 0
        return [Span._make(s) for s in out], dropped

    def _thread(self) -> SimpleNamespace:
        """This thread's stack of open spans and its native id."""
        try:
            return self._local.t
        except AttributeError:
            self._local.t = SimpleNamespace(stack=[], tid=threading.get_native_id())
            return self._local.t

    def _add(self, s: tuple) -> None:
        with self._lock:
            if len(self._spans) < self.capacity:
                self._spans.append(s)
            else:
                self.dropped += 1


NOOP = nullcontext()
SPANS = SpanRecorder()


def span(name: str, step: int | None = None):
    """A span of the process's recorder (SPANS): `with span("train.step",
    step=n): ...`."""
    return SPANS.span(name, step)
