"""Where a training step's time goes, read from the program's own spans
(tpu_rag_torch/utils/timing.py) on the device trace's clock.

  python3 train_trace.py [--seed N] [--cost-seconds 20] [--slice-seconds 3] \
      [--out PATH]

On one CUDA card, at the settings of perfbench's `minilm-l6-1m.train` cell
(its corpus from the seed, train_semantic's batch sampler, the
ContrastiveTrainer with the seeded weights):

1. set-up with the span recorder on, so `train.init` and its children are
   caught;
2. the recorder's cost: the sampler-and-step loop for --cost-seconds each
   with the recorder on, off, off, on, on, off (so that a drift along the
   six loops reads the same on both sides), no profiler running
   (tokens/s), and one empty span's own cost, off and on (us);
3. a traced slice of --slice-seconds with the recorder on, under the
   benchmark's CUDA-only profiler (perfbench/trace.py), bounded by two
   marker kernels (`torch.cuda._sleep`) whose launches are stamped on
   time.monotonic_ns() just before and just after.

The chrome trace's launch records (`cuda_runtime` / `cuda_driver` events:
thread, time, correlation id) tie each device op to the host moment it was
launched.  The first marker's launch record fixes the offset between the
host's clock and the trace's; the second gives the residual.  Each op is
then under the spans whose interval holds its launch, on any thread (the
backward's kernels are launched by autograd's thread while the trainer's
thread waits inside `train.backward`).  `read()` gives the per-layer
numbers (the names a benchmark metric would take):

  sample_ms.train      median train.sample duration
  sample_idle.train    % of the slice with no device op and train.sample open
  launch_idle.train    % with no device op, inside train.step, outside train.readback
  readback_ms.train    median train.readback duration: the host's wait for the device
  forward_ms.train     median over whole steps of the device busy time (union of
  backward_ms.train    intervals) of the ops launched under the step's
  optimizer_ms.train   train.forward / train.backward / train.optimizer
  pad_share.train      100 x (1 - real tokens / token slots) of the batches drawn
  trainer_init_s.train the train.init span

and the checks beside them: the share of busy time launched under no span,
the idle under no span and under train.readback, each part's host time, the
longest idle gaps named by the innermost span at their middle, start and
end.  Where the trace holds no launch records the numbers that need them
are None.  The last line of standard output is one JSON object, which
--out also gets.  Without a card the script exits 2.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import statistics
import sys
import tempfile
import time
from dataclasses import dataclass, field
from functools import cached_property
from pathlib import Path

from perfbench.trace import DEVICE_CATS, MARKER, gaps, union_s

ROOT = Path(__file__).resolve().parent
CELL = "minilm-l6-1m.train"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
COUNTERS = ("train_sample_real_tokens_total", "train_sample_token_slots_total")


# ---- intervals (seconds)

def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def overlap(a, b) -> float:
    """Length of the intersection of the unions of a and b."""
    a, b = merged(a), merged(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


# ---- the trace joined with the spans

@dataclass
class Op:
    name: str
    start: float            # on the trace's clock (s), unclipped
    end: float
    launch: float | None    # the launch record's start, or None where it has none


@dataclass
class HostSpan:
    id: int
    parent: int | None
    name: str
    thread: int
    start: float            # mapped onto the trace's clock (s)
    end: float
    step: int | None


@dataclass
class Joined:
    lo: float                               # the slice: first marker's end ...
    hi: float                               # ... to the second marker's start
    ops: list[Op] = field(default_factory=list)        # non-marker ops overlapping it
    spans: list[HostSpan] = field(default_factory=list)
    residual_s: float | None = None         # the clock map at the second marker
    slack_s: float | None = None            # the first marker's stamps around its launch
    partial: list[str] = field(default_factory=list)   # why the launch-based numbers are None

    def clipped(self, ops=None) -> list[tuple[float, float]]:
        return [(max(o.start, self.lo), min(o.end, self.hi))
                for o in (self.ops if ops is None else ops)]

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_s(self.clipped())

    @cached_property
    def by_launch(self) -> tuple[list[float], list[Op]]:
        """The ops that have a launch record, in launch order, and their
        launch times."""
        ops = sorted((o for o in self.ops if o.launch is not None), key=lambda o: o.launch)
        return [o.launch for o in ops], ops


def join(events: list[dict], spans, stamps: list[tuple[int, int]]) -> Joined:
    """A chrome trace's device ops between two marker kernels, each with
    its launch record's time, and the program's spans (timing.Span, on
    time.monotonic_ns()) mapped onto the trace's clock.  `stamps` holds the
    host's (before, after) time.monotonic_ns() around each marker's launch.
    The trace's `ts` and `dur` are microseconds; times here are seconds
    from the first marker's launch."""
    marks = sorted((e for e in events if e.get("cat") == "kernel"
                    and MARKER in e.get("name", "")), key=lambda e: e["ts"])
    if len(marks) < 2:
        raise RuntimeError(f"the trace holds {len(marks)} marker kernels, not 2")
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    m_launch = [launches.get(m.get("args", {}).get("correlation")) for m in marks[:1] + marks[-1:]]
    base = m_launch[0]["ts"] if m_launch[0] is not None else marks[0]["ts"]

    def sec(ts: float) -> float:
        return (ts - base) * 1e-6

    tr = Joined(lo=sec(marks[0]["ts"] + marks[0]["dur"]), hi=sec(marks[-1]["ts"]))
    if not launches:
        tr.partial.append("the trace holds no launch records")
    elif None in m_launch or len(stamps) < 2:
        tr.partial.append("a marker's launch record or stamp is missing")
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS or "dur" not in e \
                or MARKER in e.get("name", ""):
            continue
        s, t = sec(e["ts"]), sec(e["ts"] + e["dur"])
        if t > tr.lo and s < tr.hi:
            rec = launches.get(e.get("args", {}).get("correlation"))
            tr.ops.append(Op(e.get("name", "?"), s, t,
                             sec(rec["ts"]) if rec is not None else None))
    if tr.partial:
        return tr
    # host ns -> trace s: the launch record's midpoint at the stamps' midpoint
    mid = [sec(r["ts"] + r.get("dur", 0.0) / 2) for r in m_launch]
    host = [(a + b) / 2 * 1e-9 for a, b in stamps[:1] + stamps[-1:]]
    offset = mid[0] - host[0]
    tr.residual_s = mid[1] - (host[1] + offset)
    tr.slack_s = (stamps[0][1] - stamps[0][0]) * 1e-9 - m_launch[0].get("dur", 0.0) * 1e-6
    tr.spans = [HostSpan(s.id, s.parent, s.name, s.thread, s.start_ns * 1e-9 + offset,
                         s.end_ns * 1e-9 + offset, s.step) for s in spans]
    return tr


def launched_under(tr: Joined, sp: HostSpan) -> list[Op]:
    """The ops whose launch lies inside the span's interval (any thread)."""
    keys, ops = tr.by_launch
    return ops[bisect.bisect_left(keys, sp.start):bisect.bisect_right(keys, sp.end)]


def innermost(tr: Joined, t: float) -> str:
    best = None
    for sp in tr.spans:
        if sp.start <= t <= sp.end and (best is None or sp.end - sp.start < best.end - best.start):
            best = sp
    return best.name if best is not None else "no program span"


def whole_steps(tr: Joined) -> list[HostSpan]:
    """train.step spans that, with every op launched under them, lie
    wholly inside the slice."""
    out = []
    for sp in tr.spans:
        if sp.name != "train.step" or sp.start < tr.lo or sp.end > tr.hi:
            continue
        if all(tr.lo <= o.start and o.end <= tr.hi for o in launched_under(tr, sp)):
            out.append(sp)
    return out


def _median(values) -> float | None:
    values = list(values)
    return statistics.median(values) if values else None


def read(tr: Joined, counters: dict[str, float] | None = None,
         init_spans=()) -> dict:
    """The per-layer numbers of the module docstring, with the checks
    beside them.  `counters` are the two sampler counters' deltas over the
    slice; `init_spans` the set-up's timing.Span records."""
    out: dict = {"window_s": tr.window_s, "busy_s": tr.busy_s,
                 "device_idle_pct": 100.0 * (1.0 - tr.busy_s / tr.window_s),
                 "clock_residual_us": None if tr.residual_s is None else tr.residual_s * 1e6,
                 "clock_slack_us": None if tr.slack_s is None else tr.slack_s * 1e6,
                 "partial": tr.partial}
    init = {s.name: (s.end_ns - s.start_ns) * 1e-9 for s in init_spans
            if s.name.startswith("train.init")}
    out["trainer_init_s.train"] = init.get("train.init")
    out["init_children_s"] = {k: v for k, v in init.items() if k != "train.init"}
    real, slots = (counters or {}).get(COUNTERS[0], 0.0), (counters or {}).get(COUNTERS[1], 0.0)
    out["pad_share.train"] = 100.0 * (1.0 - real / slots) if slots > 0 else None
    names = ("sample_ms.train", "sample_idle.train", "launch_idle.train", "readback_ms.train",
             "forward_ms.train", "backward_ms.train", "optimizer_ms.train")
    if tr.partial or not tr.spans:
        out.update({n: None for n in names})
        return out

    inside = [sp for sp in tr.spans if tr.lo <= sp.start and sp.end <= tr.hi]
    out["sample_ms.train"] = _median((sp.end - sp.start) * 1e3 for sp in inside
                                     if sp.name == "train.sample")
    steps = whole_steps(tr)
    kids: dict[int, dict[str, HostSpan]] = {sp.id: {} for sp in steps}
    for sp in tr.spans:
        if sp.parent in kids:
            kids[sp.parent][sp.name] = sp
    out["steps"] = len(steps)
    # each part's host time, the median over the whole steps
    out["host_ms"] = {name: _median((k[name].end - k[name].start) * 1e3
                                    for k in kids.values() if name in k)
                      for name in ("train.upload", "train.forward", "train.backward",
                                   "train.optimizer", "train.readback")}
    out["host_ms"]["train.step"] = _median((sp.end - sp.start) * 1e3 for sp in steps)
    out["readback_ms.train"] = out["host_ms"]["train.readback"]
    for part in ("forward", "backward", "optimizer"):
        out[f"{part}_ms.train"] = _median(
            union_s((o.start, o.end) for o in launched_under(tr, k[f"train.{part}"])) * 1e3
            for k in kids.values() if f"train.{part}" in k)

    idle = gaps(tr.clipped(), tr.lo, tr.hi)

    def idle_pct(sps) -> float:
        return 100.0 * overlap(idle, [(sp.start, sp.end) for sp in sps]) / tr.window_s

    by = {n: [sp for sp in tr.spans if sp.name == n]
          for n in ("train.sample", "train.step", "train.readback")}
    out["sample_idle.train"] = idle_pct(by["train.sample"])
    out["readback_idle_pct"] = idle_pct(by["train.readback"])
    out["launch_idle.train"] = idle_pct(by["train.step"]) - out["readback_idle_pct"]
    out["no_span_idle_pct"] = out["device_idle_pct"] - idle_pct(tr.spans)
    out["other_span_idle_pct"] = idle_pct(tr.spans) - idle_pct(by["train.sample"]) \
        - idle_pct(by["train.step"])

    covered = merged((sp.start, sp.end) for sp in tr.spans)
    starts = [s for s, _ in covered]

    def under_a_span(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= covered[i][1]

    unspanned = [o for o in tr.by_launch[1] if not under_a_span(o.launch)]
    unlaunched = [o for o in tr.ops if o.launch is None]
    busy = tr.busy_s
    out["no_span_busy_pct"] = 100.0 * union_s(tr.clipped(unspanned)) / busy if busy else None
    out["no_launch_record_busy_pct"] = \
        100.0 * union_s(tr.clipped(unlaunched)) / busy if busy else None
    longest = sorted(idle, key=lambda g: g[0] - g[1])[:10]
    out["idle_gaps"] = [[innermost(tr, (s + e) / 2), e - s, innermost(tr, s), innermost(tr, e)]
                        for s, e in longest]
    return out


def categories(events: list[dict]) -> dict[str, int]:
    """Event count by category, and launch records by thread."""
    cats: dict[str, int] = {}
    for e in events:
        key = e.get("cat", e.get("ph", "?"))
        cats[key] = cats.get(key, 0) + 1
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            key = f"launch records of thread {e.get('tid')}"
            cats[key] = cats.get(key, 0) + 1
    return cats


# ---- the run on the card

def _loop(sampler, trainer, seconds: float) -> tuple[float, int]:
    """tokens/s and steps of the sampler-and-step loop for `seconds`."""
    import torch

    tokens, steps, t0 = 0, 0, time.monotonic()
    while time.monotonic() - t0 < seconds:
        batch = sampler()
        trainer.train_step(batch)
        tokens += int(batch["q_mask"].sum()) + int(batch["d_mask"].sum())
        steps += 1
    torch.cuda.synchronize()
    return tokens / (time.monotonic() - t0), steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=2**31 + 19)
    ap.add_argument("--cost-seconds", type=float, default=20.0)
    ap.add_argument("--slice-seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("train_trace: no CUDA card; nothing falls back to the CPU", file=sys.stderr)
        return 2
    from perfbench import common, harness, readers, roofline, textgen, weights
    from perfbench.trace import _profile
    from tpu_rag_torch.device import compute_dtype
    from tpu_rag_torch.models.tokenizer import load_tokenizer
    from tpu_rag_torch.scripts.train_semantic import batch_sampler
    from tpu_rag_torch.train.contrastive import ContrastiveTrainer, warmup_cosine_decay
    from tpu_rag_torch.utils.metrics import GLOBAL_METRICS
    from tpu_rag_torch.utils.timing import SPANS, span

    harness.cache_env(ROOT)
    bench = harness.load_bench(ROOT)
    cell = harness.cell_of(bench, CELL)
    cfg = harness.config_of(ROOT, bench, cell["config"])
    traffic = harness.traffic_of(harness.PKG, cell["traffic"])
    drv = harness.driver_of(harness.PKG, traffic)
    tcfg, dev = cfg["train"], torch.device("cuda:0")
    log = {"card": harness.power_limit(), "torch": torch.__version__, "seed": args.seed}

    SPANS.enable()
    marks = [time.monotonic()]
    docs = drv.corpus(traffic, args.seed)
    tok = load_tokenizer(str(textgen.VOCAB), vocab_size=cfg["vocab_size"])
    sampler = batch_sampler(docs, tok, drv.sampler_args(tcfg, args.seed))
    marks.append(time.monotonic())
    lr = warmup_cosine_decay(0.0, tcfg["lr"], tcfg["warmup"], tcfg["steps"], tcfg["lr"] * 0.02)
    trainer = ContrastiveTrainer(common.port_spec(cfg), lr=lr, tau=tcfg["tau"],
                                 compute_dtype=compute_dtype(dev), device=dev)
    trainer.module.load_state_dict(weights.seeded_bert(cfg, args.seed, dev))
    marks.append(time.monotonic())
    init_spans = [s for s in SPANS.drain()[0] if s.name.startswith("train.init")]
    for _ in range(3):
        trainer.train_step(sampler())
    torch.cuda.synchronize()
    log["setup_s"] = {"corpus_and_tokenize": marks[1] - marks[0],
                      "trainer_outside": marks[2] - marks[1]}

    cost = []
    for on in (True, False, False, True, True, False):
        (SPANS.enable if on else SPANS.disable)()
        rate, steps = _loop(sampler, trainer, args.cost_seconds)
        spans, dropped = SPANS.drain()
        cost.append({"recorder": "on" if on else "off", "tokens_per_s": rate, "steps": steps,
                     "spans": len(spans), "dropped": dropped})
    log["cost"] = cost
    # one span's own cost on this host, off and on (fewer than the
    # recorder's capacity, so none is dropped)
    log["span_us"] = {}
    for on in (False, True):
        (SPANS.enable if on else SPANS.disable)()
        t = time.perf_counter_ns()
        for _ in range(50_000):
            with span("train.cost"):
                pass
        log["span_us"]["on" if on else "off"] = (time.perf_counter_ns() - t) / 50_000 / 1e3
        SPANS.drain()

    # the traced slice, the recorder on, bounded as perfbench's Slice is
    SPANS.enable()
    SPANS.drain()
    stamps: list[tuple[int, int]] = []

    def mark() -> None:
        a = time.monotonic_ns()
        torch.cuda._sleep(10_000)
        stamps.append((a, time.monotonic_ns()))
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    prof = _profile(torch)
    prof.__enter__()
    mark()
    c0 = {n: GLOBAL_METRICS.counter(n) for n in COUNTERS}
    t0 = time.monotonic()
    lens = []
    while time.monotonic() - t0 < args.slice_seconds:
        batch = sampler()
        trainer.train_step(batch)
        lens.append((batch["q_mask"].sum(1).tolist(), batch["d_mask"].sum(1).tolist()))
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    counters = {n: GLOBAL_METRICS.counter(n) - c0[n] for n in COUNTERS}
    mark()
    time.sleep(0.05)                # let the last activity records land before the flush
    prof.__exit__(None, None, None)
    spans, dropped = SPANS.drain()
    SPANS.disable()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    log["categories"] = categories(events)
    log["spans"] = {"kept": len(spans), "dropped": dropped}

    tr = join(events, spans, stamps)
    res = read(tr, counters, init_spans)
    # perfbench's own readers on the same events, for the idle split's sum
    from perfbench import trace as pb_trace

    pb = pb_trace.parse(events, wall_s)
    flops = sum(roofline.train_step_flops(cfg, q, d) for q, d in lens)
    res["device_idle.train"] = readers.idle_pct({"trace": pb})
    res["mfu.train"] = readers.mfu_pct({"trace": pb, "flops": flops})
    res["cast_share.train"] = readers.share_pct({"trace": pb}, ("bfloat16_copy_kernel",))
    res["real_tokens_in_masks"] = sum(sum(q) + sum(d) for q, d in lens)
    res["counters"] = counters
    log["read"] = res
    print("train_trace: set-up s: corpus and tokenize {:.2f}, trainer {:.2f} ({}); clock "
          "residual {} us".format(log["setup_s"]["corpus_and_tokenize"],
                                  log["setup_s"]["trainer_outside"],
                                  ", ".join(f"{k} {v:.2f}" for k, v in
                                            res["init_children_s"].items()),
                                  res["clock_residual_us"]), file=sys.stderr)
    line = json.dumps(log)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
