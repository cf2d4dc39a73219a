"""The span recorder (tpu_rag_torch/utils/timing.py), the training loop's
spans and counters, and train_trace.py's join of spans with a device trace
(a synthetic chrome trace with launch records and two markers)."""

import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import train_trace
from perfbench import readers
from perfbench import trace as pb_trace
from tpu_rag_torch.models.bert import BertSpec
from tpu_rag_torch.scripts.train_semantic import batch_sampler
from tpu_rag_torch.train.contrastive import ContrastiveTrainer
from tpu_rag_torch.utils import timing
from tpu_rag_torch.utils.metrics import GLOBAL_METRICS

SPEC = dict(vocab_size=512, hidden=64, layers=2, heads=4, ffn=128, max_len=64)
STEP_PARTS = ("train.upload", "train.forward", "train.backward", "train.optimizer",
              "train.readback")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def recording():
    """The process's recorder on and empty; off and drained afterwards."""
    timing.SPANS.drain()
    timing.SPANS.enable()
    try:
        yield timing.SPANS
    finally:
        timing.SPANS.disable()
        timing.SPANS.drain()


def _batch(rng, b: int = 8, seq: int = 16) -> dict:
    out = {}
    for side in "qd":
        ids = rng.integers(4, SPEC["vocab_size"], (b, seq)).astype(np.int32)
        mask = np.ones((b, seq), np.int32)
        mask[b // 2:, seq // 2:] = 0
        ids[mask == 0] = 0
        out[f"{side}_ids"], out[f"{side}_mask"] = ids, mask
    return out


# ---- the recorder

@pytest.mark.parametrize("rec", ["global", "own"])
def test_off_records_nothing_and_hands_back_the_shared_noop(rec):
    r = timing.SPANS if rec == "global" else timing.SpanRecorder()
    assert not r.on
    ctx = timing.span("x") if rec == "global" else r.span("x", step=3)
    assert ctx is timing.NOOP
    with ctx:
        pass
    assert r.drain() == ([], 0)


def test_nesting_gives_parents_and_inherited_steps():
    r = timing.SpanRecorder()
    r.enable()
    with r.span("outer", step=7):
        with r.span("inner"):
            with r.span("leaf", step=9):
                pass
    spans, dropped = r.drain()
    by = {s.name: s for s in spans}
    assert dropped == 0 and [s.name for s in spans] == ["leaf", "inner", "outer"]
    assert by["outer"].parent is None
    assert by["inner"].parent == by["outer"].id and by["leaf"].parent == by["inner"].id
    assert (by["outer"].step, by["inner"].step, by["leaf"].step) == (7, 7, 9)
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["leaf"].start_ns
    assert by["leaf"].end_ns <= by["inner"].end_ns <= by["outer"].end_ns
    assert {s.thread for s in spans} == {threading.get_native_id()}


def test_threads_keep_their_own_stacks():
    r = timing.SpanRecorder()
    r.enable()
    opened, other_done = threading.Event(), threading.Event()

    def other():
        assert opened.wait(10)
        with r.span("b"):
            with r.span("b.child"):
                pass
        other_done.set()

    t = threading.Thread(target=other)
    t.start()
    with r.span("a"):
        opened.set()
        assert other_done.wait(10)
    t.join(10)
    assert not t.is_alive()
    by = {s.name: s for s in r.drain()[0]}
    assert by["b"].parent is None and by["b.child"].parent == by["b"].id
    assert by["a"].parent is None and by["a"].thread != by["b"].thread


def test_the_bounded_buffer_counts_what_it_drops():
    r = timing.SpanRecorder(capacity=3)
    r.enable()
    for i in range(5):
        with r.span("s", step=i):
            pass
    spans, dropped = r.drain()
    assert [s.step for s in spans] == [0, 1, 2] and dropped == 2
    assert r.drain() == ([], 0)


@pytest.mark.parametrize("on", [True, False])
def test_a_running_profiler_sees_the_spans_as_ranges(on):
    trainer = ContrastiveTrainer(BertSpec(**SPEC), lr=1e-3, device="cpu")
    batch = _batch(np.random.default_rng(0))
    if on:
        timing.SPANS.enable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            trainer.train_step(batch)
    finally:
        timing.SPANS.disable()
        timing.SPANS.drain()
    names = {e.key for e in prof.key_averages()}
    ours = set(STEP_PARTS) | {"train.step"}
    assert "contrastive.forward" not in names
    assert ours & names == (ours if on else set())


# ---- the training loop's spans and counters

def test_one_train_step_yields_its_spans(recording):
    trainer = ContrastiveTrainer(BertSpec(**SPEC), lr=1e-3, device="cpu")
    init = {s.name: s for s in recording.drain()[0]}
    children = {"train.init.module", "train.init.params", "train.init.optimizer"}
    assert set(init) == children | {"train.init"}
    assert all(init[name].parent == init["train.init"].id for name in children)
    rng = np.random.default_rng(1)
    trainer.train_step(_batch(rng))
    recording.drain()
    trainer.train_step(_batch(rng))
    spans, dropped = recording.drain()
    steps = [s for s in spans if s.name == "train.step"]
    assert dropped == 0 and len(steps) == 1 and steps[0].step == 1
    kids = [s for s in spans if s.parent == steps[0].id]
    assert sorted(s.name for s in kids) == sorted(STEP_PARTS)
    assert all(s.step == 1 for s in spans) and len(spans) == 1 + len(STEP_PARTS)
    # in the order the step takes them, inside the step
    kids.sort(key=lambda s: s.start_ns)
    assert tuple(s.name for s in kids) == STEP_PARTS
    assert steps[0].start_ns <= kids[0].start_ns and kids[-1].end_ns <= steps[0].end_ns


class _Tok:
    """A tokenizer of the sampler's interface: one id a word."""
    cls_id, sep_id, pad_id = 1, 2, 0

    def tokenize_ids(self, text: str) -> list[int]:
        return [3 + len(w) for w in text.split()]


def test_the_sampler_counts_real_tokens_and_slots(recording):
    rng = np.random.default_rng(2)
    words = ["alpha", "be", "gamma", "delta", "epsilon", "z"]
    docs = [{"query": " ".join(rng.choice(words, int(rng.integers(0, 9)))),
             "body": " ".join(rng.choice(words, int(rng.integers(1, 90))))}
            for _ in range(40)]
    args = SimpleNamespace(batch=8, q_len=12, seq_len=40, crop_prob=0.5, seed=3)
    sample = batch_sampler(docs, _Tok(), args)
    names = train_trace.COUNTERS
    before = [GLOBAL_METRICS.counter(n) for n in names]
    batches = [sample() for _ in range(3)]
    real, slots = (GLOBAL_METRICS.counter(n) - b for n, b in zip(names, before))
    assert real == sum(int(b["q_mask"].sum()) + int(b["d_mask"].sum()) for b in batches)
    assert slots == 3 * args.batch * (args.q_len + args.seq_len)
    spans = recording.drain()[0]
    assert [(s.name, s.step, s.parent) for s in spans] == \
        [("train.sample", i, None) for i in range(3)]


def test_the_recorder_changes_no_number():
    """Three steps from the same start give the same losses and
    parameters, bit for bit, with the recorder off and on."""
    out = []
    for on in (False, True):
        (timing.SPANS.enable if on else timing.SPANS.disable)()
        try:
            trainer = ContrastiveTrainer(BertSpec(**SPEC), lr=1e-3, device="cpu")
            rng = np.random.default_rng(4)
            losses = [trainer.train_step(_batch(rng)) for _ in range(3)]
        finally:
            timing.SPANS.disable()
            spans = timing.SPANS.drain()[0]
        assert len(spans) == (3 * (1 + len(STEP_PARTS)) + 4 if on else 0)
        out.append((losses, trainer.module.state_dict()))
    (l0, p0), (l1, p1) = out
    assert l0 == l1
    assert p0.keys() == p1.keys() and all(torch.equal(p0[k], p1[k]) for k in p0)


# ---- train_trace.py's join: a synthetic trace, times in microseconds

HOST_US = 7_000_000            # the host's clock runs this far ahead of the trace's


def _ns(us: float) -> int:
    return int(round((us + HOST_US) * 1000))


def _span(i, parent, name, s, e, step):
    return timing.Span(i, parent, name, 1, _ns(s), _ns(e), step)


def _events():
    """Two markers (launched at 1000 and 1985 us; the slice 1020-2000),
    two steps and their ops, the backward's launched from thread 200."""
    ev = []

    def op(corr, cat, name, launch, start, end, tid=100, lcat="cuda_runtime"):
        ev.append({"ph": "X", "cat": lcat, "name": "cudaLaunchKernel", "tid": tid,
                   "ts": launch, "dur": 4.0, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": cat, "name": name, "ts": start, "dur": end - start,
                   "args": {"correlation": corr}})

    op(1, "kernel", "void spin_kernel(long)", 1000, 1010, 1020)
    op(10, "gpu_memcpy", "Memcpy HtoD", 1105, 1110, 1130)
    op(11, "kernel", "gemm", 1125, 1130, 1180)
    op(12, "kernel", "bfloat16_copy_kernel", 1150, 1180, 1260)
    op(13, "kernel", "gemm_bwd", 1210, 1260, 1300, tid=200)
    op(14, "kernel", "ln_bwd", 1300, 1320, 1400, tid=200)
    op(15, "kernel", "adamw", 1405, 1410, 1500, lcat="cuda_driver")
    op(16, "gpu_memcpy", "Memcpy DtoH", 1455, 1500, 1510)
    op(17, "kernel", "stray", 1520, 1522, 1526)
    op(20, "kernel", "gemm", 1710, 1720, 1800)
    op(21, "kernel", "gemm_bwd", 1810, 1810, 1890, tid=200)
    op(22, "kernel", "adamw", 1905, 1910, 1950)
    op(23, "gpu_memcpy", "Memcpy DtoH", 1955, 1960, 1965)
    op(2, "kernel", "void spin_kernel(long)", 1985, 2000, 2010)
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": "train.step", "ts": 1110,
               "dur": 400})
    return ev


SPANS = [
    _span(0, None, "train.sample", 1030, 1100, 0),
    _span(1, None, "train.step", 1100, 1515, 0),
    _span(2, 1, "train.upload", 1100, 1120, 0),
    _span(3, 1, "train.forward", 1120, 1200, 0),
    _span(4, 1, "train.backward", 1200, 1400, 0),
    _span(5, 1, "train.optimizer", 1400, 1450, 0),
    _span(6, 1, "train.readback", 1450, 1515, 0),
    _span(7, None, "train.sample", 1530, 1700, 1),
    _span(8, None, "train.step", 1700, 1970, 1),
    _span(9, 8, "train.forward", 1700, 1800, 1),
    _span(10, 8, "train.backward", 1800, 1900, 1),
    _span(11, 8, "train.optimizer", 1900, 1950, 1),
    _span(12, 8, "train.readback", 1950, 1970, 1),
]
# host stamps around the markers' launches: the first centred on its
# launch record (1002 us), the second 3 us late
STAMPS = [(_ns(998), _ns(1006)), (_ns(1986), _ns(1994))]
INIT = [timing.Span(90, None, "train.init", 1, 0, 2_000_000_000, None),
        timing.Span(91, 90, "train.init.module", 1, 0, 500_000_000, None),
        timing.Span(92, 90, "train.init.params", 1, 500_000_000, 1_900_000_000, None)]
WINDOW_US = 980.0


def test_the_clock_map_takes_the_first_markers_launch_record():
    tr = train_trace.join(_events(), SPANS, STAMPS)
    assert not tr.partial
    assert tr.residual_s * 1e6 == pytest.approx(-3.0, abs=1e-3)
    assert tr.slack_s * 1e6 == pytest.approx(4.0, abs=1e-3)
    assert tr.window_s * 1e6 == pytest.approx(WINDOW_US)
    # a span at 1100-1515 us on the trace's clock, from 1000 us
    step = next(s for s in tr.spans if s.id == 1)
    assert (step.start * 1e6, step.end * 1e6) == (pytest.approx(100.0, abs=1e-3),
                                                  pytest.approx(515.0, abs=1e-3))


def test_ops_go_to_the_span_that_holds_their_launch_on_any_thread():
    tr = train_trace.join(_events(), SPANS, STAMPS)
    by = {s.id: s for s in tr.spans}
    names = lambda i: sorted(o.name for o in train_trace.launched_under(tr, by[i]))  # noqa: E731
    assert names(2) == ["Memcpy HtoD"]
    assert names(3) == ["bfloat16_copy_kernel", "gemm"]
    assert names(4) == ["gemm_bwd", "ln_bwd"]                  # thread 200's launches
    assert names(5) == ["adamw"]                                # a driver-API launch
    assert names(10) == ["gemm_bwd"]
    assert len(train_trace.launched_under(tr, by[1])) == 7
    assert [s.id for s in train_trace.whole_steps(tr)] == [1, 8]


def test_idle_is_split_by_the_innermost_span():
    tr = train_trace.join(_events(), SPANS, STAMPS)
    r = train_trace.read(tr, {train_trace.COUNTERS[0]: 300.0,
                              train_trace.COUNTERS[1]: 1000.0}, INIT)
    pct = lambda us: 100.0 * us / WINDOW_US  # noqa: E731
    assert r["device_idle_pct"] == pytest.approx(pct(401))
    assert r["sample_idle.train"] == pytest.approx(pct(240))
    assert r["launch_idle.train"] == pytest.approx(pct(90))
    assert r["readback_idle_pct"] == pytest.approx(pct(20))
    assert r["no_span_idle_pct"] == pytest.approx(pct(51))
    assert r["other_span_idle_pct"] == pytest.approx(0.0, abs=1e-9)
    assert r["sample_idle.train"] + r["launch_idle.train"] + r["readback_idle_pct"] \
        + r["no_span_idle_pct"] == pytest.approx(r["device_idle_pct"])
    # the five longest gaps, each named by the innermost span at its middle
    # (1900 us: train.optimizer, which starts there, inside train.step)
    assert sorted((name, round(s * 1e6)) for name, s, _, _ in r["idle_gaps"][:5]) == \
        [("no program span", 35), ("train.backward", 20), ("train.optimizer", 20),
         ("train.sample", 90), ("train.sample", 194)]
    # the longest runs from the end of the stray op into the second forward
    assert r["idle_gaps"][0][2:] == ["no program span", "train.forward"]
    # perfbench's own reader gives the same idle share on these events
    pb = pb_trace.parse(_events(), wall_s=WINDOW_US * 1e-6)
    assert readers.idle_pct({"trace": pb}) == pytest.approx(r["device_idle_pct"])


def test_each_reading_of_the_synthetic_trace():
    tr = train_trace.join(_events(), SPANS, STAMPS)
    r = train_trace.read(tr, {train_trace.COUNTERS[0]: 300.0,
                              train_trace.COUNTERS[1]: 1000.0}, INIT)
    want = {"sample_ms.train": 0.120, "readback_ms.train": 0.0425,
            "forward_ms.train": 0.105, "backward_ms.train": 0.100,
            "optimizer_ms.train": 0.065, "pad_share.train": 70.0,
            "trainer_init_s.train": 2.0}
    for name, value in want.items():
        assert r[name] == pytest.approx(value, abs=1e-6), name
    assert r["init_children_s"] == {"train.init.module": pytest.approx(0.5),
                                    "train.init.params": pytest.approx(1.4)}
    assert r["steps"] == 2
    assert r["host_ms"] == {"train.upload": pytest.approx(0.020), "train.forward":
                            pytest.approx(0.090), "train.backward": pytest.approx(0.150),
                            "train.optimizer": pytest.approx(0.050),
                            "train.readback": pytest.approx(0.0425),
                            "train.step": pytest.approx(0.3425)}
    assert r["no_span_busy_pct"] == pytest.approx(100.0 * 4 / 579)
    assert r["no_launch_record_busy_pct"] == 0.0


@pytest.mark.parametrize("drop", ["launch records", "second stamp"])
def test_without_launch_records_the_readings_are_none(drop):
    if drop == "launch records":
        events = [e for e in _events() if e["cat"] not in train_trace.LAUNCH_CATS]
        stamps = STAMPS
    else:
        events, stamps = _events(), STAMPS[:1]
    tr = train_trace.join(events, SPANS, stamps)
    assert tr.partial
    r = train_trace.read(tr, {train_trace.COUNTERS[0]: 300.0,
                              train_trace.COUNTERS[1]: 1000.0}, INIT)
    for name in ("sample_ms.train", "sample_idle.train", "launch_idle.train",
                 "readback_ms.train", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train"):
        assert r[name] is None, name
    # what needs no launch record still reads
    assert r["pad_share.train"] == pytest.approx(70.0)
    assert r["trainer_init_s.train"] == pytest.approx(2.0)
    assert r["device_idle_pct"] == pytest.approx(100.0 * 401 / WINDOW_US)


def test_the_script_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert train_trace.main(["--cost-seconds", "0"]) == 2
