"""Busy time is the union of device intervals; idle gaps and the slice
come from the profiler's chrome trace."""

import pytest

from perfbench import harness, readers, trace


def test_union_counts_overlaps_once():
    assert trace.union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_s([(0, 1), (0, 1)]) == 1
    assert trace.union_s([]) == 0


def test_gaps_are_what_no_interval_covers():
    assert trace.gaps([(1, 2), (1.5, 3), (5, 6)], 0, 7) == [(0, 1), (3, 5), (6, 7)]


def _trace():
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void spin_kernel(long)", "ts": 990.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "bfloat16_copy_kernel", "ts": 1100.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1200.0, "dur": 300.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1900.0, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "early", "ts": 500.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "range", "ts": 1000.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "void spin_kernel(long)", "ts": 2000.0, "dur": 10.0},
    ]
    # host clock: the first marker ends at t0 = 5.0 s; a span 1.5-1.85 ms after it
    return trace.parse(ev, wall_s=1e-3, t0=5.0, spans=[("embed", 5.0005, 5.00085)])


def test_parse_clips_to_the_markers():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    # kernels 1100-1500 and the copy clipped to 1900-2000: 500 us busy
    assert tr.busy_s == pytest.approx(500e-6)
    assert readers.idle_pct({"trace": tr}) == pytest.approx(50.0)
    assert readers.idle_pct({"trace": tr, "partial": ["lost"]}) is None
    b = tr.breakdown()
    assert b["device_ops"][0][0] == "gemm"
    assert b["idle_gaps"][0][0].startswith("embed")
    assert b["idle_gaps"][0][1] == pytest.approx(400e-6)


def test_mfu_reader():
    tr = _trace()
    assert readers.mfu_pct({"trace": tr, "flops": 989e12 * 1e-3 / 10}) == pytest.approx(10.0)
    assert readers.mfu_pct({"trace": tr}) is None
    assert readers.mfu_pct({"trace": None, "flops": 1.0}) is None


def test_a_lost_marker_marks_the_trace():
    ev = [{"ph": "X", "cat": "kernel", "name": "void spin_kernel(long)", "ts": 990.0, "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 1200.0, "dur": 300.0}]
    tr = trace.parse(ev, wall_s=1e-3)
    assert tr.lost and tr.window_s == pytest.approx(1e-3) and tr.busy_s == pytest.approx(300e-6)
    assert not _trace().lost


def test_share_of_device_time():
    tr = _trace()
    # the cast 200 us, gemm 300 us (clipped spans: 1100-1300, 1200-1500), copy 100 us
    assert readers.share_pct({"trace": tr}, ("gemm",)) == pytest.approx(50.0)
    assert readers.share_pct({"trace": tr}, ("nothing",)) == pytest.approx(0.0)
    assert readers.share_pct({"trace": None}, ("gemm",)) is None
    cast = harness.reader_of(harness.PKG, "cast_share.train")
    assert cast.read({"trace": tr}) == pytest.approx(100.0 * 200 / 600)
