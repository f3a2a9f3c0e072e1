"""Reading a profiler trace: busy time, idle gaps, device operations."""

import pytest

from portbench import trace


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summary_of_a_made_up_trace():
    events = [
        X("user_annotation", "dispatch", 0, 100),
        X("cpu_op", "aten::to", 10, 30),
        X("user_annotation", "finish", 100, 300),
        X("kernel", "k1", 50, 100),            # 50..150
        X("gpu_memcpy", "Memcpy DtoH", 140, 20),   # 140..160, overlaps
        X("kernel", "k2", 250, 50),           # 250..300
        X("kernel", "k1", 390, 40),           # past the window's end: 400
        X("gpu_user_annotation", "dispatch", 0, 400),  # not device work
    ]
    s = trace.summarize(events, calls=1)
    assert s.window_s == pytest.approx(400e-6)
    assert s.busy_s == pytest.approx((110 + 50 + 10) * 1e-6)
    assert dict(s.device_ops)["k1"] == pytest.approx(140e-6)
    idle = dict(s.idle_gaps)
    assert idle["dispatch/aten::to"] == pytest.approx(50e-6)   # 0..50
    # 160..250 and 300..390
    assert idle["finish"] == pytest.approx((90 + 90) * 1e-6)
    assert sum(idle.values()) == pytest.approx(s.window_s - s.busy_s)


def test_no_spans_no_summary():
    assert trace.summarize([X("kernel", "k", 0, 1)], calls=1) is None
