"""The readers of the program's own spans, on records made by hand."""

import sys
import types

import pytest

from portbench import program_spans, spec

BATCH = ("fpn_ms.batch", "corr_ms.batch", "sample_ms.batch")
NEW = BATCH + ("host_syncs_per_pair.serve",)


def spans_of_a_call(first_id: int, request: int, scale: float) -> list:
    """One call: pass 1 with the decoder, FPN and correlation; pass 2 with
    the decoder and FPN; then the draws, sampling and solve."""
    out, ids = [], iter(range(first_id, first_id + 100))

    def add(name, parent, host, device, syncs=0):
        out.append({"name": name, "id": next(ids), "parent": parent, "request": request, "start_ns": 0,
                    "end_ns": 1, "host_ms": host * scale, "device_ms": None if device is None else device * scale,
                    "counters": {"host_syncs": syncs} if syncs else {}})
        return out[-1]["id"]

    call = add("call", None, 100.0, 90.0, 1)
    for _ in range(2):
        add("vit", call, 7.0, 40.0)
        head = add("head", call, 20.0, 30.0, 2)
        add("head.decoder", head, 3.0, 5.0)
        add("head.fpn", head, 4.0, 6.0)
    add("head.corr", head, 1.0, 2.0)
    add("draws", call, 5.0, 1.0)
    add("sample", call, 6.0, 20.0, 3)
    add("solve", call, 2.0, 8.0)
    return out


def traced(calls: int, pairs: int) -> dict:
    return {"trace": {"calls": [{"start": 0.0, "end": 1.0, "pairs": pairs}] * calls}}


@pytest.fixture
def program(monkeypatch):
    """A stand-in for the program's recorder; its `records()` returns `found`."""
    recorder = types.SimpleNamespace(found=[])
    recorder.records = lambda: recorder.found
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, recorder)
    return recorder


def test_each_reader_divides_by_the_program_s_calls(program, tiny_cell):
    program.found = spans_of_a_call(1, 1, 1.0) + spans_of_a_call(200, 2, 3.0)  # a mean scale of 2
    rec = traced(2, 8)
    want = {"fpn_ms.batch": 2 * 6.0 * 2, "corr_ms.batch": 2.0 * 2, "sample_ms.batch": 20.0 * 2,
            "host_syncs_per_pair.serve": 2 * (1 + 2 * 2 + 3) / 16}
    for name in NEW:
        assert spec.metric(name).read(rec, tiny_cell) == pytest.approx(want[name]), name


def test_a_call_count_that_differs_reads_nothing(program, tiny_cell):
    program.found = spans_of_a_call(1, 1, 1.0) + spans_of_a_call(200, 2, 1.0)
    for calls in (1, 3):
        for name in NEW:
            assert spec.metric(name).read(traced(calls, 8), tiny_cell) is None, (name, calls)
    program.found = []
    for name in NEW:
        assert spec.metric(name).read(traced(0, 8), tiny_cell) is None, name


def test_a_program_without_a_recorder_reads_nothing(monkeypatch, tiny_cell):
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, types.SimpleNamespace())
    for name in NEW:
        assert spec.metric(name).read(traced(2, 8), tiny_cell) is None
    monkeypatch.delitem(sys.modules, program_spans.RECORDER)
    for name in NEW:
        assert spec.metric(name).read(traced(2, 8), tiny_cell) is None


def test_device_ms_off_the_card_reads_nothing(program, tiny_cell):
    found = spans_of_a_call(1, 1, 1.0)
    for s in found:
        s["device_ms"] = None
    program.found = found
    for name in BATCH:
        assert spec.metric(name).read(traced(1, 8), tiny_cell) is None
    assert spec.metric("host_syncs_per_pair.serve").read(traced(1, 8), tiny_cell) == pytest.approx(1.0)
