"""The readers of the ViT's attention and FFN spans, on records made by hand."""

import sys
import types

import pytest

from portbench import program_spans, spec

NAMES = {"vit_attn_ms.batch": "vit.attn", "vit_ffn_ms.batch": "vit.ffn"}


def spans_of_a_call(first_id: int, depth: int, scale: float, with_blocks: bool = True) -> list:
    """One call: two passes of a `depth`-block ViT, each block's attention
    (3 ms) and FFN (5 ms) inside the pass's `vit` span, then the head."""
    out, ids = [], iter(range(first_id, first_id + 1000))

    def add(name, parent, device):
        out.append({"name": name, "id": next(ids), "parent": parent, "request": first_id, "start_ns": 0,
                    "end_ns": 1, "host_ms": 1.0, "device_ms": None if device is None else device * scale,
                    "counters": {}})
        return out[-1]["id"]

    call = add("call", None, 500.0)
    for _ in range(2):
        vit = add("vit", call, 100.0)
        for _ in range(depth if with_blocks else 0):
            add("vit.attn", vit, 3.0)
            add("vit.ffn", vit, 5.0)
        add("head", call, 50.0)
    return out


def traced(calls: int) -> dict:
    return {"trace": {"calls": [{"start": 0.0, "end": 1.0, "pairs": 8}] * calls}}


@pytest.fixture
def program(monkeypatch):
    recorder = types.SimpleNamespace(found=[])
    recorder.records = lambda: recorder.found
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, recorder)
    return recorder


def test_each_reader_sums_its_spans_a_call(program, tiny_cell):
    program.found = spans_of_a_call(1, 40, 1.0) + spans_of_a_call(2000, 40, 3.0)  # a mean scale of 2
    want = {"vit_attn_ms.batch": 2 * 40 * 3.0 * 2, "vit_ffn_ms.batch": 2 * 40 * 5.0 * 2}
    for name in NAMES:
        assert spec.metric(name).read(traced(2), tiny_cell) == pytest.approx(want[name]), name


def test_a_program_without_the_spans_reads_nothing(program, tiny_cell):
    program.found = spans_of_a_call(1, 24, 1.0, with_blocks=False)  # a program older than the spans
    for name in NAMES:
        assert spec.metric(name).read(traced(1), tiny_cell) is None, name


def test_a_program_without_a_recorder_reads_nothing(monkeypatch, tiny_cell):
    monkeypatch.setitem(sys.modules, program_spans.RECORDER, types.SimpleNamespace())
    for name in NAMES:
        assert spec.metric(name).read(traced(2), tiny_cell) is None
    monkeypatch.delitem(sys.modules, program_spans.RECORDER)
    for name in NAMES:
        assert spec.metric(name).read(traced(2), tiny_cell) is None


def test_device_ms_off_the_card_reads_nothing(program, tiny_cell):
    found = spans_of_a_call(1, 2, 1.0)
    for s in found:
        s["device_ms"] = None
    program.found = found
    for name in NAMES:
        assert spec.metric(name).read(traced(1), tiny_cell) is None
