"""The recorder of `gfnet_tpu_torch/utils/profiling.py`: spans and counters,
off and on, under the profiler, and at the matcher's and the train step's
layers on the CPU. The tests marked `cuda` (host syncs, CUDA-event device
time, the spans against a profiler trace) skip where there is no GPU; the file imports neither JAX nor the JAX
package, so on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch
from torch.autograd.profiler import record_function

from gfnet_tpu_torch.cli.train import train_loop
from gfnet_tpu_torch.config import TrainConfig, tiny_test_config
from gfnet_tpu_torch.matcher import GFNetMatcher
from gfnet_tpu_torch.ops import kernels
from gfnet_tpu_torch.train.loss import RobustLoss
from gfnet_tpu_torch.train.state import create_train_state
from gfnet_tpu_torch.train.step import make_train_step
from gfnet_tpu_torch.utils import profiling
from gfnet_tpu_torch.utils.profiling import count, span
from torch_cpu import one_thread  # noqa: F401

RES = 112
CALL_SPANS = {"call", "prep", "pass1", "pass2", "vit", "head", "head.decoder", "head.fpn", "head.corr",
              "stitch", "draws", "sample", "solve", "vit.attn", "vit.ffn"} | \
    {f"head.refiner.{s}" for s in ("16", "8", "4", "2", "1")}


@pytest.fixture(autouse=True)
def recorder():
    """Each test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.reset()
    yield
    profiling.disable()
    profiling.reset()


@pytest.fixture(scope="module")
def matcher():
    cfg = tiny_test_config().replace(symmetric=True, upsample_preds=True, attenuate_cert=True)
    return GFNetMatcher(cfg, device="cpu", dtype=torch.float32)


def pairs(seed: int, n: int = 2):
    gen = torch.Generator().manual_seed(seed)
    return torch.rand(n, RES, RES, 3, generator=gen), torch.rand(n, RES, RES, 3, generator=gen)


def by_name(recs):
    return {r["name"]: r for r in recs}


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a range {name} was opened")

    monkeypatch.setattr(profiling._autograd_profiler, "record_function", no_range)

    @span("decorated")
    def f():
        return 7

    assert not profiling.recording()
    assert span("a") is span("a")  # the shared no-op of its name
    with span("a"):
        count("n", 2)
        assert f() == 7
    assert profiling.records() == []
    assert profiling.counters() == {"n": 2}  # counted always, charged to no span


def test_spans_carry_parent_request_and_nested_host_intervals():
    profiling.enable()
    for _ in range(2):
        with span("call"):
            with span("outer"):
                with span("inner"):
                    pass
            with span("sibling"):
                pass
    recs = profiling.records()
    assert [r["name"] for r in recs] == ["call", "outer", "inner", "sibling"] * 2
    first, second = recs[:4], recs[4:]
    for req in (first, second):
        call, outer, inner, sibling = req
        assert call["parent"] is None and outer["parent"] == call["id"]
        assert inner["parent"] == outer["id"] and sibling["parent"] == call["id"]
        assert len({r["request"] for r in req}) == 1
        assert call["start_ns"] <= outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] <= outer["end_ns"]
        assert outer["end_ns"] <= sibling["start_ns"] <= sibling["end_ns"] <= call["end_ns"]
        assert all(r["host_ms"] >= 0 and r["device_ms"] is None for r in req)
    assert first[0]["request"] != second[0]["request"]


def test_counters_go_to_the_innermost_open_span():
    profiling.enable()
    count("k", 1)  # no span open: the total only
    with span("call"):
        count("k", 2)
        with span("inner"):
            count("k", 3)
            count("other")
        count("k", 4)
    recs = by_name(profiling.records())
    assert recs["call"]["counters"] == {"k": 6}
    assert recs["inner"]["counters"] == {"k": 3, "other": 1}
    assert profiling.counters() == {"k": 10, "other": 1}


def test_the_buffer_keeps_the_last_requests():
    profiling.enable()
    n = profiling.MAX_REQUESTS + 10
    for i in range(n):
        with span("call"):
            with span("inner"):
                count("i", i)
    recs = profiling.records()
    assert len(recs) == 2 * profiling.MAX_REQUESTS
    last = recs[-1]["request"]
    assert {r["request"] for r in recs} == set(range(last - profiling.MAX_REQUESTS + 1, last + 1))
    assert recs[1]["counters"] == {"i": 10} and recs[-1]["counters"] == {"i": n - 1}


def test_a_decorated_function_looks_at_each_call():
    @span("fn")
    def f(x):
        return x + 1

    assert f(1) == 2 and profiling.records() == []
    profiling.enable()
    assert f(2) == 3
    assert [r["name"] for r in profiling.records()] == ["fn"]
    assert f.__name__ == "f"


def test_the_profiler_turns_the_recorder_on_and_sees_nested_ranges(tmp_path):
    with profiling.trace(str(tmp_path)):
        assert profiling.recording()
        with span("call"):
            with span("inner"):
                torch.ones(8).sum()
    assert not profiling.recording()
    assert [r["name"] for r in profiling.records()] == ["call", "inner"]
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {e["name"]: (e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("ph") == "X" and e["name"].startswith(profiling.RANGE_PREFIX)}
    assert set(ranges) == {"gfnet.call", "gfnet.inner"}
    (c0, c1), (i0, i1) = ranges["gfnet.call"], ranges["gfnet.inner"]
    assert c0 <= i0 <= i1 <= c1
    assert not any(e.get("name", "").startswith("portbench.") for e in events)


def test_reset_with_prefixes_zeroes_only_those_counters():
    for name in ("k1.launches", "k2.launches", "k3.launches", "k4.launches", "k5.launches", "k6.launches",
                 "k1.kernel.x", "host_syncs"):
        count(name)
    assert kernels.launch_counts() == {"oneshot_attention": 1, "local_corr": 1, "local_corr_bwd": 1, "kde": 1,
                                       "residual_norm": 1, "refine_block": 1}
    assert kernels.k1_kernel_counts() == {"x": 1}
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == {"oneshot_attention": 0, "local_corr": 0, "local_corr_bwd": 0, "kde": 0,
                                       "residual_norm": 0, "refine_block": 0}
    assert profiling.counters() == {"host_syncs": 1}


def test_summarize_gives_means_a_call_and_syncs_with_the_childrens():
    recs = [{"name": "call", "id": 1, "parent": None, "request": 1, "host_ms": 10.0, "device_ms": 8.0,
             "counters": {"host_syncs": 1}},
            {"name": "solve", "id": 2, "parent": 1, "request": 1, "host_ms": 4.0, "device_ms": 3.0,
             "counters": {"host_syncs": 2}},
            {"name": "call", "id": 3, "parent": None, "request": 2, "host_ms": 20.0, "device_ms": 12.0,
             "counters": {}},
            {"name": "solve", "id": 4, "parent": 3, "request": 2, "host_ms": 6.0, "device_ms": None,
             "counters": {"host_syncs": 1}}]
    got = profiling.summarize(recs)
    assert got["call"] == {"host_ms": 15.0, "device_ms": 10.0, "host_syncs": 2.0}
    assert got["solve"] == {"host_ms": 5.0, "device_ms": None, "host_syncs": 1.5}
    assert profiling.summarize(recs, prefix="so") == {"solve": got["solve"]}
    assert profiling.summarize(recs, per="none") == {}


def test_a_matcher_call_records_each_layer_and_the_same_homographies(matcher):
    a, b = pairs(0)
    off = matcher.estimate_homography_batched(a, b, 200, key=np.array([0, 3], np.uint32))
    profiling.enable()
    on = matcher.estimate_homography_batched(a, b, 200, key=np.array([0, 3], np.uint32))
    profiling.disable()
    assert torch.equal(off, on)
    recs = profiling.records()
    assert {r["name"] for r in recs} == CALL_SPANS
    assert [r["name"] for r in recs if r["parent"] is None] == ["call"]
    names = [r["name"] for r in recs]
    assert names.count("prep") == 4 and names.count("vit") == 2 and names.count("head") == 2
    assert names.count("head.decoder") == 2 and names.count("head.corr") == 1  # pass 2 starts from pass 1's flow
    ids = {r["id"]: r for r in recs}
    assert all(ids[r["parent"]]["name"] == "head" for r in recs if r["name"].startswith("head."))
    assert all(ids[r["parent"]]["name"] == "call" for r in recs if r["name"] in ("draws", "sample", "solve"))
    depth = matcher.cfg.dino.depth  # each block's attention and FFN once a pass, inside the pass's `vit`
    assert names.count("vit.attn") == names.count("vit.ffn") == 2 * depth
    assert all(ids[r["parent"]]["name"] == "vit" for r in recs if r["name"].startswith("vit."))
    assert "vit.register_tokens" not in profiling.counters()  # tiny_test_config has no registers


def test_a_register_vit_spans_each_block_and_counts_its_tokens():
    """Two passes of a ViT with 4 register tokens over 3 images: each block's
    `vit.attn` and `vit.ffn` once a pass, inside the pass's span, and
    `vit.register_tokens` 4 a pass an image (the matcher's own ViT-L-style
    tiny config counts none: the matcher-call test above)."""
    from gfnet_tpu_torch.models.vit import VisionTransformer

    dino = dataclasses.replace(tiny_test_config().dino, num_register_tokens=4, interpolate_offset=0.0,
                               interpolate_antialias=True)
    vit = VisionTransformer(dino, dtype=torch.float32).eval()
    x = torch.rand(3, RES, RES, 3, generator=torch.Generator().manual_seed(4))
    profiling.enable()
    with torch.no_grad():
        for _ in range(2):
            with span("vit"):
                vit(x)
    recs = profiling.records()
    ids = {r["id"]: r for r in recs}
    for name in ("vit.attn", "vit.ffn"):
        spans = [r for r in recs if r["name"] == name]
        assert len(spans) == 2 * dino.depth and all(ids[r["parent"]]["name"] == "vit" for r in spans)
    assert [r["counters"].get("vit.register_tokens") for r in recs if r["name"] == "vit"] == [4 * 3] * 2
    assert profiling.counters()["vit.register_tokens"] == 4 * 3 * 2


def test_match_and_sample_are_a_call_each(matcher):
    a, b = pairs(1, 1)
    profiling.enable()
    warp, cert = matcher.match(a[0], b[0])
    matcher.sample(warp, cert, 50, key=np.array([0, 1], np.uint32))
    roots = [r["name"] for r in profiling.records() if r["parent"] is None]
    names = {r["name"] for r in profiling.records()}
    assert roots == ["call", "call"]
    assert "sample" in names and "solve" not in names and "draws" not in names


def tiny_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ims = rng.integers(0, 256, (2, 2, RES, RES, 3), dtype=np.uint8)
    H = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    H[:, :2, 2] = rng.uniform(-4, 4, (2, 2))
    return {"im_A": ims[0], "im_B": ims[1], "H_s2t": H}


def test_a_train_step_records_forward_backward_and_update():
    m = GFNetMatcher(tiny_test_config(), device="cpu", dtype=torch.float32)
    state = create_train_state(m.head, TrainConfig(), 2)
    step = make_train_step(m, RobustLoss(im_size=RES))
    profiling.enable()
    step(state, tiny_batch(0))
    recs = profiling.records()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["train.step"]
    children = [r["name"] for r in recs if r["parent"] == roots[0]["id"]]
    assert children == ["train.forward", "train.backward", "train.update"]
    ids = {r["id"]: r for r in recs}
    # the head's features are recomputed in backward: their spans nest there too
    assert {ids[r["parent"]]["name"] for r in recs if r["name"] == "head.fpn"} == {"train.forward", "train.backward"}


class Logged:
    def __init__(self):
        self.lines = []

    def log(self, metrics, step):
        self.lines.append(metrics)


class NoCheckpoints:
    def save(self, state):
        pass


class Counted:
    step = 0


def test_train_loop_logs_each_train_span_a_step():
    @span("train.step")
    def step(state, batch):
        with span("train.forward"):
            pass
        state.step += 1
        return state, {"loss": torch.tensor(1.0)}

    logger = Logged()
    train_loop(Counted(), step, [{}] * 4, NoCheckpoints(), 4, 4, 2, logger=logger, log_every=2)
    assert [set(m) for m in logger.lines] == [{"loss", "samples_per_s"}] * 2  # the recorder was off
    profiling.enable()
    logger = Logged()
    train_loop(Counted(), step, [{}] * 4, NoCheckpoints(), 4, 4, 2, logger=logger, log_every=2)
    assert len(logger.lines) == 2
    for m in logger.lines:
        assert {f"train.{s}.{k}" for s in ("step", "forward", "data_wait") for k in ("host_ms", "host_syncs")} \
            <= set(m)
        assert m["train.step.host_syncs"] == 0.0 and m["train.forward.host_ms"] <= m["train.step.host_ms"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (host syncs and CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_syncs_count_each_device_to_host_wait(cuda_device):
    x = torch.arange(1.0, 9.0, device=cuda_device)
    x.sum().item()  # initialises the card outside any span
    mode, shown = torch.cuda.get_sync_debug_mode(), warnings.showwarning
    profiling.enable()
    with span("call"):
        x.sum().item()
        with span("inner"):
            x.cpu()
            x[x > 4].sum()  # boolean indexing waits for the count of its rows
        torch.cuda.synchronize()  # an explicit wait: not counted
    x.sum().item()  # no span open: not counted
    recs = by_name(profiling.records())
    assert recs["call"]["counters"] == {"host_syncs": 1}
    assert recs["inner"]["counters"] == {"host_syncs": 2}
    assert profiling.counters() == {"host_syncs": 3}
    assert torch.cuda.get_sync_debug_mode() == mode and warnings.showwarning is shown


@pytest.mark.cuda
def test_device_ms_is_the_span_s_time_on_the_card(cuda_device):
    torch.ones(1, device=cuda_device).sum().item()
    profiling.enable()
    with span("call"):
        torch.cuda._sleep(200_000_000)  # about 0.1 s of one kernel, launched in microseconds
        with span("idle"):
            pass
    recs = by_name(profiling.records())
    assert recs["call"]["device_ms"] > 20.0 and recs["call"]["host_ms"] < recs["call"]["device_ms"]
    assert 0.0 <= recs["idle"]["device_ms"] < recs["call"]["device_ms"]


@pytest.mark.cuda
def test_events_given_back_time_the_next_spans(cuda_device):
    torch.ones(1, device=cuda_device).sum().item()
    profiling.enable()
    for _ in range(2):
        with span("call"):
            torch.cuda._sleep(200_000_000)
    long = [r["device_ms"] for r in profiling.records()]  # reading gives the events back
    profiling.reset()
    for _ in range(2):
        with span("call"):
            pass
    short = [r["device_ms"] for r in profiling.records()]
    assert min(long) > 20.0 and 0.0 <= max(short) < 1.0


SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


@pytest.mark.cuda
def test_the_spans_agree_with_the_profiler_s_trace(cuda_device, tmp_path):
    """One profiled matcher call on the card, with a range of the caller's
    around it and a forward hook's range around `m.vit`: every `gfnet.*`
    range lies inside the caller's; the kernels launched inside `gfnet.vit`
    are those launched inside the hook's; `host_syncs` equals the runtime's
    synchronising calls inside `gfnet.call`."""
    m = GFNetMatcher(tiny_test_config(), device="cuda", dtype=torch.float32)
    a, b = (x.to(cuda_device) for x in pairs(2))
    key = np.array([0, 5], np.uint32)
    m.estimate_homography_batched(a, b, 200, key=key)  # builds the kernels
    opened = []

    def pre(_m, _a):
        opened.append(record_function("hook.vit"))
        opened[-1].__enter__()

    def post(_m, _a, _o):
        opened.pop().__exit__(None, None, None)

    handles = [m.vit.register_forward_pre_hook(pre), m.vit.register_forward_hook(post)]
    try:
        with profiling.trace(str(tmp_path)):
            with record_function("hook.call"):
                m.estimate_homography_batched(a, b, 200, key=key)
    finally:
        for h in handles:
            h.remove()
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"] if e.get("ph") == "X"]

    def ranges(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "user_annotation" and e["name"] == name]

    def inside(t, spans):
        return any(s <= t <= e for s, e in spans)

    (c0, c1), = ranges("hook.call")
    program = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "user_annotation" and e["name"].startswith(profiling.RANGE_PREFIX)]
    assert len(program) == len(profiling.records()) and all(c0 <= s and e <= c1 for s, e in program)

    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {})}
    kernels = [launched[e["args"]["correlation"]] for e in events
               if e.get("cat") == "kernel" and e["args"].get("correlation") in launched]
    in_vit = sum(inside(t, ranges("gfnet.vit")) for t in kernels)
    assert in_vit > 0 and in_vit == sum(inside(t, ranges("hook.vit")) for t in kernels)

    syncs = [e["ts"] for e in events if e.get("cat") in RUNTIME_CATS
             and (e["name"] in SYNC_CALLS or (e["name"].startswith("cudaMemcpy") and "Async" not in e["name"]))]
    counted = sum(r["counters"].get("host_syncs", 0) for r in profiling.records())
    assert counted > 0 and counted == sum(inside(t, ranges("gfnet.call")) for t in syncs)
