"""The program's spans and counters, profiler traces, a timer, and the card's peaks.

  - `span(name)`, `count(name, n)`: the recorder (below);
  - `trace(logdir)`: a context manager around `torch.profiler.profile` (the
    CPU's activity, and the card's where there is one) that writes a Chrome
    trace into `logdir`;
  - `timed(fn, *args)`: the median wall seconds of a call, synchronised
    with the card when the call ran on it;
  - `bound(ops, nbytes)`: the least time the card could take for a kernel's
    work, which `chip_smoke.py` sets beside each kernel's time.

The recorder. `span(name)` marks one call of a layer, as a context manager
or a decorator; `count(name, n)` adds to a counter. Spans record while
`enable()` has turned the recorder on, or while a torch profiler is
recording, so a profiled run records with no change to its caller. Off, a
span tests a flag and returns a shared no-op context: no range, no event,
no allocation. On, a span keeps its name, its host start and end
(`time.perf_counter_ns`), its parent, the request it belongs to (every span
opened while an outermost one is open: one matcher call or one train step),
the counters charged to it, and, where the card is in use, a pair of CUDA
events on the current stream, whose elapsed time is read only by
`records()`; the events are reused once read or dropped, so a span creates
none after the first requests. Each span also opens
`record_function("gfnet.<name>")`, so it lies in any profiler trace on the
clock the device's operations are stamped with. Spans form one stack for the process: the autograd engine's threads
open theirs while the caller waits in `backward()`.

Counters are kept always (`counters()`, an integer add) and, while spans
record, also charged to the innermost open span. The kernels' launches are
counters: `k1.launches`, `k1.merges` (K1 calls whose kv range was split, each
also launching the merge), `k1.kernel.<name>` (K1 calls by the CUDA kernel
launched), `k2.launches`, `k3.launches`, `k4.launches`, `k5.launches`. While the outermost span is open on
the card, `host_syncs` counts every device-to-host synchronisation, the
implicit ones of `nonzero`, boolean indexing or `.item()` inside library
code too: torch's CUDA sync debug mode warns at each, and the recorder
counts the warnings instead of showing them; the mode and the warning
handler are restored when that span closes. Explicit waits
(`torch.cuda.synchronize()`, `Event.synchronize()`) are not counted.

The last `MAX_REQUESTS` requests are kept, the oldest dropped first.
`records()` gives their closed spans, `reset()` forgets them.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import statistics
import time
import warnings

import torch
import torch.autograd.profiler as _autograd_profiler

# NVIDIA H100 SXM (80GB HBM3) peaks, from NVIDIA's data sheet, dense, at the
# 700 W power limit: a card set below it runs slower under load.
PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 and fp16
PEAK_F32_FLOPS = 67e12    # float32 outside the tensor cores
PEAK_TF32_FLOPS = 494.7e12  # tensor cores, TF32 (a float32 product in three TF32 passes takes three)
PEAK_BYTES = 3.35e12      # HBM3, bytes a second

RANGE_PREFIX = "gfnet."  # the profiler ranges of the spans
MAX_REQUESTS = 256
SYNC_WARNING = "synchronizing CUDA operation"  # in torch's sync debug mode's warning
SYNC_MODE_NOTE = "Synchronization debug mode is a prototype"  # torch's note each time the mode is set


class _Recorder:
    """The process's spans and counters (one instance, `_REC`)."""

    def __init__(self):
        self.on = False
        self.stack: list[_Span] = []  # open spans, outermost first
        self.requests: collections.deque = collections.deque()
        self.free_events: dict[int, list] = {}  # by device: pairs of timing events read or dropped, to reuse
        self.request = 0
        self.span_id = 0
        self.totals: dict[str, int] = {}
        self.syncs = None  # (saved sync debug mode, warning context) while the outermost span is open

    def open(self, s: "_Span") -> None:
        if not self.stack:
            self.request += 1
            if len(self.requests) == MAX_REQUESTS:
                self.release(self.requests.popleft())
            self.requests.append([])
            self._watch_syncs()
        self.span_id += 1
        s.id, s.request = self.span_id, self.request
        s.parent = self.stack[-1].id if self.stack else None
        s.end_ns = s.device_ms = s.counters = None
        s.range = _autograd_profiler.record_function(RANGE_PREFIX + s.name)
        s.range.__enter__()
        s.events = None
        if torch.cuda.is_initialized():
            s.device = torch.cuda.current_device()
            free = self.free_events.get(s.device)
            s.events = free.pop() if free else (torch.cuda.Event(enable_timing=True),
                                                torch.cuda.Event(enable_timing=True))
            s.events[0].record()
        self.stack.append(s)
        self.requests[-1].append(s)
        s.start_ns = time.perf_counter_ns()

    def close(self, s: "_Span") -> None:
        s.end_ns = time.perf_counter_ns()
        if s.events is not None:
            s.events[1].record()
        s.range.__exit__(None, None, None)
        s.range = None
        self.stack.remove(s)
        if not self.stack:
            self._unwatch_syncs()

    def release(self, spans: list) -> None:
        """Take back the events of `spans` that have closed."""
        for s in spans:
            if s.events is not None and s.end_ns is not None:
                self.free(s)

    def free(self, s: "_Span") -> None:
        self.free_events.setdefault(s.device, []).append(s.events)
        s.events = None

    def _watch_syncs(self) -> None:
        if not torch.cuda.is_initialized():
            return
        context = warnings.catch_warnings()
        context.__enter__()
        warnings.filterwarnings("always", message=".*" + SYNC_WARNING)
        warnings.filterwarnings("ignore", message=SYNC_MODE_NOTE)
        shown = warnings.showwarning

        def show(message, category, filename, lineno, file=None, line=None):
            if SYNC_WARNING in str(message):
                count("host_syncs")
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = show
        self.syncs = (torch.cuda.get_sync_debug_mode(), context)
        torch.cuda.set_sync_debug_mode("warn")

    def _unwatch_syncs(self) -> None:
        if self.syncs is None:
            return
        mode, context = self.syncs
        self.syncs = None
        torch.cuda.set_sync_debug_mode(mode)
        context.__exit__(None, None, None)


_REC = _Recorder()


class _Span:
    """A span that records: opened by `__enter__`, closed by `__exit__`."""

    __slots__ = ("name", "id", "request", "parent", "start_ns", "end_ns", "events", "device", "device_ms",
                 "counters", "range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        _REC.open(self)
        return self

    def __exit__(self, *exc) -> bool:
        _REC.close(self)
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _Idle:
    """A span while nothing records, one shared by each name: it does nothing
    on entry and exit; as a decorator, each call of the function looks again."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


class _IdleSpans(dict):
    def __missing__(self, name: str) -> _Idle:
        idle = self[name] = _Idle(name)
        return idle


_IDLE = _IdleSpans()


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if not (_REC.on or _autograd_profiler._is_profiler_enabled):
            return fn(*args, **kwargs)
        with _Span(name):
            return fn(*args, **kwargs)

    return spanned


def span(name: str):
    """One call of a layer, as `with span(name):` or `@span(name)`."""
    if _REC.on or _autograd_profiler._is_profiler_enabled:
        return _Span(name)
    return _IDLE[name]


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`, and to the innermost open span's."""
    totals = _REC.totals
    totals[name] = totals.get(name, 0) + n
    if _REC.stack:
        top = _REC.stack[-1]
        if top.counters is None:
            top.counters = {}
        top.counters[name] = top.counters.get(name, 0) + n


def enable() -> None:
    """Record spans from now on, profiler or not."""
    _REC.on = True


def disable() -> None:
    """Record spans only while a torch profiler records."""
    _REC.on = False


def recording() -> bool:
    return _REC.on or bool(_autograd_profiler._is_profiler_enabled)


def counters() -> dict[str, int]:
    """Every counter since the last `reset()`."""
    return dict(_REC.totals)


def reset(*prefixes: str) -> None:
    """Forget the kept requests and zero every counter; with `prefixes`, only
    zero the counters whose names start with one of them."""
    if prefixes:
        for name in [n for n in _REC.totals if n.startswith(prefixes)]:
            del _REC.totals[name]
        return
    for request in _REC.requests:
        _REC.release(request)
    _REC.requests.clear()
    _REC.totals.clear()


def records() -> list[dict]:
    """The closed spans of the kept requests, in the order they opened: name,
    `id`, `parent` (its id, None for the outermost), `request`, `start_ns`
    and `end_ns` (host), `host_ms`, `device_ms` (between its CUDA events;
    None where it ran off the card) and its own `counters`. Reading waits
    for the card to pass each span's end event."""
    out = []
    for request in _REC.requests:
        for s in request:
            if s.end_ns is None:
                continue
            if s.events is not None:
                s.events[1].synchronize()
                s.device_ms = s.events[0].elapsed_time(s.events[1])
                _REC.free(s)
            out.append({"name": s.name, "id": s.id, "parent": s.parent, "request": s.request,
                        "start_ns": s.start_ns, "end_ns": s.end_ns, "host_ms": (s.end_ns - s.start_ns) * 1e-6,
                        "device_ms": s.device_ms, "counters": dict(s.counters or {})})
    return out


def summarize(recs: list[dict], per: str = "call", prefix: str = "") -> dict:
    """Each span name of `recs` that starts with `prefix`: its host ms,
    device ms (None off the card) and `host_syncs` (its own and its
    children's), summed and divided by the number of `per` spans in `recs`."""
    n = sum(r["name"] == per for r in recs)
    if not n:
        return {}
    by_id = {r["id"]: r for r in recs}
    syncs = collections.Counter()
    for r in recs:
        k = r["counters"].get("host_syncs", 0)
        node = r
        while k and node is not None:
            syncs[node["id"]] += k
            node = by_id.get(node["parent"])
    out: dict = {}
    for r in recs:
        if not r["name"].startswith(prefix):
            continue
        s = out.setdefault(r["name"], {"host_ms": 0.0, "device_ms": 0.0, "host_syncs": 0.0})
        s["host_ms"] += r["host_ms"] / n
        s["host_syncs"] += syncs[r["id"]] / n
        if s["device_ms"] is not None:
            s["device_ms"] = None if r["device_ms"] is None else s["device_ms"] + r["device_ms"] / n
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the body with `torch.profiler` (CPU activity, and CUDA
    activity when a card is present) and write its Chrome trace to
    `logdir/trace.json`. Yields the profiler, whose `key_averages()` the
    caller may read after the body. The recorder records meanwhile."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync(out) -> None:
    """Wait for the card if any tensor of `out` (a tensor, or a tuple, list
    or dict of them) lies on it."""
    leaves = out.values() if isinstance(out, dict) else out if isinstance(out, (tuple, list)) else (out,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


def timed(fn, *args, iters: int = 10, warmup: int = 2) -> float:
    """Median wall seconds of one `fn(*args)`, the host's launch cost and
    the card's time together: each call ends when its result is ready."""
    for _ in range(warmup):
        _sync(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bound(ops: list, nbytes: float, exps: float = 0.0, exp_rate: float = 1.0) -> tuple[float, str]:
    """The least time in ms the card could take, and which term sets it:
    operations over their peak rate (`ops`: (count, rate) pairs, one for
    each operand type, whose times add), bytes over the memory rate, or
    exponentials over the special-function units' rate (`exp_rate` a second)."""
    terms = {"operations": sum(n / rate for n, rate in ops), "bytes": nbytes / PEAK_BYTES,
             "exponentials": exps / exp_rate}
    by = max(terms, key=terms.get)
    return 1e3 * terms[by], by
