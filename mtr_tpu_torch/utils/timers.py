"""Stage timers, counters and spans: the port's one observability surface.

Accumulators mirror the reference's wall-clock sections (mTR.h:142-143,
main.c:108-121) and add the device pipeline's phases; print_summary emits
the reference's -c lines first (same order and labels), then the port's.

Every duration is on time.perf_counter_ns(), a monotonic clock.
TIMERS.span(name, key) adds its seconds to the accumulator `name` and, when
given, to `key` (the -c sections).  While TIMERS.record() is in force, or
while torch's profiler runs, a span is also kept as a SpanRecord (name,
start and end, thread, the thread's role, batch id, parent), and under the
profiler it opens a profiler range of its name, to which device work
launched inside it is linked.  TIMERS.stop() hands the records over with
two (time.time_ns(), time.perf_counter_ns()) anchors, read when keeping
began and at the stop: the profiler's clock is time.time_ns(), so the
anchors put a record on the profiler's timeline.

Accumulators and counters change under one lock: threads that add to one
key come out exact.  With nothing kept, a span costs two clock reads, one
locked add and one test; it never imports torch.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import defaultdict


# the device DI group's traffic, counted by
# ops/directional_index.di_group_device on every device: output positions
# over a group's passes, the codes handed over (int32) and the int32
# outputs handed back (Manhattan one a position, Pearson five); -c prints
# them beside the DI lines
DI_COUNTERS = ("di_positions", "di_up_bytes", "di_down_bytes")


class SpanRecord:
    """One kept span; times in perf_counter_ns, `parent` the index of the
    enclosing span in the list stop() returns (None for a root)."""

    __slots__ = ("name", "start_ns", "end_ns", "tid", "role", "batch",
                 "parent")

    def __init__(self, name, start_ns, end_ns, tid, role, batch, parent):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.tid, self.role, self.batch, self.parent = tid, role, batch, parent

    def __repr__(self) -> str:
        return (f"SpanRecord({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"tid={self.tid}, role={self.role!r}, batch={self.batch}, "
                f"parent={self.parent})")


def _profiling() -> bool:
    """Whether torch's profiler runs (without importing torch)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


def _profiler_range(name: str):
    """A profiler range that device work launched inside it is linked to:
    the port launches its kernels through ctypes, which the profiler links
    to an open _RecordFunctionFast (not to record_function's user scope).
    Opened only while the profiler runs: one opened before it starts
    cannot be closed under it."""
    import torch

    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is None:
        return torch.autograd.profiler.record_function(name)
    return fast(name)


class _Thread(threading.local):
    """A thread's role, batch id, parent of its outermost kept span, and
    the kept spans open on it."""

    role = None
    batch = None
    root_parent = None

    def __init__(self):
        self.stack: list[SpanRecord] = []


class Span:
    """The context manager TIMERS.span returns; `seconds` holds its
    duration once it has closed."""

    __slots__ = ("_timers", "name", "key", "batch", "seconds", "_t0",
                 "_rec", "_range")

    def __init__(self, timers, name, key, batch):
        self._timers, self.name, self.key, self.batch = timers, name, key, batch
        self.seconds = 0.0
        self._rec = self._range = None

    def __enter__(self) -> "Span":
        tm = self._timers
        if tm._recording or _profiling():
            tm._open(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        self.seconds = dt = (t1 - self._t0) * 1e-9
        tm = self._timers
        with tm._lock:
            tm.t[self.name] += dt
            if self.key is not None:
                tm.t[self.key] += dt
        if self._rec is not None or self._range is not None:
            tm._close(self, t1)
        return False


class Timers:
    def __init__(self):
        self.t = defaultdict(float)
        self.counters = defaultdict(int)
        self._lock = threading.Lock()
        self._thread = _Thread()
        self._recording = False
        self._records: list[SpanRecord] = []
        self._anchor = None

    # -- accumulators and counters --------------------------------------
    def span(self, name: str, key: str | None = None,
             batch: int | None = None) -> Span:
        """A span named `name` (port spans start with "mtr."), added to the
        accumulators `name` and `key`; `batch` overrides the thread's
        batch id on its record."""
        return Span(self, name, key, batch)

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.t[name] += dt

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] += n

    def seconds(self, name: str) -> float:
        with self._lock:
            return self.t.get(name, 0.0)

    def snapshot(self) -> tuple[dict, dict]:
        """Copies of the accumulators and the counters."""
        with self._lock:
            return dict(self.t), dict(self.counters)

    # -- threads -----------------------------------------------------------
    @contextlib.contextmanager
    def thread(self, role: str, batch: int | None = None, parent=None):
        """Run the body as `role` ("reader", "walks", "stage_b",
        "dp_device") on batch `batch`; `parent` (another thread's
        current()) becomes the parent of this thread's outermost spans."""
        th = self._thread
        saved = th.role, th.batch, th.root_parent
        th.role, th.batch, th.root_parent = role, batch, parent
        try:
            yield
        finally:
            th.role, th.batch, th.root_parent = saved

    def role(self) -> str | None:
        return self._thread.role

    def batch(self) -> int | None:
        return self._thread.batch

    def set_batch(self, batch: int | None) -> None:
        self._thread.batch = batch

    def current(self) -> SpanRecord | None:
        """The innermost kept span open on this thread, to hand to a
        thread it starts."""
        th = self._thread
        return th.stack[-1] if th.stack else th.root_parent

    # -- records -----------------------------------------------------------
    def record(self) -> None:
        """Keep every span from now until stop()."""
        with self._lock:
            self._records = []
            self._anchor = (time.time_ns(), time.perf_counter_ns())
            self._recording = True

    def stop(self):
        """Stop keeping spans; returns (records, (start anchor, stop
        anchor)), each anchor a (time.time_ns(), perf_counter_ns()) pair.
        A span still open ends at the stop."""
        with self._lock:
            end = (time.time_ns(), time.perf_counter_ns())
            recs, start = self._records, self._anchor or end
            self._records, self._anchor = [], None
            self._recording = False
        index = {id(r): i for i, r in enumerate(recs)}
        out = [SpanRecord(r.name, r.start_ns, r.end_ns or end[1], r.tid,
                          r.role, r.batch, index.get(id(r.parent)))
               for r in recs]
        return out, (start, end)

    def _open(self, span: Span) -> None:
        th = self._thread
        rec = SpanRecord(span.name, 0, 0, threading.get_native_id(), th.role,
                         th.batch if span.batch is None else span.batch,
                         th.stack[-1] if th.stack else th.root_parent)
        with self._lock:
            if self._anchor is None:  # kept because the profiler runs
                self._anchor = (time.time_ns(), time.perf_counter_ns())
            self._records.append(rec)
        th.stack.append(rec)
        span._rec = rec
        if _profiling():
            span._range = _profiler_range(span.name)
            span._range.__enter__()
        rec.start_ns = time.perf_counter_ns()

    def _close(self, span: Span, t1: int) -> None:
        if span._rec is not None:
            span._rec.end_ns = t1
            stack = self._thread.stack
            if stack and stack[-1] is span._rec:
                stack.pop()
        if span._range is not None:
            span._range.__exit__(None, None, None)

    # -- -c ------------------------------------------------------------------
    def period_parts(self) -> tuple[float, float]:
        """"Computing periods" in its two parts: the walk thread's walks,
        and stage B less the walks of its extra waves."""
        t = self.t
        nested = t.get("period.nested_walks", 0.0)
        return (t.get("period.walks", 0.0),
                t.get("mtr.stage_b.batch", 0.0) - nested)

    def print_summary(self, out) -> None:
        t = self.t
        # the batched pipeline's phases mapped onto the reference's -c
        # lines (main.c:108-121): "Computing periods" = everything between
        # range detection and chaining, "wrap around" = the DP engines
        period = sum(self.period_parts())
        wrap_dp = (t.get("dp_fill", 0.0) + t.get("dp_dispatch", 0.0)
                   + t.get("dp_wait", 0.0))
        count_table = t.get("count_table") or t.get("walks", 0.0)
        out.write("Computation time\n")
        out.write(f"{t.get('all', 0.0):f}\tall\n")
        out.write(f"{t.get('memory', 0.0):f}\tallocating memory\n")
        out.write(f"{t.get('range', 0.0):f}\tranges\n")
        out.write(f"{period:f}\tComputing periods\n")
        out.write(f"\t{t.get('initialize', 0.0):f}\tInitialize the input\n")
        out.write(f"\t{count_table:f}\tcount table generation\n")
        out.write(f"\t{wrap_dp:f}\twrap around\n")
        out.write(f"\t{t.get('chaining', 0.0):f}\tchaining\n")
        out.write(f"\t{self.counters.get('queries', 0)}\tCount of queries\n")
        # framework extensions: the DI's lines and its group traffic, then
        # the other phases and every other counter
        di = [(k, lbl) for k, lbl in (
            ("di_device", "DI stencil"),
            ("mtr.di.stage", "DI stencil: codes into pinned memory"),
            ("mtr.di.wait", "DI stencil: wait for upload, launch, copy back"),
            ("mtr.di.widen", "DI stencil: int32 outputs widened"),
            ("mtr.di.finish", "DI stencil: host float64 finish"),
            ("mtr.di.pair", "DI pairing of a k's passes"),
        ) if t.get(k)]
        extras = [
            ("walks", "DBG walks (native)"),
            ("walk_kernel", "device walk launches + pull"),
            ("walk_host_route", "device walks' host route"),
            ("dp_fill", "wrap-DP host engine"),
            ("dp_dispatch", "wrap-DP device dispatch"),
            ("dp_wait", "wrap-DP device wait + pull"),
            ("polish", "polish/revision rounds"),
        ]
        shown = [(k, lbl) for k, lbl in extras if t.get(k)]
        di_counters = [(k, self.counters[k]) for k in DI_COUNTERS
                       if self.counters.get(k)]
        counters = sorted((k, v) for k, v in self.counters.items()
                          if k != "queries" and k not in DI_COUNTERS)
        if di or shown or di_counters or counters:
            out.write("Device pipeline phases\n")
            for k, lbl in di:
                out.write(f"\t{t[k]:f}\t{lbl}\n")
            for k, v in di_counters:
                out.write(f"\t{v}\t{k}\n")
            for k, lbl in shown:
                out.write(f"\t{t[k]:f}\t{lbl}\n")
            for k, v in counters:
                out.write(f"\t{v}\t{k}\n")
        spans = sorted(k for k in t if k.startswith("mtr."))
        if spans:
            walks, stage_b = self.period_parts()
            out.write("Spans (seconds summed over threads)\n")
            out.write(f"\t{walks:f}\tComputing periods: the walk thread\n")
            out.write(f"\t{stage_b:f}\tComputing periods: stage B\n")
            for k in spans:
                out.write(f"\t{t[k]:f}\t{k}\n")


TIMERS = Timers()
