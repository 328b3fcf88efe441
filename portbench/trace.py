"""The traced run's instrumentation: ranges the benchmark puts around the
port's layers, the work each kernel range is handed, and the reduction
of a torch.profiler trace to device busy time, idle gaps and the device
time inside each range.

Installed only in a `--trace 1` run.  The wrappers keep counts, never
tensors.  A range named "<layer>#<n>" carries work[n], the (ops, bytes)
counted from the op's inputs; its device time is every kernel, copy and
set launched from inside it (by the profiler's link from a device
activity to the host op open around its launch, on that op's thread), so
a later change that replaces or splits a kernel reads against the same
work.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time
from collections import defaultdict

from portbench import roofline

@contextlib.contextmanager
def host_range(label):
    """A profiler range that the device work launched inside it is linked
    to.  torch's record_function is a user scope, which the profiler does
    not link a launch to unless an ATen op is open around it, and the
    port launches its kernels through ctypes; _RecordFunctionFast (what
    torch's own compiler puts around its kernel launches) is linked.  It
    is opened only while the profiler runs, as torch's compiler does:
    one opened before the profiler starts cannot be closed under it."""
    import torch
    from torch.autograd import profiler

    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if not profiler._is_profiler_enabled:
        yield
    elif fast is None:
        with profiler.record_function(label):
            yield
    else:
        with fast(label):
            yield


# host ranges, in the order the breakdown names a gap by them
RANGES = ("bench.counts", "bench.consensus", "bench.di_device", "bench.stage_a",
          "bench.walks", "bench.stage_b", "bench.di")


class Instruments:
    """Wrappers around the port's entry points; spans on the host clock
    (time.perf_counter) and per-range work."""

    def __init__(self):
        self.work: dict[int, tuple[str, int, int]] = {}
        self.spans: list[tuple[str, float, float, bool]] = []
        self._seq = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._undo: list = []

    # -- patching -------------------------------------------------------
    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        setattr(owner, name, make(orig))
        self._undo.append((owner, name, orig))

    def uninstall(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    @contextlib.contextmanager
    def _range(self, label, work=None):
        if work is not None:
            n = next(self._seq)
            with self._lock:
                self.work[n] = (label, *work)
            label = f"{label}#{n}"
        with host_range(label):
            yield

    def _span(self, name, fn):
        inst = self

        def wrapped(*a, **kw):
            nested = getattr(inst._local, "in_stage_b", False)
            if name == "bench.stage_b":
                inst._local.in_stage_b = True
            t0 = time.perf_counter()
            try:
                with inst._range(name):
                    return fn(*a, **kw)
            finally:
                t1 = time.perf_counter()
                if name == "bench.stage_b":
                    inst._local.in_stage_b = False
                with inst._lock:
                    inst.spans.append((name, t0, t1, nested))
        return wrapped

    def install(self, pipeline, dbg_device):
        inst = self
        self._patch(pipeline, "fill_directional_index_with_end",
                    lambda f: self._span("bench.di", f))
        self._patch(pipeline, "walk_batch", lambda f: self._span("bench.walks", f))
        self._patch(pipeline, "process_batch", lambda f: self._span("bench.stage_b", f))
        self._patch(dbg_device, "stage_a", lambda f: self._span("bench.stage_a", f))

        def make_di(orig):
            def make_di_compute_k(device, manhattan):
                inner = orig(device, manhattan)

                def di_compute_k(buf, di_len, ws, k, rsl):
                    passes = roofline.di_passes(di_len, ws, k, rsl, manhattan)
                    with inst._range("bench.di_device",
                                     roofline.di_work(passes, manhattan)):
                        return inner(buf, di_len, ws, k, rsl)
                return di_compute_k
            return make_di_compute_k
        self._patch(pipeline, "make_di_compute_k", make_di)

        def launch(orig):
            def _launch(batcher, mode, starts, scal, units, u_span, factor):
                # the host scal handed to the op, counted before the launch
                inst._local.work = (roofline.counts_work(scal) if mode == "counts"
                                    else roofline.consensus_work(scal))
                return orig(batcher, mode, starts, scal, units, u_span, factor)
            return _launch
        self._patch(pipeline.TorchDPBatcher, "_launch", launch)

        def op(label):
            def make(orig):
                def wrapped(*a, **kw):
                    with inst._range(label, getattr(inst._local, "work", None)):
                        return orig(*a, **kw)
                return wrapped
            return make
        self._patch(pipeline, "wrap_dp_counts", op("bench.counts"))
        self._patch(pipeline, "wrap_dp_consensus", op("bench.consensus"))

    def span_seconds(self, name, lo, hi, nested=None) -> float:
        """Seconds of `name` spans inside [lo, hi] (clipped)."""
        with self._lock:
            spans = list(self.spans)
        return sum(max(0.0, min(t1, hi) - max(t0, lo)) for n, t0, t1, nest in spans
                   if n == name and (nested is None or nest == nested))


def _merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """A profiler trace reduced to what the per-layer metrics read.

    `events` are (kind, name, start_ns, end_ns, thread, corr, linked):
    kind "cpu" for host ops and ranges, "dev" for kernels, copies and
    sets on the card.  [lo_ns, hi_ns] is the profiled span."""

    def __init__(self, events, lo_ns, hi_ns, work):
        self.lo, self.hi = lo_ns, hi_ns
        self.work = work
        cpu = [e for e in events if e[0] == "cpu"]
        dev = [e for e in events if e[0] == "dev" and e[3] > lo_ns and e[2] < hi_ns]
        self.dev = dev
        busy = _merge((max(e[2], lo_ns), min(e[3], hi_ns)) for e in dev)
        self.busy_ns = sum(e - s for s, e in busy)
        self.window_ns = hi_ns - lo_ns
        # gaps between device activity inside the span
        edges = [lo_ns] + [x for iv in busy for x in iv] + [hi_ns]
        self.gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                     if edges[i + 1] > edges[i]]
        # benchmark ranges, by thread, and the host op each device event came from
        self.ranges = [e for e in cpu if e[1].startswith("bench.")]
        by_thread = defaultdict(list)
        for r in self.ranges:
            by_thread[r[4]].append(r)
        self._threads = {}
        for t, rs in by_thread.items():
            rs.sort(key=lambda r: (r[2], -r[3]))
            # depth 0 marks a range no earlier range of its thread holds
            top, depth0 = -1, []
            for r in rs:
                depth0.append(r[2] >= top)
                top = max(top, r[3])
            self._threads[t] = (rs, [r[2] for r in rs], depth0)
        op_of = {}
        for e in cpu:
            if e[5] is not None:
                op_of[e[5]] = e
        self.range_dev_ns: dict[str, int] = defaultdict(int)
        self.unattributed_dev_ns = 0
        for d in dev:
            host = op_of.get(d[6])
            r = self._enclosing(host) if host is not None else None
            if not r:
                self.unattributed_dev_ns += d[3] - d[2]
                continue
            for name in r:
                self.range_dev_ns[name] += d[3] - d[2]

    def _enclosing(self, host):
        """Names of every benchmark range on the host op's thread that
        holds it (the op itself when it is a range).  Ranges of one thread
        nest, so the walk back stops at the first outermost range that
        ended before the op began."""
        rs, starts, depth0 = self._threads.get(host[4], ((), (), ()))
        out = []
        i = bisect.bisect_right(starts, host[2]) - 1
        while i >= 0:
            r = rs[i]
            if r[3] >= host[3]:
                out.append(r[1])
            elif depth0[i] and r[3] < host[2]:
                break
            i -= 1
        return out

    def roofline(self, label: str):
        """(least seconds, device seconds, bound counts) summed over the
        `label` ranges recorded whole in the span, or None."""
        least = dev = 0.0
        bounds = defaultdict(int)
        for r in self.ranges:
            name = r[1]
            if not name.startswith(label + "#") or r[2] < self.lo or r[3] > self.hi:
                continue
            n = int(name.split("#", 1)[1])
            if n not in self.work:
                continue
            _label, ops, n_bytes = self.work[n]
            t, bound = roofline.least_s(ops, n_bytes)
            d = self.range_dev_ns.get(name, 0) * 1e-9
            if d <= 0:
                continue
            least += t
            dev += d
            bounds[bound] += 1
        if dev <= 0:
            return None
        return least, dev, dict(bounds)

    def device_ops(self, top=10):
        tot = defaultdict(int)
        for d in self.dev:
            tot[d[1]] += min(d[3], self.hi) - max(d[2], self.lo)
        return [[n[:120], v * 1e-9] for n, v in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top=10):
        """The longest idle gaps, each named by the benchmark ranges open
        on the host at its middle ("host outside the ranges" if none)."""
        out = []
        for s, e in sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = (s + e) // 2
            names = sorted({r[1].split("#", 1)[0] for r in self.ranges
                            if r[2] <= mid <= r[3]}, key=RANGES.index)
            out.append([" + ".join(names) or "host outside the ranges", (e - s) * 1e-9])
        return out


# activities on the card that occupy it (kineto's names); its copies of
# the host ranges ("gpu_user_annotation") are not work
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def kineto_events(prof):
    """The profiler's events as TraceSummary tuples, and a count of the
    activity types seen (a run prints it beside the trace's numbers).

    Where the profiler does not name an event's activity type (older
    torch), a device event that bears the name of a host range is that
    range's copy on the card's timeline, not work."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    typed = bool(raw) and hasattr(raw[0], "activity_type")
    ranges = set()
    if not typed:
        for e in raw:
            if e.device_type() == DeviceType.CPU and (
                    e.name().startswith("bench.")
                    or getattr(e, "is_user_annotation", lambda: False)()):
                ranges.add(e.name())
    out = []
    kinds: dict[str, int] = defaultdict(int)
    for e in raw:
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            kinds["host"] += 1
            out.append(("cpu", e.name(), start, end, e.start_thread_id(),
                        e.correlation_id(), None))
            continue
        kind = (e.activity_type() if typed else
                "range copy" if e.name() in ranges else "device work")
        kinds[kind] += 1
        if kind in DEVICE_ACTIVITIES or kind == "device work":
            out.append(("dev", e.name(), start, end, None, None,
                        e.linked_correlation_id()))
    return out, dict(kinds)


def summarize(events, lo_ns, hi_ns, work) -> TraceSummary:
    return TraceSummary(events, lo_ns, hi_ns, work)

