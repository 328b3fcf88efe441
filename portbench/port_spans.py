"""The port's own spans in a traced run: what mtr_tpu_torch.utils.timers
keeps while torch's profiler runs (the window's second half), moved onto
the profiler's clock by the recorder's anchors, clipped to the profiled
span, summed by role and name, and laid over the card's idle gaps.

A program without the recorder keeps nothing: take() returns None and
report() logs nothing.  The per-layer metrics that read the port's spans
read its accumulators (ctx.timers, over the whole window); report() adds
the logged lines: each role's coverage by its phases, the seconds and
self seconds of each span, and the idle gaps named by the port's spans
(idle_by_port_span).
"""

from __future__ import annotations

import bisect
import json
import sys
from collections import defaultdict, namedtuple

Span = namedtuple("Span", "name start_ns end_ns tid role batch parent")

ROLES = ("reader", "walks", "stage_b", "dp_device")
# the span a stage thread opens for each batch; the reader has none
ROOTS = {"walks": "mtr.walk.batch", "stage_b": "mtr.stage_b.batch",
         "dp_device": "mtr.dp.device_leg"}


def take(timers=None):
    """(spans, anchors) the port kept, which it hands over once, or None
    where the program keeps no spans."""
    if timers is None:
        from mtr_tpu_torch.utils import timers as mod

        timers = mod.TIMERS
    if not hasattr(timers, "record") or not hasattr(timers, "stop"):
        return None
    return timers.stop()


def on_profiler_clock(spans, anchors) -> list[Span]:
    """Spans with their times moved from perf_counter_ns to the profiler's
    clock (time.time_ns()): the offset between the two clocks read at the
    anchors, interpolated between them."""
    (w0, p0), (w1, p1) = anchors
    off0, off1 = w0 - p0, w1 - p1

    def conv(t):
        if p1 == p0:
            return t + off0
        return t + off0 + round((off1 - off0) * (t - p0) / (p1 - p0))

    return [Span(s.name, conv(s.start_ns), conv(s.end_ns), s.tid, s.role,
                 s.batch, s.parent) for s in spans]


def clip(s, lo, hi) -> int:
    """Nanoseconds of span s inside [lo, hi]."""
    return max(0, min(s.end_ns, hi) - max(s.start_ns, lo))


def sums(spans, lo, hi) -> dict:
    """{(role, name): (seconds, self seconds)} inside [lo, hi]; self
    seconds leave out the span's children on its thread."""
    total = defaultdict(int)
    inner = defaultdict(int)
    for s in spans:
        ns = clip(s, lo, hi)
        total[(s.role, s.name)] += ns
        if s.parent is not None and spans[s.parent].tid == s.tid:
            p = spans[s.parent]
            inner[(p.role, p.name)] += ns
    return {k: (v * 1e-9, (v - inner[k]) * 1e-9) for k, v in total.items()}


def coverage(spans, lo, hi) -> dict:
    """{role: (covered s, total s)} inside [lo, hi]: a stage thread's
    batch spans (ROOTS) and the share their children cover; the reader's
    spans over the span from its first kept span to hi (a span open when
    keeping began is not kept)."""
    kids = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            kids[s.parent] += clip(s, lo, hi)
    out = {}
    for role, root in ROOTS.items():
        total = covered = 0
        for i, s in enumerate(spans):
            if s.role == role and s.name == root:
                total += clip(s, lo, hi)
                covered += kids[i]
        if total:
            out[role] = (covered * 1e-9, total * 1e-9)
    reader = [s for s in spans if s.role == "reader" and (
        s.parent is None or spans[s.parent].role != "reader")]
    if reader:
        first = max(lo, min(s.start_ns for s in reader))
        out["reader"] = (sum(clip(s, first, hi) for s in reader) * 1e-9,
                         max(0, hi - first) * 1e-9)
    return out


class Timeline:
    """One role's spans, which nest in time (a role's threads run one
    after another), for the innermost span open at a time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: (s.start_ns, -s.end_ns))
        self.starts = [s.start_ns for s in self.spans]
        # top[i]: no earlier span holds span i
        self.top, end = [], None
        for s in self.spans:
            self.top.append(end is None or s.start_ns >= end)
            end = s.end_ns if end is None else max(end, s.end_ns)

    def innermost(self, t):
        """The latest-starting span open at t, or None.  The walk back
        stops at the first outermost span that ended before t."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0:
            s = self.spans[i]
            if s.end_ns >= t:
                return s
            if self.top[i]:
                return None
            i -= 1
        return None


def idle_by_port_span(gaps, spans, top=10) -> list:
    """Each idle gap's seconds summed under the innermost port span open
    on each role at the gap's middle, named "role:span" ("no port span"
    where none is), the `top` largest first."""
    lines = {role: Timeline([s for s in spans if s.role == role])
             for role in ROLES}
    out = defaultdict(float)
    for s, e in gaps:
        mid = (s + e) // 2
        named = False
        for role in ROLES:
            sp = lines[role].innermost(mid)
            if sp is not None:
                out[f"{role}:{sp.name}"] += (e - s) * 1e-9
                named = True
        if not named:
            out["no port span"] += (e - s) * 1e-9
    return [[k, v] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:top]]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def report(ctx, timers=None) -> None:
    """Log, once a run, the port's spans over the profiled span: each
    role's coverage, each span's seconds and self seconds, and the idle
    gaps by port span; and the port's span seconds a read over the
    window."""
    if getattr(ctx, "port_spans_reported", False):
        return
    ctx.port_spans_reported = True
    timers_s = getattr(ctx, "timers", None) or {}
    per_read = {k: ctx.per_read(v) for k, v in sorted(timers_s.items())
                if k.startswith("mtr.")}
    if per_read:
        log("portbench: port span seconds a read over the window "
            + json.dumps(per_read))
    if getattr(ctx, "trace", None) is None:
        return
    taken = take(timers)
    if taken is None:
        return
    spans = on_profiler_clock(*taken)
    lo, hi = ctx.trace.lo, ctx.trace.hi
    log(f"portbench: {len(spans)} port spans kept over the profiled "
        f"{(hi - lo) * 1e-9:.3f} s")
    for role, (cov, tot) in sorted(coverage(spans, lo, hi).items()):
        if tot <= 0:
            continue
        what = (f"children of {ROOTS[role]}" if role in ROOTS else
                "its spans, from its first kept span")
        log(f"portbench: port span coverage {role} {100 * cov / tot:.2f}% "
            f"({cov:.6f} of {tot:.6f} s: {what})")
    table = sums(spans, lo, hi)
    log("portbench: port spans over the profiled span (role, name, s, self s) "
        + json.dumps(sorted([r, n, v[0], v[1]] for (r, n), v in table.items())))
    log("portbench: idle_by_port_span "
        + json.dumps(idle_by_port_span(ctx.trace.gaps, spans)))
