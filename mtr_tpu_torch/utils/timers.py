"""Stage timers — the -c observability surface.

Mirrors the reference's wall-clock accumulators (mTR.h:142-143,
main.c:108-121) and adds device-pipeline phases.  print_summary emits
the reference's stderr lines first (same order/labels) followed by
framework extensions.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class Timers:
    def __init__(self):
        self.t = defaultdict(float)
        self.counters = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str):
        s = time.time()
        try:
            yield
        finally:
            self.t[name] += time.time() - s

    def add(self, name: str, dt: float) -> None:
        self.t[name] += dt

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] += n

    def print_summary(self, out) -> None:
        t = self.t
        # the batched pipeline records phase timers; map them onto the
        # reference's -c lines (main.c:108-121): "Computing periods" =
        # everything between range detection and chaining, "wrap around"
        # = the DP engine (fill + traceback), walks ≈ count tables + DBG
        period = t["period"] or (
            t["walks"] + t["dp_fill"] + t["dp_dispatch"] + t["dp_wait"]
            + t["dp_traceback"] + t["polish"]
        )
        wrap_dp = t["wrap_dp"] or (
            t["dp_fill"] + t["dp_dispatch"] + t["dp_wait"]
            + t["dp_traceback"]
        )
        count_table = t["count_table"] or t["walks"]
        out.write("Computation time\n")
        out.write(f"{t['all']:f}\tall\n")
        out.write(f"{t['memory']:f}\tallocating memory\n")
        out.write(f"{t['range']:f}\tranges\n")
        out.write(f"{period:f}\tComputing periods\n")
        out.write(f"\t{t['initialize']:f}\tInitialize the input\n")
        out.write(f"\t{count_table:f}\tcount table generation\n")
        out.write(f"\t{wrap_dp:f}\twrap around\n")
        out.write(f"\t{t['chaining']:f}\tchaining\n")
        out.write(f"\t{self.counters['queries']}\tCount of queries\n")
        # framework extensions
        extras = [
            ("di_device", "DI stencil"),
            ("walks", "DBG walks (native)"),
            ("dp_fill", "wrap-DP host engine"),
            ("dp_dispatch", "wrap-DP device dispatch"),
            ("dp_wait", "wrap-DP device wait + pull"),
            ("dp_traceback", "device traceback + pull"),
            ("dp_pad", "DP batch padding"),
            ("polish", "polish/revision rounds"),
            ("compile", "kernel compiles"),
        ]
        shown = [(k, lbl) for k, lbl in extras if t.get(k)]
        if shown:
            out.write("Device pipeline phases\n")
            for k, lbl in shown:
                out.write(f"\t{t[k]:f}\t{lbl}\n")
            for k, v in sorted(self.counters.items()):
                if k != "queries":
                    out.write(f"\t{v}\t{k}\n")


TIMERS = Timers()
