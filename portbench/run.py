"""Run one cell of mtr_tpu_torch's benchmark once, on the card it starts on.

    python3 -m portbench.run --workload device.long-200x200 --seed 7 \\
        --seconds 30 --trace 0

Set-up: the cell's reads are drawn from --seed by the generator its
traffic file names; one batch of its own reads (another draw) goes
through the port's entry, mtr_tpu_torch.pipeline.run_file, to warm up.
The window: run_file reads one FASTA from a pipe that a feeder thread
fills from the pool at whatever pace the port reads (a closed loop, like
a user's file), with the configuration's batching.  At --seconds the
feeder stops; the reads the port already took finish and are checked,
but only the reads whose records were written inside the window count.

--trace 0 prints the cell's end-to-end metrics; --trace 1 installs the
benchmark's ranges around the port's layers, profiles the second half of
the window with torch.profiler and prints the per-layer metrics.  The
last line of standard output is one JSON object; the numbers compared
with their limits are the last lines of standard error and the last key
of that object.  Exits 1, printing no result, without a CUDA card (or
with fewer than the cell asks for), or if jax, jaxlib, flax or mtr_tpu
is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import select  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "mtr_tpu")
PROFILE_FROM = 0.5      # the profiler covers the window's second half
JOIN_AFTER_CLOSE_S = 60.0


def forbidden_loaded(names=None) -> list[str]:
    """Forbidden top-level packages among module names, compared whole
    (mtr_tpu_torch is not mtr_tpu)."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))


def fixed_cache_dirs(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port builds its own libraries under build/mtr_tpu_torch)."""
    base = os.path.join(os.path.abspath(root), "build", "portbench")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


class LineSink:
    """The port's output stream: keeps the record lines of the read being
    written until read_meta hands them to that read."""

    def __init__(self):
        self.pending: list[str] = []

    def write(self, s: str) -> int:
        self.pending.append(s)
        return len(s)

    def flush(self) -> None:
        pass

    def take(self) -> list[str]:
        out = "".join(self.pending).splitlines()
        self.pending.clear()
        return out


class Feeder(threading.Thread):
    """Writes the pool's records into a FIFO, in order and round again if
    the port reads them all, until stop() (after the record being
    written), or abandon() (at once: the port no longer reads)."""

    def __init__(self, path: str, records: list[bytes]):
        super().__init__(daemon=True)
        self.path, self.records = path, records
        self.fed = 0
        self._halt = threading.Event()
        self._abandon = threading.Event()

    def stop(self) -> None:
        self._halt.set()

    def abandon(self) -> None:
        self._abandon.set()
        self._halt.set()

    def run(self) -> None:
        fd = os.open(self.path, os.O_WRONLY)
        try:
            os.set_blocking(fd, False)
            n = len(self.records)
            while not self._halt.is_set():
                if self.fed == n:
                    log(f"portbench: the pool of {n} reads ran out inside the "
                        "window; the feeder goes round it again")
                view = memoryview(self.records[self.fed % n])
                while view:
                    if self._abandon.is_set():
                        return
                    select.select([], [fd], [], 0.05)
                    try:
                        view = view[os.write(fd, view):]
                    except BlockingIOError:
                        continue
                    except BrokenPipeError:
                        return
                self.fed += 1
        finally:
            os.close(fd)


def snapshot_timers(timers):
    """Copies of the port's timer and counter dicts (other threads may
    add keys while they are read)."""
    while True:
        try:
            return dict(timers.t), dict(timers.counters)
        except RuntimeError:
            continue


def cpu_seconds() -> float:
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def make_config(cfg_file: dict):
    from mtr_tpu_torch.config import MTRConfig

    return MTRConfig(**cfg_file["mtr_config"])


class Window:
    """One run of the port's entry over the pool, closed after `seconds`."""

    def __init__(self, run_file, cfg, records, seconds, batcher=None,
                 profiler=None, timers=None):
        self.run_file, self.cfg = run_file, cfg
        self.records, self.seconds = records, seconds
        self.batcher, self.profiler, self.timers = batcher, profiler, timers
        self.program: dict[int, list[str]] = {}
        self.ranges: dict[int, tuple] = {}
        self.emitted: list[float] = []
        self.error: BaseException | None = None
        self.sink = LineSink()

    def _read_meta(self, ridx: int, n: int) -> None:
        lines = self.sink.take()
        if len(lines) != n:
            raise RuntimeError(f"read {ridx}: {len(lines)} lines for {n} records")
        self.program[ridx] = lines
        self.emitted.append(time.perf_counter())

    def _work(self, path):
        try:
            self.run_file(path, self.cfg, self.sink, read_meta=self._read_meta,
                          batcher=self.batcher)
        except BaseException as e:  # reported by run()
            self.error = e

    def capture_ranges(self, pipeline):
        """Keep each read's DI candidate ranges (check.di_ranges) as the
        port's DI returns them: run_file computes them read by read, in
        file order, on its own thread.  Returns the undo."""
        from portbench import check

        orig = pipeline.fill_directional_index_with_end

        def fill(arena, input_len, rsl, *a, **kw):
            out = orig(arena, input_len, rsl, *a, **kw)
            self.ranges[len(self.ranges)] = check.di_ranges(*out, input_len)
            return out

        pipeline.fill_directional_index_with_end = fill
        return lambda: setattr(pipeline, "fill_directional_index_with_end", orig)

    def run(self, tmpdir: str) -> dict:
        path = os.path.join(tmpdir, "window.fasta")
        os.mkfifo(path)
        feeder = Feeder(path, self.records)
        work = threading.Thread(target=self._work, args=(path,), daemon=True)
        before = snapshot_timers(self.timers) if self.timers else None
        cpu0 = cpu_seconds()
        t0_wall = time.time()
        t0 = time.perf_counter()
        feeder.start()
        work.start()
        if self.profiler is not None:
            time.sleep(max(0.0, t0 + PROFILE_FROM * self.seconds - time.perf_counter()))
            self.profiler.start()
            self.profiler.mark("bench.profile_start")
            log(f"portbench: profiler on {time.perf_counter() - t0:.3f} s into the window")
        time.sleep(max(0.0, t0 + self.seconds - time.perf_counter()))
        t_close = time.perf_counter()
        feeder.stop()
        cpu1 = cpu_seconds()
        after = snapshot_timers(self.timers) if self.timers else None
        if self.profiler is not None:
            self.profiler.mark("bench.profile_end")
            self.profiler.stop()
        work.join(JOIN_AFTER_CLOSE_S)
        if work.is_alive():
            self.error = self.error or TimeoutError(
                f"the port had not finished {JOIN_AFTER_CLOSE_S:.0f} s after the close")
        feeder.abandon()
        # a feeder still waiting for a reader to open the pipe
        os.close(os.open(path, os.O_RDONLY | os.O_NONBLOCK))
        feeder.join(10)
        os.unlink(path)
        n_in = sum(1 for t in self.emitted if t <= t_close)
        return {
            "t0_wall": t0_wall, "t0": t0, "t_close": t_close,
            "reads_in_window": n_in, "reads_done": len(self.program),
            "fed": feeder.fed, "cpu_s": cpu1 - cpu0,
            "timers_before": before, "timers_after": after,
        }


class Profiler:
    """torch.profiler over every thread (the port's stages run in threads
    of their own), kept in memory; mark() records a named instant on the
    profiler's own clock."""

    def __init__(self, torch):
        self.prof = self._make(torch)
        # the first profiler of a process takes seconds to start: start
        # and stop one in set-up, so the window's starts at once
        warm = self._make(torch)
        warm.start()
        warm.stop()

    @staticmethod
    def _make(torch):
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts, record_shapes=False,
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))

    def start(self):
        self.prof.start()

    def stop(self):
        self.prof.stop()

    @staticmethod
    def mark(name: str) -> None:
        from portbench.trace import host_range

        with host_range(name):
            pass


def trace_bounds(events, lo_name, hi_name):
    lo = [e[2] for e in events if e[0] == "cpu" and e[1] == lo_name]
    hi = [e[3] for e in events if e[0] == "cpu" and e[1] == hi_name]
    return (lo[0] if lo else min(e[2] for e in events),
            hi[-1] if hi else max(e[3] for e in events))


class Context:
    """What a per-layer metric reader gets."""

    def __init__(self, reads, seconds, setup_s, window, instruments, summary):
        self.reads, self.seconds, self.setup_s = reads, seconds, setup_s
        self.cpu_s = window["cpu_s"]
        t0, c0 = window["timers_before"] or ({}, {})
        t1, c1 = window["timers_after"] or ({}, {})
        self.timers = {k: t1.get(k, 0.0) - t0.get(k, 0.0) for k in set(t0) | set(t1)}
        self.counters = {k: c1.get(k, 0) - c0.get(k, 0) for k in set(c0) | set(c1)}
        self.instruments = instruments
        self.window = window
        self.trace = summary

    def per_read(self, seconds):
        return seconds / self.reads if self.reads else None

    def span_s(self, name, nested=None):
        if self.instruments is None:
            return None
        return self.instruments.span_seconds(
            name, self.window["t0"], self.window["t_close"], nested)


def warmup_count(traffic: dict, cfg, read_len: int) -> int:
    """Reads that make one batch under the configuration's batching."""
    by_bases = -(-cfg.bases_per_batch // max(read_len, 1))
    return max(1, min(cfg.reads_per_batch, by_bases))


def run_cell(args, root=".", require_cuda=True, batcher=None, fault=None) -> tuple[int, dict | None]:
    """One run; returns (exit code, result).  Tests call it with
    require_cuda=False, a CPU batcher and a `fault(pipeline)` that breaks
    the timed path underneath."""
    from portbench import check, manifest

    man = manifest.Manifest(root)
    cell = man.cell(args.workload)
    cfg_file = man.config(cell)
    traffic = man.traffic(cell)

    import torch

    if require_cuda:
        if not torch.cuda.is_available():
            log("portbench: torch.cuda.is_available() is false: no CUDA card")
            return 1, None
        if torch.cuda.device_count() < cell["chips"]:
            log(f"portbench: {cell['name']} needs {cell['chips']} cards, "
                f"torch sees {torch.cuda.device_count()}")
            return 1, None
        torch.cuda.init()

    gen = man.generator(traffic)
    params = traffic["params"]
    read_len = gen.read_length(params)
    pool = gen.fasta_records(params, args.seed, traffic["pool_reads"], 0, "r")
    from mtr_tpu_torch import pipeline
    from mtr_tpu_torch.ops import dbg_device
    from mtr_tpu_torch.utils.timers import TIMERS

    cfg = make_config(cfg_file)
    warm = gen.fasta_records(params, args.seed, warmup_count(traffic, cfg, read_len), 2, "w")

    instruments = summary = prof = None
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        warm_path = os.path.join(tmp, "warmup.fasta")
        with open(warm_path, "wb") as f:
            f.writelines(warm)
        pipeline.run_file(warm_path, cfg, LineSink(), batcher=batcher)
        os.unlink(warm_path)
        if require_cuda:
            torch.cuda.synchronize()
        if args.trace:
            from portbench import trace

            instruments = trace.Instruments()
            instruments.install(pipeline, dbg_device)
            prof = Profiler(torch)
        if fault is not None:
            fault(pipeline)
        win = Window(pipeline.run_file, cfg, pool, args.seconds, batcher=batcher,
                     profiler=prof, timers=TIMERS)
        undo = win.capture_ranges(pipeline)
        try:
            w = win.run(tmp)
        finally:
            undo()
    setup_s = w["t0_wall"] - T_START
    if instruments is not None:
        instruments.uninstall()
    found = forbidden_loaded()
    if found:
        log(f"portbench: forbidden modules loaded in this process: {', '.join(found)}")
        return 1, None
    mem_peak = (max(torch.cuda.max_memory_allocated(d) for d in range(cell["chips"]))
                if require_cuda else 0)
    if args.trace:
        from portbench import trace

        t_trace = time.time()
        events, kinds = trace.kineto_events(prof.prof)
        log(f"portbench: profiler activities {kinds}")
        lo, hi = trace_bounds(events, "bench.profile_start", "bench.profile_end")
        summary = trace.summarize(events, lo, hi, instruments.work)
        log(f"portbench: {len(events)} profiler events reduced in {time.time() - t_trace:.1f} s")
        del events
        prof = None
    if w["fed"] > len(pool):
        log(f"portbench: the window read {w['fed']} records from a pool of {len(pool)}")

    # what decides `correct`: the window's records against the reference
    n_done = w["reads_done"]
    lengths = [read_len] * n_done
    sample = check.sample_reads(n_done, lengths, traffic["check_reads"], args.seed)
    n_pool = len(pool)

    def sequence(i):
        return pool[i % n_pool]

    error = win.error
    t_ref = time.time()
    bad, bad_di = check.compare(win.program, win.ranges, sequence, sample,
                                      cfg.manhattan_distance)
    ref_s = time.time() - t_ref
    mismatched = len(bad) + (len(sample) == 0)
    numbers = {"mismatched_reads": {"value": mismatched,
                                    "limit": check.LIMITS["mismatched_reads"]},
               "mismatched_di_reads": {"value": len(bad_di) + (len(sample) == 0),
                                       "limit": check.LIMITS["mismatched_di_reads"]}}
    correct = error is None and all(v["value"] <= v["limit"] for v in numbers.values())
    if error is not None:
        log(f"portbench: the port raised in the window: {error!r}")
    log(f"portbench: {w['reads_in_window']} reads in the {args.seconds} s window, "
        f"{n_done} finished; {len(sample)} checked against the reference in {ref_s:.1f} s"
        + (f"; records differ on reads {bad}" if bad else "")
        + (f"; DI ranges differ on reads {bad_di}" if bad_di else ""))

    reads = w["reads_in_window"]
    ctx = Context(reads, args.seconds, setup_s, w, instruments, summary)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in man.metrics(cell, kind):
        value = man.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu" if require_cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if require_cuda else "cpu",
              "count": cell["chips"], "memory_peak_bytes": mem_peak}
    result = {"correct": bool(correct), "attempted": len(sample),
              "failed": len(set(bad) | set(bad_di)) + (len(sample) == 0),
              "metrics": metrics, "device": device,
              "reads_in_window": reads}
    if summary is not None:
        device["busy_s"] = summary.busy_ns * 1e-9
        device["window_s"] = summary.window_ns * 1e-9
        result["breakdown"] = {"device_ops": summary.device_ops(),
                               "idle_gaps": summary.idle_gaps()}
        log(f"portbench: traced {device['window_s']:.3f} s, device busy "
            f"{device['busy_s']:.6f} s, device time outside the ranges "
            f"{summary.unattributed_dev_ns * 1e-9:.6f} s")
    result["check"] = numbers
    for name, v in numbers.items():
        log(f"check {name} {v['value']} limit {v['limit']}")
    return 0, result


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    fixed_cache_dirs(".")
    rc, result = run_cell(args)
    if rc != 0 or result is None:
        return rc or 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
