#!/usr/bin/env python3
"""A/B timings of kernel variants on one CUDA card (sm_90a), for PERF.md.

    python3 kernel_ab.py consensus-split
    python3 kernel_ab.py counts OTHER_wrap_dp_counts.cu

consensus-split: where the consensus kernel's fill spends a row.  It
builds variants of mtr_tpu_torch/csrc/wrap_dp_consensus.cu with small
edits and times each against the kernel, in turns with CUDA events, on one
job of rep_len 4,096 at units 32, 100, 200 and 480 (C 1, 4, 7, 15), and on
11 jobs of rep_len 4,167 at unit 203 (the bench run's heaviest polish
launch):
  values_only  warp 1 takes no move codes: warp 0's row step alone;
  codes_only   warp 0's row step replaced by a trivial one: warp 1 alone.
The variants are timing probes only: their outputs are not results.

counts: the counts kernel against another source of it (for instance a
parent commit's mtr_tpu_torch/csrc/wrap_dp_counts.cu, unpacked with git
archive), built into a library of its own, timed in turns (other, kernel,
kernel, other) at chip_smoke.py's phase-4 shapes, outputs compared.

Both print the card's name and power limit first.  Builds go to
build/kernel_ab/.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "kernel_ab")
CSRC = os.path.join(HERE, "mtr_tpu_torch", "csrc")


def build(name: str, source: str, headers=()) -> ctypes.CDLL:
    """source (text) with the given header files beside it -> loaded
    library build/kernel_ab/<name>/lib.so."""
    from mtr_tpu_torch.ops import _build

    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    src = os.path.join(d, "kernel.cu")
    with open(src, "w") as f:
        f.write(source)
    for h in headers:
        with open(h) as f, open(os.path.join(d, os.path.basename(h)),
                                "w") as g:
            g.write(f.read())
    so = os.path.join(d, "lib.so")
    r = subprocess.run([_build._nvcc(), *_build.FLAGS, "-shared", "-o", so,
                        src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{r.stderr}")
    return ctypes.CDLL(so)


def consensus_variants(base: str) -> dict:
    """The kernel's source with the edits of each variant."""
    def values_only(s):
        s = s.replace("for (int q = 0; q < kBatch; ++q) consume(b0 + q);",
                      "for (int q = 0; q < kBatch; ++q) (void)q;")
        return s.replace("for (int r = b0; r < rep_len; ++r) consume(r);",
                         "")

    def codes_only(s):
        return re.sub(
            r"mtr_warp::row_values<C>\(u, code, prev, up_v, mg, mp, ip, "
            r"lane, base_j,\s*n_valid, d\);",
            "for (int c = 0; c < C; ++c) d[c] = prev[c] + code + 1;", s)

    out = {}
    for name, edit in (("values_only", values_only),
                       ("codes_only", codes_only)):
        s = edit(base)
        if s == base:
            raise RuntimeError(f"variant {name}: the edit no longer applies")
        out[name] = s
    return out


def consensus_split() -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from mtr_tpu_torch.ops import wrap_dp_consensus as cop

    with open(os.path.join(CSRC, "wrap_dp_consensus.cu")) as f:
        base = f.read()
    header = os.path.join(CSRC, "wrap_dp_warp.cuh")
    fns = {}
    for name, src in consensus_variants(base).items():
        fn = build(name, src, (header,)).mtr_wrap_dp_consensus
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                  ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    rng = np.random.default_rng(5)
    for ul, b, rl in ((32, 1, 4096), (100, 1, 4096), (200, 1, 4096),
                      (480, 1, 4096), (203, 11, 4167)):
        unit = rng.integers(0, 4, ul).astype(np.int8)
        jobs = [(cs.periodic_rep(rng, unit, rl), unit, (5, 1, 1))
                for _ in range(b)]
        u_span = 32 * -(-ul // 32)
        args = [torch.from_numpy(a).cuda()
                for a in cs.make_batch(jobs, u_span)]
        launch, (fused, best, done, moves, mv_off) = cop.prepare(
            *args, u_span, 6)
        max_rep = args[2][:, 0].amax().reshape(1)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        ptrs = (u_span, *(a.data_ptr() for a in args), mv_off.data_ptr(),
                max_rep.data_ptr(), moves.data_ptr(), 6, best.data_ptr(),
                fused.data_ptr(), done.data_ptr(), b, stream)

        def variant(fn):
            def run():
                err = fn(*ptrs)
                cs.check(err == 0, f"variant launch failed: CUDA error {err}")
            return run

        ms = {"kernel": cs.event_ms(launch, 5)}
        for name, fn in fns.items():
            launch()  # the moves a variant's traceback reads are the kernel's
            ms.update(cs.in_turns({"kernel": launch, name: variant(fn)}, 5))
        cs.info(f"consensus fill, unit {ul} x rep_len {rl} x {b} jobs, ms "
                f"(us a row): " + ", ".join(
                    f"{n} {v:.3f} ({v * 1e3 / rl:.3f})"
                    for n, v in ms.items()))


def counts(other: str) -> None:
    import numpy as np
    import torch

    import chip_smoke as cs
    from mtr_tpu_torch.ops.wrap_dp_counts import u_span_for, wrap_dp_counts

    with open(other) as f:
        fn = build("counts_other", f.read()).mtr_wrap_dp_counts
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rng = np.random.default_rng(395)
    for b, ul, rl, n in ((2048, 100, 4096, 5), (1024, 200, 32768, 2),
                         (256, 400, 32768, 2)):
        unit = rng.integers(0, 4, ul).astype(np.int8)
        rep = cs.periodic_rep(rng, unit, rl + b)
        flat = np.lib.stride_tricks.sliding_window_view(rep, rl)[:b]
        u_span = u_span_for(ul)
        args = [torch.from_numpy(a).cuda() for a in cs.make_batch(
            [(flat[q], unit, (1, 1, 3)) for q in range(b)], u_span)]
        out = torch.empty((b, 15), dtype=torch.int32, device="cuda")
        max_rep = args[2][:, 0].amax().reshape(1)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

        def run_other():
            err = fn(u_span, *(a.data_ptr() for a in args),
                     max_rep.data_ptr(), out.data_ptr(), b, stream)
            cs.check(err == 0, f"other counts kernel failed: {err}")

        run_other()
        same = torch.equal(out[:, :11], wrap_dp_counts(*args, u_span)[:, :11])
        ms = cs.in_turns({"other": run_other,
                          "kernel": lambda: wrap_dp_counts(*args, u_span)}, n)
        cs.info(f"counts kernel, unit {ul} x rep_len {rl} x {b} jobs: other "
                f"{ms['other']:.3f} ms, kernel {ms['kernel']:.3f} ms "
                f"({ms['other'] / ms['kernel']:.3f}x), outputs equal: {same}")
        cs.check(same, "the two counts kernels disagree")


def main() -> int:
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    cs.info(cs.card_line())
    if sys.argv[1:2] == ["consensus-split"]:
        consensus_split()
    elif sys.argv[1:2] == ["counts"] and len(sys.argv) == 3:
        counts(sys.argv[2])
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
