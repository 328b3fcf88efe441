"""The port's device backend on the bench set, this checkout against
another one (e.g. a parent commit unpacked with `git archive` into a
git-ignored directory), in turns (other, this, this, other) on one card:
each turn is a new process in that checkout's root that builds its own
kernels, then runs the device backend whole twice with Manhattan DI and
twice with -p's Pearson DI (the first run of each warms up), each held to
its golden.  Prints one JSON line a turn: wall seconds, the reader
thread's DI seconds, the walk thread's seconds and its stage A.  Needs a
CUDA card; run from the repository root:

    python3 scripts/di_turns_torch.py OTHER_CHECKOUT
"""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# one turn, run in a checkout's root with only APIs every slice has
TURN = r"""
import io, json, os, sys, tempfile, time
sys.path.insert(0, os.getcwd())
from mtr_tpu_torch.config import MTRConfig
from mtr_tpu_torch.pipeline import make_batcher, run_file
from mtr_tpu_torch.testutil.golden_sets import read_golden
from mtr_tpu_torch.testutil.rand_seq import write_fasta
from mtr_tpu_torch.utils.timers import TIMERS

os.makedirs("build", exist_ok=True)
out = {"checkout": os.getcwd()}
with tempfile.TemporaryDirectory(dir="build") as tmp:
    fasta = os.path.join(tmp, "bench_200x200.fasta")
    write_fasta(fasta, fasta[:-6] + ".units", 200, 200, 9.7, 2.9, 7.5,
                40000, 40000, 20, seed=20200)
    for name, manhattan, golden in (
            ("device", True, "bench_200x200"),
            ("device_p", False, "bench_200x200_pcc")):
        cfg = MTRConfig(backend="device", manhattan_distance=manhattan)
        for rep in (0, 1):
            before = dict(TIMERS.t)
            t0 = time.perf_counter()
            text = io.StringIO()
            run_file(fasta, cfg, text, batcher=make_batcher(cfg))
            wall = time.perf_counter() - t0
            spent = {k: v - before.get(k, 0.0) for k, v in TIMERS.t.items()}
            if text.getvalue() != read_golden(golden):
                raise SystemExit(f"{name} differs from {golden}")
            out[f"{name}_{rep}"] = {
                "wall_s": wall, "di_s": spent.get("di_device", 0.0),
                "walks_s": spent.get("walks", 0.0),
                "stage_a_s": spent.get("count_table", 0.0)}
print(json.dumps(out), flush=True)
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    print(card_line(), flush=True)
    for tree in (other, HERE, HERE, other):
        r = subprocess.run([sys.executable, "-c", TURN], cwd=tree,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stderr[-3000:], file=sys.stderr)
            return 1
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
