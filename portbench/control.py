"""The control of the comparison that decides `correct`: the reference put
in the port's place with its floating-point steps one precision lower
(float32 for the float64 that mTR's C code and the configuration state:
the DI finish and the Jaccard index of the redundant-range pass), on a
cell's own reads at its own size.  Its reading is `mismatched_reads`
against the float64 reference; the check's limit must lie below it.

    python3 -m portbench.control --workload device.long-200x200 --seeds 1 2 3 --reads 60

draws each seed's pool as a run does, samples `check_reads` of the first
--reads reads as a run's check does (the longest with them), and prints
one JSON line a seed.  The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from portbench import check, manifest


def control_reading(workload: str, seed: int, n_done: int, root: str = ".",
                    precision: str = "float32", workers: int | None = None,
                    n_sample: int | None = None) -> dict:
    man = manifest.Manifest(root)
    cell = man.cell(workload)
    cfg = man.config(cell)["mtr_config"]
    traffic = man.traffic(cell)
    gen = man.generator(traffic)
    params = traffic["params"]
    pool = gen.fasta_records(params, seed, min(n_done, traffic["pool_reads"]), 0, "r")
    n_done = len(pool)
    sample = check.sample_reads(n_done, [gen.read_length(params)] * n_done,
                                n_sample or traffic["check_reads"], seed)
    manhattan = cfg.get("manhattan_distance", True)
    t0 = time.time()
    tasks = [(check.replay_records(pool.__getitem__, i), manhattan) for i in sample]
    both = check.reference_pool([t + ("float64",) for t in tasks]
                                + [t + (precision,) for t in tasks], workers)
    ref, low = both[: len(sample)], both[len(sample):]
    bad = [i for i, r, c in zip(sample, ref, low) if r[0] != c[0]]
    bad_di = [i for i, r, c in zip(sample, ref, low) if not check.same_ranges(r[1], c[1])]
    return {"workload": workload, "seed": seed, "precision": precision,
            "sample": sample, "mismatched_reads": len(bad),
            "mismatched_di_reads": len(bad_di),
            "records": sum(len(r[0]) for r in ref),
            "records_differing": sum(len(set(r[0]) ^ set(c[0])) for r, c in zip(ref, low)),
            "ranges": sum(len(r[1][0]) for r in ref),
            "ranges_differing": sum(int(np.sum(r[1][3] != c[1][3])) if len(r[1][3]) == len(c[1][3])
                                    else max(len(r[1][3]), len(c[1][3])) for r, c in zip(ref, low)),
            "seconds": time.time() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--reads", type=int, required=True,
                   help="reads a run finishes: the sample is drawn from these")
    p.add_argument("--precision", default="float32")
    a = p.parse_args(argv)
    for seed in a.seeds:
        print(json.dumps(control_reading(a.workload, seed, a.reads,
                                         precision=a.precision)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
