"""Accuracy sweep of the PyTorch port (the test_single_TR/test.sh harness;
scripts/accuracy_sweep.py on mtr_tpu_torch).

For each unit length, generates synthetic single-TR reads with the
reference error profile, runs the port's detector, and reports the exact
cyclic-unit match count plus the comp_mTR_DP ratio buckets
(>=1 / 0.99 / 0.98 / 0.96 / 0.94), mirroring test.sh:32-61.

Usage: python scripts/accuracy_sweep_torch.py [--reads N] [--backend B]
       [--lengths 2,5,10,20,50,100,200] [--freq 10] [--seed S]

The default backend is the hybrid, which needs a CUDA card; --backend host
runs on the CPU.
"""

import argparse
import io
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sweep(unit_len, freq, n_reads, seed, backend, directory):
    """-> (exact matches, comp_dp ratios, seconds of run_file) on n_reads
    reads of unit_len x freq at the 1.6 / 9.0 / 3.8 % profile
    (test.sh:12-14), flanks as long as the repeat."""
    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.pipeline import run_file
    from mtr_tpu_torch.testutil.evaluators import comp_dp, count_match
    from mtr_tpu_torch.testutil.rand_seq import write_fasta

    fasta = os.path.join(directory, f"sweep_{unit_len}_{freq}.fasta")
    units_f = fasta[:-6] + ".units"
    flank = unit_len * freq
    write_fasta(fasta, units_f, unit_len, freq, 1.6, 9.0, 3.8, flank, flank,
                n_reads, seed=seed)
    out = io.StringIO()
    t0 = time.time()
    run_file(fasta, MTRConfig(backend=backend), out)
    dt = time.time() - t0
    lines = out.getvalue().splitlines()
    with open(units_f) as f:
        truth = [ln.strip() for ln in f]
    return count_match(lines, truth), comp_dp(lines, truth), dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=100)
    ap.add_argument("--backend", default="hybrid")
    ap.add_argument("--lengths", default="2,5,10,20,50,100,200")
    ap.add_argument("--freq", type=int, default=10)
    ap.add_argument("--seed", type=int, default=12345)
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as tmp:
        for i in (int(x) for x in args.lengths.split(",")):
            exact, ratios, dt = sweep(i, args.freq, args.reads, args.seed,
                                      args.backend, tmp)
            buckets = {
                t: sum(1 for r in ratios if r >= t)
                for t in (1, 0.99, 0.98, 0.96, 0.94)
            }
            print(
                f"unit={i:>3} x{args.freq}: exact={exact}/{args.reads}  "
                + "  ".join(f">={t}:{n}" for t, n in buckets.items())
                + f"  ({args.reads/dt:.1f} reads/s)"
            )


if __name__ == "__main__":
    main()
