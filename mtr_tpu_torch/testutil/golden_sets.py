"""The read sets whose goldens (tests/golden/<name>.out) were written by
mtr_tpu's host backend (scripts/write_port_goldens.py), and how each set is
made again from its seed.  The FASTAs are not kept: a reader calls
`write_set(name, directory)` and compares a run under `SETS[name][1]`'s
flags with the golden.
"""

from __future__ import annotations

import os

from mtr_tpu_torch.testutil.rand_seq import write_fasta
from mtr_tpu_torch.testutil.structured_errors import write_structured_fasta

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

# the bench set: 200 bp units x 200 copies, Nanopore error profile, 20 reads
BENCH_ARGS = (200, 200, 9.7, 2.9, 7.5, 40000, 40000, 20)
BENCH_SEED = 20200


def _bench(fasta):
    write_fasta(fasta, fasta[:-6] + ".units", *BENCH_ARGS, seed=BENCH_SEED)


def _structured(fasta):
    write_structured_fasta(fasta, fasta[:-6] + ".units", 50, 12, 0.08, 600,
                           12, seed=4242, junk_frac=0.1, random_frac=0.05,
                           chimera_frac=0.15, adapters=True)


def _hundred(fasta):
    write_fasta(fasta, fasta[:-6] + ".units", 100, 10, 1.6, 9.0, 3.8, 1000,
                1000, 100, seed=12345)


def _long_read(fasta):
    write_fasta(fasta, fasta[:-6] + ".units", 100, 2000, 9.7, 2.9, 7.5,
                300000, 300000, 1, seed=80080)


def _single_tr_200x40(fasta):
    """one read: the bench set's unit and error profile, 40 copies,
    flanks 2,000 + 2,000 (the table path's long-read case, kept short)"""
    write_fasta(fasta, fasta[:-6] + ".units", 200, 40, 9.7, 2.9, 7.5, 2000,
                2000, 1, seed=20040)


MULTI20 = os.path.join(GOLDEN_DIR, "multi20_100x10.fasta")

# name -> (generator or the path of an in-repo FASTA, CLI flags)
SETS = {
    "bench_200x200": (_bench, ()),
    "bench_200x200_pcc": (_bench, ("-p",)),
    "bench_200x200_cluster": (_bench, ("--cluster",)),
    "multi20_100x10_alignment": (MULTI20, ("-a",)),
    "bench_structured": (_structured, ()),
    "bench_100x10_100": (_hundred, ()),
    "bench_800k": (_long_read, ()),
    "single_tr_200x40": (_single_tr_200x40, ()),
}


def write_set(name: str, directory: str) -> str:
    """The FASTA of golden `name`: generated into `directory` (once per
    generator), or the in-repo file."""
    source = SETS[name][0]
    if isinstance(source, str):
        return source
    fasta = os.path.join(directory, source.__name__.lstrip("_") + ".fasta")
    if not os.path.exists(fasta):
        source(fasta)
    return fasta


def read_golden(name: str) -> str:
    with open(os.path.join(GOLDEN_DIR, name + ".out")) as f:
        return f.read()
