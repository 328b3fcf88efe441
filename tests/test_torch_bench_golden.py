"""The port's host backend on the whole bench set (chip_smoke.py's 200 bp
x 200 copy set, 20 reads, made by the port's own generator) against
tests/golden/bench_200x200.out, which mtr_tpu's host backend wrote on the
same set.  chip_smoke.py holds every card path to the same file."""

import io
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# chip_smoke.py's bench-set arguments (bench.py:87-91)
BENCH_ARGS = (200, 200, 9.7, 2.9, 7.5, 40000, 40000, 20)


def test_host_backend_on_bench_set_equals_golden(tmp_path):
    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.pipeline import run_file
    from mtr_tpu_torch.testutil.rand_seq import write_fasta

    fasta = tmp_path / "bench_200x200.fasta"
    write_fasta(str(fasta), str(tmp_path / "bench_200x200.units"),
                *BENCH_ARGS, seed=20200)
    out = io.StringIO()
    run_file(str(fasta), MTRConfig(backend="host"), out)
    with open(os.path.join(REPO, "tests", "golden", "bench_200x200.out")) as f:
        want = f.read()
    assert out.getvalue() == want
    assert want.count("\n") == 1125
