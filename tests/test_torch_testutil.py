"""The port's generators and evaluators against mtr_tpu's: the structured
(Badread-style) generator's bytes, the multi-TR generator against the
in-repo fixture, the evaluators on the record lines of two in-repo goldens,
and the port's host backend on every golden that mtr_tpu's host backend
wrote for the card (scripts/write_port_goldens.py).  Everything is bytes
or integers: every comparison is exact."""

import io
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")

# bench.py:200-203's arguments, and a small setting with no artifact class
STRUCTURED = {
    "bench": ((50, 12, 0.08, 600, 12), dict(
        seed=4242, junk_frac=0.1, random_frac=0.05, chimera_frac=0.15,
        adapters=True)),
    "plain": ((7, 9, 0.05, 40, 5), dict(seed=3)),
}


@pytest.mark.parametrize("name", sorted(STRUCTURED))
def test_write_structured_fasta_equals_mtr_tpu(tmp_path, name):
    from mtr_tpu.testutil.structured_errors import (
        write_structured_fasta as ref,
    )
    from mtr_tpu_torch.testutil.structured_errors import (
        write_structured_fasta,
    )

    args, kwargs = STRUCTURED[name]
    out = []
    for fn, tag in ((write_structured_fasta, "port"), (ref, "ref")):
        fa, units = tmp_path / f"{tag}.fasta", tmp_path / f"{tag}.units"
        fn(str(fa), str(units), *args, **kwargs)
        out.append((fa.read_bytes(), units.read_bytes()))
    assert out[0] == out[1]
    assert out[0][0].count(b">") == args[4]
    if name == "bench":  # every artifact class was drawn
        truths = out[0][1].decode().split("\n")
        assert "junk" in truths or "random" in truths
        assert any(t.startswith("chimera ") for t in truths)


def _set_file(tmp_path) -> str:
    # the bundled set config of tests/test_multitr_gen.py, verbatim
    p = tmp_path / "2_5_10_20_set.txt"
    p.write_text("10  5   5   1000\t1000   1\n2   250\n5   200\n10  100\n"
                 "20  100\n")
    return str(p)


def test_rand_multi_seq_reproduces_the_fixture_and_mtr_tpu(tmp_path):
    from mtr_tpu.testutil import rand_multi_seq as ref
    from mtr_tpu_torch.testutil import rand_multi_seq

    out = []
    for mod, tag in ((rand_multi_seq, "port"), (ref, "ref")):
        fa, units = tmp_path / f"{tag}.fasta", tmp_path / f"{tag}.units"
        mod.generate(_set_file(tmp_path), str(fa), str(units), seed=777)
        out.append((fa.read_text(), units.read_text()))
    assert out[0] == out[1]
    with open(f"{GOLDEN}/multitr_gen_2_5_10_20.fasta") as f:
        assert out[0][0] == f.read()
    with open(f"{GOLDEN}/multitr_gen_2_5_10_20_units.txt") as f:
        assert out[0][1] == f.read()
    assert rand_multi_seq.parse_set_file(_set_file(tmp_path)) == (
        ref.parse_set_file(_set_file(tmp_path)))


def _truths(name, lines):
    """Truth units for the evaluators: the planted units where the fixture
    has them, else each read's first predicted unit rotated and with one
    base changed, so that exact, cyclic and near matches all occur."""
    from mtr_tpu_torch.testutil.evaluators import parse_records

    recs = parse_records(lines)
    n_reads = max(rid for rid, _ in recs) + 1
    truth = ["ACGT"] * n_reads
    seen = set()
    for rid, unit in recs:
        if rid in seen:
            continue
        seen.add(rid)
        rot = unit[len(unit) // 3:] + unit[: len(unit) // 3]
        if rid % 3 == 1:  # one substitution
            rot = rot[:-1] + ("A" if rot[-1] != "A" else "C")
        elif rid % 3 == 2:  # one base longer
            rot = rot + "G"
        truth[rid] = rot
    return truth


@pytest.mark.parametrize("name", ("multi20_100x10", "multitr_gen_2_5_10_20"))
def test_evaluators_equal_mtr_tpu(name):
    from mtr_tpu.testutil import evaluators as ref
    from mtr_tpu_torch.testutil import evaluators

    with open(f"{GOLDEN}/{name}.out") as f:
        lines = f.read().splitlines()
    if name == "multitr_gen_2_5_10_20":
        lines = lines[:12]  # cal_dp is quadratic in the unit; keep it short
    assert evaluators.parse_records(lines) == ref.parse_records(lines)
    assert len(evaluators.parse_records(lines)) == len(lines)
    truth = _truths(name, lines)
    got = evaluators.count_match(lines, truth)
    assert got == ref.count_match(lines, truth)
    ratios = evaluators.comp_dp(lines, truth)
    assert ratios == ref.comp_dp(lines, truth)
    assert len(ratios) == len(lines)
    assert got > 0 and any(r == 1.0 for r in ratios) and any(
        r < 1.0 for r in ratios)
    for a, b in (("ACGTACGT", "ACGT"), ("ACGTTCGT", "ACG"), ("A", "A")):
        assert evaluators.cal_dp(a, b) == ref.cal_dp(a, b)


def _host_run(fasta, flags):
    """The port's CLI on the host backend, in process -> its stdout."""
    import contextlib

    from mtr_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["--backend", "host", *flags, fasta]) == 0
    return buf.getvalue()


GOLDEN_SETS = ("bench_200x200_pcc", "bench_200x200_cluster",
               "multi20_100x10_alignment", "bench_structured",
               "bench_100x10_100", "bench_800k")


@pytest.mark.parametrize("name", GOLDEN_SETS)
def test_port_host_backend_equals_the_golden(tmp_path, name):
    """Each golden was written by `python -m mtr_tpu.cli --backend host`
    with the set's flags on the set made from its seed; the port's host
    backend on the port's own generator prints the same bytes."""
    from mtr_tpu_torch.testutil.golden_sets import (
        SETS,
        read_golden,
        write_set,
    )

    got = _host_run(write_set(name, str(tmp_path)), SETS[name][1])
    want = read_golden(name)
    assert got == want
    assert want.count("\n") > 20
    if name.endswith("_cluster"):
        assert "#CLUSTER\t" in want
