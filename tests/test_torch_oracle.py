"""The port's copy of the oracle (--backend oracle) against mtr_tpu's
host backend, which mtr_tpu holds byte-identical to its oracle: on the
first read of each in-repo golden (the oracle takes ~15 s a 3 kb read
on one CPU core), with and without -p and -a.  Output never depends on
later reads, so a prefix of a FASTA gives a prefix of its output."""

import contextlib
import io
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


def _cli(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("name, flags", [
    ("multi20_100x10", ()), ("multi20_100x10", ("-p",)),
    ("multi20_100x10", ("-a",)), ("multi20_100x10", ("-p", "-a")),
    ("multitr_gen_2_5_10_20", ())],
    ids=lambda v: v if isinstance(v, str) else "".join(v) or "none")
def test_oracle_cli_equals_mtr_tpu(name, flags, tmp_path):
    from mtr_tpu import cli as ref_cli
    from mtr_tpu_torch import cli

    with open(os.path.join(GOLDEN, f"{name}.fasta")) as f:
        first = ">" + f.read().split(">")[1]
    path = tmp_path / "first.fasta"
    path.write_text(first)
    got = _cli(cli, ["--backend", "oracle", *flags, str(path)])
    want = _cli(ref_cli, ["--backend", "host", *flags, str(path)])
    assert got == want and got
    if not flags:
        with open(os.path.join(GOLDEN, f"{name}.out")) as f:
            assert f.read().startswith(got)
