"""The port stands alone: no module of mtr_tpu_torch (nor chip_smoke.py)
imports jax or the JAX package, and the port's own copies of the host
stages give mtr_tpu's output: the CLI on the host backend with and without
-p and -a, the clustering stage (its near matrix on torch), and the
bench-set generator.  Also the counts dispatcher's single launch (the
kernel sizes each job's columns a lane) and its per-job value bound, on
the CPU path."""

import ast
import contextlib
import io
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
NAMES = ("multi20_100x10", "multitr_gen_2_5_10_20")
FLAGS = ((), ("-p",), ("-a",), ("-p", "-a"))


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "mtr_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(tree):
    """Every module name an import statement of the tree names, at any
    depth (functions, conditionals, classes)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module  # "from mtr_tpu import native" names mtr_tpu
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "mtr_tpu")


@pytest.mark.parametrize(
    "path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_import_of_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = sorted({n for n in _imported(tree) if _forbidden(n)})
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_static_check_catches_nested_imports():
    src = ("def f():\n    if True:\n        from mtr_tpu.native import x\n"
           "class A:\n    import jax.numpy as jnp\n"
           "importlib.import_module('mtr_tpu.pipeline')\n")
    found = {n for n in _imported(ast.parse(src)) if _forbidden(n)}
    assert found == {"mtr_tpu.native", "jax.numpy", "mtr_tpu.pipeline"}
    assert not _forbidden("mtr_tpu_torch.native")


def _cli(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(argv) == 0
    return buf.getvalue()


@pytest.mark.parametrize("flags", FLAGS, ids=lambda f: "".join(f) or "none")
@pytest.mark.parametrize("name", NAMES)
def test_host_cli_equals_mtr_tpu(name, flags):
    from mtr_tpu import cli as ref_cli
    from mtr_tpu_torch import cli

    argv = ["--backend", "host", *flags,
            os.path.join(GOLDEN, f"{name}.fasta")]
    got = _cli(cli, argv)
    assert got == _cli(ref_cli, argv)
    if not flags:
        with open(os.path.join(GOLDEN, f"{name}.out")) as f:
            assert got == f.read()


def _records(name):
    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.pipeline import run_file

    recs = []
    run_file(os.path.join(GOLDEN, f"{name}.fasta"), MTRConfig(backend="host"),
             io.StringIO(), record_sink=recs.append)
    return recs


@pytest.mark.parametrize("name", NAMES)
def test_cluster_repeats_equals_mtr_tpu(name):
    from mtr_tpu import clustering as ref
    from mtr_tpu_torch import clustering

    recs = _records(name)
    got = clustering.cluster_repeats(recs, 0.6, device=torch.device("cpu"))
    want = ref.cluster_repeats(recs, 0.6)
    assert [(c.global_id, c.rep_id, c.group_freq) for c in got] == [
        (c.global_id, c.rep_id, c.group_freq) for c in want]
    assert all(a.record is b.record for a, b in zip(got, want))
    assert got or name != "multi20_100x10"  # 20 reads cluster; 1 does not


def test_near_matrix_on_torch_equals_numpy():
    """Past mtr_tpu's device threshold (2,048 groups): the torch near
    matrix on CPU tensors equals the numpy formula, exactly."""
    from mtr_tpu_torch.clustering import _near_matrix

    rng = np.random.default_rng(2048)
    g = 2100
    periods = rng.integers(2, 80, g)
    hists = rng.integers(0, 12, (g, 16))
    hists[: g // 2] = hists[0]  # many exact and near-exact neighbours
    hists[: g // 2, 3] += rng.integers(0, 3, g // 2)
    got = _near_matrix(hists, periods, torch.device("cpu"))
    want = np.empty((g, g), bool)
    for lo in range(0, g, 256):  # numpy's (rows, G, 16) cube, in slices
        h = hists[lo : lo + 256]
        dist = np.abs(h[:, None, :] - hists[None, :, :]).sum(axis=2)
        p = periods[lo : lo + 256, None]
        want[lo : lo + 256] = ((10 * dist <= 3 * p)
                               & (10 * np.abs(p - periods[None, :]) <= p))
    assert got.dtype == bool and got.shape == (g, g)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < g * g


def test_write_fasta_equals_mtr_tpu(tmp_path):
    """The bench-set generator at chip_smoke's arguments, on 2 reads."""
    from mtr_tpu.testutil.rand_seq import write_fasta as ref
    from mtr_tpu_torch.testutil.rand_seq import write_fasta

    args = (200, 200, 9.7, 2.9, 7.5, 40000, 40000, 2)
    out = []
    for fn, tag in ((write_fasta, "port"), (ref, "ref")):
        fa, units = tmp_path / f"{tag}.fasta", tmp_path / f"{tag}.units"
        fn(str(fa), str(units), *args, seed=20200)
        out.append((fa.read_bytes(), units.read_bytes()))
    assert out[0] == out[1]
    assert out[0][0].count(b">") == 2


def test_counts_jobs_share_one_launch(monkeypatch):
    """The torch batcher launches the counts op once for all its counts
    jobs, whatever their units (the kernel gives each job C =
    ceil(unit_len / 32) columns a lane): unit rows 32 * C_max wide,
    longest job first; the results equal the host engine's."""
    from mtr_tpu_torch import pipeline as tp

    seen = []
    real = tp.wrap_dp_counts

    def spy(flat, starts, scal, unit, u_span):
        seen.append((u_span, unit.shape[1], scal[:, 0].tolist()))
        return real(flat, starts, scal, unit, u_span)

    monkeypatch.setattr(tp, "wrap_dp_counts", spy)
    rng = np.random.default_rng(32)
    org = rng.integers(0, 4, 3000).astype(np.int32)
    jobs = [tp.DPJob(org, qs, qs + rl, org[qs + 1 : qs + 1 + ul], (1, 1, 3))
            for qs, rl, ul in ((0, 400, 1), (10, 500, 32), (20, 300, 33),
                               (30, 900, 64), (40, 700, 200), (50, 800, 224),
                               (60, 600, 225), (70, 1000, 300))]
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch([org])
    dev.run(jobs)
    assert len(seen) == 1
    span, width, rlens = seen[0]
    assert span == width == 320  # C = 10 for the 300-base unit
    assert rlens == sorted(rlens, reverse=True) and len(rlens) == len(jobs)
    got = [j.result for j in jobs]
    tp.HostDPBatcher().run(jobs)
    assert got == [j.result for j in jobs]


def test_counts_value_bound_uses_the_lane_span():
    """rep_len*mg + ip*32*C < 2^31 per job (the scan carries D[j] +
    ip*j): unit 200 is checked against 224, not the old 256, even in a
    launch whose rows are 512 wide."""
    from mtr_tpu_torch import pipeline as tp
    from mtr_tpu_torch.ops.wrap_dp_counts import R_MAX, u_span_for

    assert [u_span_for(u) for u in (1, 32, 33, 200, 256, 257, 500)] == [
        32, 32, 64, 224, 256, 288, 512]
    with pytest.raises(ValueError):
        u_span_for(513)
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch([np.zeros(R_MAX + 10, np.int32)])
    starts = np.zeros(1, np.int64)

    def check(rep_len, mg, ip, unit_len=200):
        scal = np.array([[rep_len, unit_len, mg, 1, ip, 0, 0, 0]], np.int32)
        dev._check_bounds(scal, starts, 512)

    limit = (1 << 31) - 1
    ip = (limit - R_MAX * 5) // 224       # the largest ip that fits
    check(R_MAX, 5, ip)
    with pytest.raises(ValueError, match="overflows"):
        check(R_MAX, 5, ip + 1)
    with pytest.raises(ValueError, match="rep_len"):
        check(R_MAX + 1, 1, 1)
    with pytest.raises(ValueError, match="span"):
        dev._check_bounds(np.array([[10, 225, 1, 1, 1, 0, 0, 0]], np.int32),
                          starts, 224)
