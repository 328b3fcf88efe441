"""The port's multi-process path: run_file_sharded and merge_outputs in
process and in two real gloo processes, init_distributed with and without
its environment, the record gather, and checkpoint resume of a shard.
Outputs are bytes and the gathered columns integers: all exact."""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from mtr_tpu_torch.clustering import gather_records_multihost, pack_records
from mtr_tpu_torch.config import MTRConfig
from mtr_tpu_torch.parallel.distributed import (
    init_distributed,
    merge_outputs,
    run_file_sharded,
)
from mtr_tpu_torch.pipeline import run_file

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FASTA = os.path.join(REPO, "tests", "golden", "multi20_100x10.fasta")
WORKER = os.path.join(REPO, "tests", "_torch_dist_worker.py")
DIST_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
CFG = MTRConfig(backend="host")


def _golden() -> str:
    with open(FASTA[:-6] + ".out") as f:
        return f.read()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items() if k not in DIST_VARS}
    return {**env, "PYTHONPATH": REPO, **extra}


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_ranks_merge_to_the_golden(tmp_path, n):
    prefix = str(tmp_path / "shard")
    for pid in range(n):
        run_file_sharded(FASTA, prefix, CFG, process_index=pid,
                         process_count=n)
    merged = io.StringIO()
    merge_outputs(prefix, n, merged)
    assert merged.getvalue() == _golden()
    for pid in range(n):  # round robin: rank pid holds reads pid, pid + n, ...
        with open(f"{prefix}.meta{pid}") as f:
            rids = [int(ln.split("\t")[0]) for ln in f]
        assert rids == list(range(pid, 20, n))


def test_two_gloo_processes_merge_and_gather(tmp_path):
    prefix = str(tmp_path / "dist")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, prefix, FASTA], cwd=REPO,
            env=_clean_env(RANK=str(rank), WORLD_SIZE="2",
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for rank in range(2)
    ]
    try:
        for p in procs:
            _out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err.decode()[-2000:]
    finally:
        for p in procs:
            p.kill()
    merged = io.StringIO()
    merge_outputs(prefix, 2, merged)
    assert merged.getvalue() == _golden()

    # the single run's records, in the gather's rank order: the reads of
    # rank 0 (even), then those of rank 1
    records, per_read = [], {}
    run_file(FASTA, CFG, io.StringIO(), record_sink=records.append,
             read_meta=per_read.__setitem__)
    firsts = np.cumsum([0] + [per_read[r] for r in range(20)])
    want = pack_records([rec for rank in range(2)
                         for r in range(rank, 20, 2)
                         for rec in records[firsts[r] : firsts[r + 1]]])
    g0 = np.load(prefix + ".gather0.npy")
    g1 = np.load(prefix + ".gather1.npy")
    assert g0.dtype == np.int32 and g0.shape == (len(records), 20)
    np.testing.assert_array_equal(g0, g1)
    np.testing.assert_array_equal(g0, want)
    assert len(records) == _golden().count("\n")


def test_init_distributed_without_its_environment(monkeypatch):
    for var in DIST_VARS:
        monkeypatch.delenv(var, raising=False)
    assert init_distributed() == (0, 1)
    # and with no process group the gather is the identity
    records: list = []
    run_file(FASTA, CFG, io.StringIO(), record_sink=records.append,
             read_filter=lambda r: r < 2)
    assert gather_records_multihost(records) is records
    assert pack_records(records).shape == (len(records), 20)
    assert pack_records([]).shape == (0, 20)


def test_init_distributed_raises_where_the_master_is_unreachable():
    """Rank 1 of 2 with nobody listening at MASTER_PORT: the failure is
    raised, not swallowed into a one-process run."""
    code = ("from mtr_tpu_torch.parallel.distributed import init_distributed"
            "\nprint('RESULT', init_distributed(timeout_s=1))")
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env=_clean_env(RANK="1", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(_free_port())))
    assert r.returncode != 0
    assert "RESULT" not in r.stdout
    assert "DistNetworkError" in r.stderr or "timed out" in r.stderr


def test_checkpoint_resume_of_a_shard_appends(tmp_path):
    """Rank 1 of 2 with checkpoint=True; then the state an interrupted run
    leaves (4 of its 10 reads emitted and counted) is resumed: the part and
    meta files are appended to and equal the whole shard's."""
    prefix = str(tmp_path / "ck")
    run_file_sharded(FASTA, prefix, CFG, process_index=1, process_count=2,
                     checkpoint=True)
    with open(prefix + ".ckpt1") as f:
        assert f.read() == "10"
    with open(prefix + ".part1") as f:
        whole = f.read()
    with open(prefix + ".meta1") as f:
        meta = f.read()
    meta_lines = meta.splitlines(True)
    n_lines = sum(int(ln.split("\t")[1]) for ln in meta_lines[:4])
    with open(prefix + ".part1", "w") as f:
        f.writelines(whole.splitlines(True)[:n_lines])
    with open(prefix + ".meta1", "w") as f:
        f.writelines(meta_lines[:4])
    with open(prefix + ".ckpt1", "w") as f:
        f.write("4")
    run_file_sharded(FASTA, prefix, CFG, process_index=1, process_count=2,
                     checkpoint=True)
    with open(prefix + ".part1") as f:
        assert f.read() == whole
    with open(prefix + ".meta1") as f:
        assert f.read() == meta
    with open(prefix + ".ckpt1") as f:
        assert f.read() == "10"
    # with rank 0's part the merge is the golden
    run_file_sharded(FASTA, prefix, CFG, process_index=0, process_count=2)
    merged = io.StringIO()
    merge_outputs(prefix, 2, merged)
    assert merged.getvalue() == _golden()
