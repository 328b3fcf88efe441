"""A whole run of the harness on the CPU, the look for a card skipped, with
the timed path sound and then broken underneath it: `correct` has to come
out false for each fault a cell of this benchmark can have.  (A training
step that returns its state unchanged and an exchange between chips left
out do not exist here: no cell trains, every cell is one card.)

The port runs its host backend (the native engine) under the `auto`
configuration, on a small short-read traffic in a copy of the benchmark."""

import argparse
import json
import os
import shutil

import numpy as np
import pytest

from portbench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.load(open(tmp / "portbench/traffic/short-100x10.json"))
    traffic.update(pool_reads=600, check_reads=8)
    (tmp / "portbench/traffic/tiny-100x10.json").write_text(json.dumps(traffic))
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b["workloads"].append({"name": "auto.tiny-100x10", "config": "auto",
                           "traffic": "tiny-100x10", "chips": 1, "why": "CPU test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp)


def run_once(root, fault=None, seed=2**31 + 77):
    from mtr_tpu_torch.pipeline import HostDPBatcher

    args = argparse.Namespace(workload="auto.tiny-100x10", seed=seed, seconds=2.0, trace=0)
    rc, result = run.run_cell(args, root=root, require_cuda=False,
                              batcher=HostDPBatcher(), fault=fault)
    assert rc == 0
    assert list(result)[-1] == "check"
    return result


def test_sound_run_is_correct(root):
    r = run_once(root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 8
    assert r["check"] == {"mismatched_reads": {"value": 0, "limit": 0},
                          "mismatched_di_reads": {"value": 0, "limit": 0}}
    assert r["metrics"]["reads_per_s"]["value"] > 0


def test_half_of_each_batch_left_out(root, monkeypatch):
    def fault(pipeline):
        orig = pipeline.process_batch

        def broken(states, *a, **kw):
            out = orig(states, *a, **kw)
            return [[] if i % 2 == 0 else recs for i, recs in enumerate(out)]
        monkeypatch.setattr(pipeline, "process_batch", broken)

    r = run_once(root, fault)
    assert not r["correct"] and r["check"]["mismatched_reads"]["value"] > 0


def test_a_record_altered_where_it_is_produced(root, monkeypatch):
    def fault(pipeline):
        orig = pipeline.process_batch

        def broken(states, *a, **kw):
            out = orig(states, *a, **kw)
            for recs in out:
                if recs:
                    recs[-1].num_matches += 1
            return out
        monkeypatch.setattr(pipeline, "process_batch", broken)

    r = run_once(root, fault)
    assert not r["correct"] and r["check"]["mismatched_reads"]["value"] > 0


def test_a_di_answer_altered_where_it_is_produced(root, monkeypatch):
    """The DI values rounded through float32, as a float32 finish would
    give them: the records stay, the ranges' values do not."""
    def fault(pipeline):
        orig = pipeline.fill_directional_index_with_end

        def broken(*a, **kw):
            di, di_end, di_w = orig(*a, **kw)
            di = np.where(di != -1.0, di.astype(np.float32).astype(np.float64), di)
            return di, di_end, di_w
        monkeypatch.setattr(pipeline, "fill_directional_index_with_end", broken)

    r = run_once(root, fault)
    assert not r["correct"] and r["check"]["mismatched_di_reads"]["value"] > 0
