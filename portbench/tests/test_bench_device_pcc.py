"""The cell device-pcc.long-200x200 (mTR's -p under --backend device): the
real BENCHMARK.json's entries and files, the readers of the device DI
plug-in's spans on fake contexts, and a whole CPU run of a small device-pcc
cell in a copy of the benchmark, sound and with the Pearson moments
altered where the port produces them."""

import argparse
import json
import os
import shutil

import pytest

from portbench import manifest, roofline, run, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "device-pcc.long-200x200"
NEW_METRICS = ("di_kernel_roofline", "di_device_s_per_read", "di_wait_s_per_read",
               "di_finish_s_per_read", "di_pair_s_per_read")


class Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_read(self, s):
        return s / self.reads if self.reads else None


def test_the_cell_finds_its_files():
    man = manifest.Manifest(ROOT)
    cell = man.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("device-pcc", "long-200x200", 1)
    cfg = man.config(cell)
    assert cfg["mtr_config"]["manhattan_distance"] is False
    assert cfg["mtr_config"]["backend"] == "device"
    assert cfg["cli"] == ["--backend", "device", "-p"]
    assert cfg["reduced"] == [] and man.configs["device-pcc"]["reduced"] == []
    # device.json's fields, but for the DI and its description
    device = man.config(man.cell("device.short-100x10"))
    assert {k: v for k, v in cfg["mtr_config"].items() if k != "manhattan_distance"} == \
        {k: v for k, v in device["mtr_config"].items() if k != "manhattan_distance"}
    assert cfg["guarantees"] == device["guarantees"]
    traffic = man.traffic(cell)
    assert man.generator(traffic).read_length(traffic["params"]) == traffic["read_bases"]
    # every read runs the device DI
    assert traffic["read_bases"] >= cfg["mtr_config"]["device_di_threshold"]


def test_the_new_metrics_list_only_the_new_cell():
    man = manifest.Manifest(ROOT)
    layer = next(m["layer"] for m in man.data["per_layer"] if m["name"] == "di_s_per_read")
    by_name = {m["name"]: m for m in man.data["per_layer"]}
    for name in NEW_METRICS:
        m = by_name[name]
        assert m["workloads"] == [CELL] and m["layer"] == layer, name
        assert m["moves"] == "reads_per_s"
    names = [m["name"] for m in man.metrics(man.cell(CELL), "per_layer")]
    assert names == list(NEW_METRICS)
    for w in man.data["workloads"]:
        if w["name"] != CELL:
            assert not set(NEW_METRICS) & {m["name"] for m in man.metrics(w, "per_layer")}


@pytest.mark.parametrize("name,timers,want", [
    ("di_device_s_per_read", {"mtr.di.device": 8.0}, 0.2),
    ("di_wait_s_per_read", {"mtr.di.wait": 2.0, "mtr.di.device": 8.0}, 0.05),
    ("di_finish_s_per_read", {"mtr.di.widen": 1.0, "mtr.di.finish": 3.0}, 0.1),
    ("di_finish_s_per_read", {"mtr.di.finish": 3.0}, 0.075),
    ("di_pair_s_per_read", {"mtr.di.pair": 0.4}, 0.01),
])
def test_span_readers(name, timers, want):
    r = manifest.Manifest(ROOT).reader(name)
    assert r.read(Ctx(reads=40, timers=timers, trace=None)) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW_METRICS[1:])
def test_span_readers_read_nothing_without_their_spans(name):
    """A program without the spans (the parent of this cell's readers)
    gives each reader nothing to read: it returns None, not 0."""
    r = manifest.Manifest(ROOT).reader(name)
    assert r.read(Ctx(reads=40, timers={"range": 3.0}, trace=None)) is None


def test_di_kernel_roofline_reads_the_pearson_group():
    """A Pearson k-5 group of a long-200x200 read: the plug-in range's
    device time (kernel and copies) against the group's least time."""
    L = 118160
    rsl = L // 10
    ws = [5 * 2**i for i in range(12)]
    passes = roofline.di_passes(L + 2 * rsl, ws, 5, rsl, False)
    work = {0: ("bench.di_device", *roofline.di_work(passes, False))}
    least, _bound = roofline.least_s(*roofline.di_work(passes, False))
    events = [("cpu", "bench.di_device#0", 100, 40_000_000, 1, 3, None),
              ("cpu", "cudaLaunchKernel", 200, 300, 1, 4, None),
              ("dev", "mtr_di_pearson_moments", 1_000, 1_001_000, None, None, 4),
              ("dev", "Memcpy DtoH", 1_001_000, 31_001_000, None, None, 3)]
    s = trace.summarize(events, 0, 50_000_000, work)
    r = manifest.Manifest(ROOT).reader("di_kernel_roofline")
    assert r.read(Ctx(trace=s)) == pytest.approx(100 * least / 31e-3)
    assert r.read(Ctx(trace=None)) is None


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark with a small device-pcc cell the CPU runs:
    3 kb reads, the configuration's device DI threshold lowered to 1,000
    bases and two reads a batch."""
    tmp = tmp_path_factory.mktemp("bench_pcc")
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.load(open(tmp / "portbench/configs/device-pcc.json"))
    cfg["mtr_config"].update(device_di_threshold=1000, reads_per_batch=2)
    (tmp / "portbench/configs/device-pcc-cpu.json").write_text(json.dumps(cfg))
    traffic = json.load(open(tmp / "portbench/traffic/short-100x10.json"))
    traffic.update(pool_reads=40, check_reads=3)
    (tmp / "portbench/traffic/tiny-100x10.json").write_text(json.dumps(traffic))
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b["configs"].append({"name": "device-pcc-cpu", "source": "a CPU test",
                         "file": "portbench/configs/device-pcc-cpu.json",
                         "reduced": ["device_di_threshold"], "why": "CPU test"})
    b["workloads"].append({"name": "device-pcc-cpu.tiny-100x10", "config": "device-pcc-cpu",
                           "traffic": "tiny-100x10", "chips": 1, "why": "CPU test"})
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return str(tmp)


def run_once(root, fault=None, seed=2**31 + 1515):
    import torch

    from mtr_tpu_torch.pipeline import TorchHybridDPBatcher
    from mtr_tpu_torch.utils.timers import TIMERS

    before = TIMERS.counters.get("di_pearson_passes", 0)
    args = argparse.Namespace(workload="device-pcc-cpu.tiny-100x10", seed=seed,
                              seconds=2.0, trace=0)
    # the device DI and walks on CPU tensors; every DP job on the native
    # engine (the plain DP on the CPU is far slower, and bit-exact alike)
    batcher = TorchHybridDPBatcher(torch.device("cpu"), cell_threshold=1 << 62,
                                   min_device_cells=1 << 62)
    rc, result = run.run_cell(args, root=root, require_cuda=False, batcher=batcher,
                              fault=fault)
    assert rc == 0
    # the reads went through the Pearson plug-in
    assert TIMERS.counters.get("di_pearson_passes", 0) > before
    return result


def test_sound_device_pcc_run_is_correct(root):
    r = run_once(root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] == 3
    assert r["check"] == {"mismatched_reads": {"value": 0, "limit": 0},
                          "mismatched_di_reads": {"value": 0, "limit": 0}}


def test_pearson_moments_altered_where_they_are_produced(root, monkeypatch):
    """One more shared symbol in each position's ip01: the DI values
    move, which the check's ranges see."""
    from mtr_tpu_torch.ops import directional_index as odi

    def fault(pipeline):
        orig = odi._pearson_moments_device

        def broken(codes, k, w):
            q0, q1, q2, ip01, ip12 = orig(codes, k, w)
            return [q0, q1, q2, ip01 + 1, ip12]
        monkeypatch.setattr(odi, "_pearson_moments_device", broken)

    r = run_once(root, fault)
    assert not r["correct"] and r["check"]["mismatched_di_reads"]["value"] > 0
