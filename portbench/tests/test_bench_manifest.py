"""BENCHMARK.json against the benchmark's contract, and the files it names;
a cell added from files and entries alone, in a copy."""

import json
import os
import shutil

import pytest

from portbench import manifest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def one_line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s and "\t" not in s


def contract_errors(root):
    """What of the contract a BENCHMARK.json under `root` breaks."""
    errs = []
    path = os.path.join(root, "BENCHMARK.json")
    b = json.load(open(path))
    if os.path.getsize(path) > 64 * 1024:
        errs.append("over 64 KiB")
    if set(b) != KEYS:
        errs.append(f"keys {sorted(b)}")
    if not (1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)):
        errs.append("run_seconds")
    if not (1 <= len(b["command"]) <= 32) or not all(one_line(w) for w in b["command"]):
        errs.append("command")
    for p in b["paths"]:
        if p.startswith("/") or ".." in p.split("/") or not manifest.NAME.match(p.replace("/", "_")):
            errs.append(f"path {p}")
    man = manifest.Manifest(root)
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]] \
        + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names:
        if not manifest.NAME.match(n):
            errs.append(f"name {n}")
    for group in ("configs", "workloads"):
        ns = [x["name"] for x in b[group]]
        if len(set(ns)) != len(ns):
            errs.append(f"duplicate {group}")
    ms = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    if len(set(ms)) != len(ms):
        errs.append("duplicate metrics")
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            errs.append(f"config keys {c['name']}")
        if not os.path.exists(os.path.join(root, c["file"])) or \
                not any(c["file"].startswith(p + "/") for p in b["paths"]):
            errs.append(f"config file {c['file']}")
        if c["name"] not in used or not one_line(c["source"]) or not one_line(c["why"]):
            errs.append(f"config {c['name']}")
        if len(c["reduced"]) > 16 or not all(manifest.NAME.match(k) for k in c["reduced"]):
            errs.append(f"reduced {c['name']}")
    pairs = set()
    four = 0
    for w in b["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            errs.append(f"workload keys {w['name']}")
        if w["config"] not in man.configs or w["chips"] not in (1, 4) or not one_line(w["why"]):
            errs.append(f"workload {w['name']}")
        if not os.path.exists(os.path.join(root, manifest.TRAFFIC_DIR, w["traffic"] + ".json")):
            errs.append(f"traffic {w['traffic']}")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"pair {w['name']}")
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
        e2e = [m["name"] for m in man.metrics(w, "end_to_end")]
        if "setup_s" not in e2e or len(e2e) < 2 or not man.metrics(w, "per_layer"):
            errs.append(f"cell {w['name']} reports too little")
    if four > max(1, len(b["workloads"]) // 4):
        errs.append("four-chip cells")
    e2e_names = {m["name"] for m in b["end_to_end"]}
    if "setup_s" not in e2e_names:
        errs.append("no setup_s")
    for m in b["end_to_end"]:
        if not (0 < m["bound"] <= 0.25) or m["source"] not in ("host_clock", "device_trace"):
            errs.append(f"e2e {m['name']}")
    for m in b["end_to_end"] + b["per_layer"]:
        extra = {"workloads"} | ({"bound"} if m in b["end_to_end"] else
                                 {"layer", "moves"})
        if not set(m) <= {"name", "unit", "better", "source"} | extra:
            errs.append(f"metric keys {m['name']}")
        if not manifest.UNIT.match(m["unit"]) or m["better"] not in ("lower", "higher") \
                or m["source"] not in SOURCES:
            errs.append(f"metric {m['name']}")
        if not set(m.get("workloads", [])) <= {w["name"] for w in b["workloads"]}:
            errs.append(f"metric workloads {m['name']}")
    for m in b["per_layer"]:
        if m["moves"] not in e2e_names or not one_line(m["layer"]):
            errs.append(f"per-layer {m['name']}")
    return errs


def test_benchmark_meets_the_contract():
    assert contract_errors(ROOT) == []


def test_every_metric_moves_reads_per_s_and_its_reader_agrees():
    man = manifest.Manifest(ROOT)
    for m in man.data["per_layer"]:
        assert m["moves"] == "reads_per_s"
    for m in man.data["end_to_end"] + man.data["per_layer"]:
        r = man.reader(m["name"])
        assert (r.UNIT, r.SOURCE) == (m["unit"], m["source"]), m["name"]
        assert r.MOVES == m.get("moves"), m["name"]
        if "layer" in m:
            assert r.LAYER == m["layer"], m["name"]
    layers = {}
    for m in man.data["per_layer"]:
        layers.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())  # one spelling a layer


def test_every_cell_finds_its_files():
    man = manifest.Manifest(ROOT)
    for w in man.data["workloads"]:
        cfg = man.config(w)
        traffic = man.traffic(w)
        gen = man.generator(traffic)
        assert gen.read_length(traffic["params"]) == traffic["read_bases"]
        assert traffic["check_reads"] >= 1 and traffic["pool_reads"] > traffic["check_reads"]
        assert cfg["mtr_config"]["backend"] in ("device", "auto", "hybrid", "host")


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A new configuration, traffic mix, metric and cell, in a copy: only
    new files and new entries of BENCHMARK.json."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    before = {p: open(p, "rb").read() for p in
              (str(f) for f in (tmp_path / "portbench").rglob("*") if f.is_file())}
    cfg = json.load(open(tmp_path / "portbench/configs/device.json"))
    cfg["name"] = "device-pcc"
    cfg["mtr_config"]["manhattan_distance"] = False
    (tmp_path / "portbench/configs/device-pcc.json").write_text(json.dumps(cfg))
    traffic = json.load(open(tmp_path / "portbench/traffic/short-100x10.json"))
    traffic["params"]["copies"] = 20
    traffic["read_bases"] = 4104  # 1,000 + 2,000 + 1,000 + 180 inserted - 76 deleted
    (tmp_path / "portbench/traffic/short-100x20.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/dummy_share.py").write_text(
        'LAYER = "device (NVIDIA H100)"\nUNIT = "%"\nSOURCE = "device_trace"\n'
        'MOVES = "reads_per_s"\n\n\ndef read(ctx):\n    return None\n')
    b["configs"].append({"name": "device-pcc", "source": "https://github.com/morisUtokyo/mTR -p",
                         "file": "portbench/configs/device-pcc.json", "reduced": [],
                         "why": "Pearson DI"})
    b["workloads"].append({"name": "device-pcc.short-100x20", "config": "device-pcc",
                           "traffic": "short-100x20", "chips": 1, "why": "a dummy cell"})
    b["per_layer"].append({"name": "dummy_share", "unit": "%", "better": "lower",
                           "source": "device_trace", "layer": "device (NVIDIA H100)",
                           "moves": "reads_per_s", "workloads": ["device-pcc.short-100x20"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    man = manifest.Manifest(str(tmp_path))
    cell = man.cell("device-pcc.short-100x20")
    t = man.traffic(cell)
    gen = man.generator(t)
    assert gen.read_length(t["params"]) == t["read_bases"]
    assert man.config(cell)["mtr_config"]["manhattan_distance"] is False
    assert [m["name"] for m in man.metrics(cell, "per_layer")][-1] == "dummy_share"
    assert man.reader("dummy_share").read(None) is None
    assert contract_errors(str(tmp_path)) == []
    for p, data in before.items():  # no file that was there changed
        assert open(p, "rb").read() == data


@pytest.mark.parametrize("bad", [
    {"run_seconds": 60}, {"run_seconds": 30.5},
    {"end_to_end": [{"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.3,
                     "source": "host_clock"}]},
])
def test_contract_check_catches(tmp_path, bad):
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b.update(bad)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    assert contract_errors(str(tmp_path)) != []
