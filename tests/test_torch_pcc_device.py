"""mTR's -p (the Pearson DI) under --backend device, on the CPU: run_file
with the device backend's plain ops (TorchDPBatcher on a CPU device, the
device DI plug-in for every read) over seeded reads of portbench's
generator against portbench's NumPy reference, records and DI candidate
ranges, beside the Manhattan DI (the other seeds:
test_torch_device_di_reads.py); the DI plug-in's spans and counters,
once a group, against the passes' arithmetic, for both kinds; and -c's
DI lines."""

import io

import numpy as np
import pytest
import torch

from _device_di_reads import SEEDS, check_one_read, run_device
from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.utils.timers import TIMERS, Timers


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("manhattan", [False, True], ids=["pearson", "manhattan"])
@pytest.mark.parametrize("seed", SEEDS[:1])
def test_device_di_records_and_ranges_match_the_reference(tmp_path, seed, manhattan):
    """The Pearson and the Manhattan DI on the first seed (the other two:
    test_torch_device_di_reads.py)."""
    check_one_read(tmp_path, seed, manhattan)


def di_groups(L: int, manhattan: bool):
    """The groups (one a k) the plug-in receives for a read of L bases:
    each a list of (n_out, w), Manhattan's D on n_i + w positions and
    Pearson's moments on n_i (fill_directional_index.c's bounds)."""
    rsl = 100 if L < 1000 else L // 10
    di_len = L + 2 * rsl
    groups = []
    for k, max_w in ((1, 20), (3, 80), (5, 10240)):
        ws = []
        w = 5
        while w <= max_w and w < L // 2:
            ws.append(w)
            w *= 2
        passes = [(di_len - w - rsl - k + 1, w) for w in ws]
        passes = [(n + w if manhattan else n, w) for n, w in passes if n > 0]
        if passes:
            groups.append(passes)
    return groups


@pytest.mark.parametrize("manhattan", [False, True], ids=["pearson", "manhattan"])
def test_plug_in_spans_and_counters(tmp_path, manhattan):
    """Two reads of 1,200 and 1,500 bases: mtr.di.finish (and, for
    Manhattan, mtr.di.widen: Pearson's finish reads its int32 moments as
    they are) opens once a group under mtr.di.device (no pinned staging on
    the CPU: no mtr.di.stage or mtr.di.wait), mtr.di.pair once a group
    under mtr.read.di, on the reader thread; the counters are the groups'
    positions, codes and outputs."""
    rng = np.random.default_rng(1515)
    unit = "".join(rng.choice(list("ACGT"), 37))
    lengths = (1200, 1500)
    with open(tmp_path / "two.fasta", "w") as f:
        for i, L in enumerate(lengths):
            flank = "".join(rng.choice(list("ACGT"), (L - 37 * 12) // 2))
            seq = (flank + unit * 12 + flank + "ACGT" * L)[:L]
            f.write(f">r{i}\n{seq}\n")
    TIMERS.record()
    try:
        _out, _ranges, grew = run_device(
            str(tmp_path / "two.fasta"), manhattan,
            tp.TorchHybridDPBatcher(torch.device("cpu"), cell_threshold=1 << 62,
                                    min_device_cells=1 << 62))
    finally:
        spans, _anchors = TIMERS.stop()
    groups = [g for L in lengths for g in di_groups(L, manhattan)]
    n_groups = len(groups)
    assert n_groups == 6
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert len(by_name["mtr.di.device"]) == n_groups
    assert "mtr.di.stage" not in by_name and "mtr.di.wait" not in by_name
    assert ("mtr.di.widen" in by_name) == manhattan
    for name, parent in ((("mtr.di.widen", "mtr.di.device"),) * manhattan
                         + (("mtr.di.finish", "mtr.di.device"),
                            ("mtr.di.pair", "mtr.read.di"))):
        assert len(by_name[name]) == n_groups, name
        for s in by_name[name]:
            p = spans[s.parent]
            assert p.name == parent and s.role == p.role == "reader", (s, p)
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    positions = sum(n for g in groups for n, _ in g)
    codes = sum(max(n + 3 * w - 1 - (w if manhattan else 0) for n, w in g)
                for g in groups)
    assert grew["di_positions"] == positions
    assert grew["di_up_bytes"] == 4 * codes
    assert grew["di_down_bytes"] == (4 if manhattan else 20) * positions


def test_c_summary_prints_the_di_phases_beside_the_stencil():
    """-c: the five DI spans and the three traffic counters follow the
    `DI stencil` line, before the other phases and counters."""
    tm = Timers()
    tm.add("di_device", 1.0)
    for i, name in enumerate(("mtr.di.device", "mtr.di.stage", "mtr.di.wait",
                              "mtr.di.widen", "mtr.di.finish", "mtr.di.pair")):
        tm.add(name, 0.25 * (i + 1))
    tm.add("walks", 2.0)
    for name, n in (("di_positions", 7), ("di_up_bytes", 44), ("di_down_bytes", 140),
                    ("di_pearson_passes", 3)):
        tm.count(name, n)
    out = io.StringIO()
    tm.print_summary(out)
    lines = out.getvalue().splitlines()
    at = lines.index("\t1.000000\tDI stencil")
    assert [ln.split("\t")[2] for ln in lines[at + 1 : at + 9]] == [
        "DI stencil: codes into pinned memory",
        "DI stencil: wait for upload, launch, copy back",
        "DI stencil: int32 outputs widened", "DI stencil: host float64 finish",
        "DI pairing of a k's passes", "di_positions", "di_up_bytes", "di_down_bytes"]
    assert [ln.split("\t")[1] for ln in lines[at + 1 : at + 9]] == [
        "0.500000", "0.750000", "1.000000", "1.250000", "1.500000", "7", "44", "140"]
    assert lines[at + 9] == "\t2.000000\tDBG walks (native)"
    assert "\t3\tdi_pearson_passes" in lines[at + 10:]
