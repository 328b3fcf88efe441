"""Shared by the device-DI read tests (test_torch_pcc_device.py,
test_torch_device_di_reads.py): run_file under the device backend on CPU
tensors over seeded single-tandem-repeat reads of portbench's generator,
held to portbench's NumPy reference, records and DI candidate ranges."""

import io

import torch

from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.config import MTRConfig
from mtr_tpu_torch.utils.timers import TIMERS
from portbench import check
from portbench.generators import single_tr

# long-200x200's unit and error profile, 40 copies, flanks 2,000 + 2,000:
# 11,632 bp a read, every DI pass of k 5 up to w 5,120
PARAMS = dict(unit=200, copies=40, sub_pct=9.7, ins_pct=2.9, del_pct=7.5,
              pre=2000, post=2000)
SEEDS = (2**31 + 15, 2**33 + 7, 404)


def run_device(fasta, manhattan: bool, batcher=None):
    """run_file under the device backend on CPU tensors: its records, each
    read's DI candidate ranges (check.di_ranges) and the counters' growth."""
    ranges = []
    orig = tp.fill_directional_index_with_end

    def fill(arena, input_len, rsl, *a, **kw):
        out = orig(arena, input_len, rsl, *a, **kw)
        ranges.append(check.di_ranges(*out, input_len))
        return out

    before = TIMERS.snapshot()[1]
    tp.fill_directional_index_with_end = fill
    try:
        out = io.StringIO()
        tp.run_file(fasta, MTRConfig(backend="device", manhattan_distance=manhattan,
                                     device_di_threshold=1000), out,
                    batcher=batcher or tp.TorchDPBatcher(torch.device("cpu")))
    finally:
        tp.fill_directional_index_with_end = orig
    after = TIMERS.snapshot()[1]
    return out.getvalue(), ranges, {k: after[k] - before.get(k, 0) for k in after}


def check_one_read(tmp_path, seed: int, manhattan: bool) -> None:
    """One read drawn from `seed` through the device backend (the plain DP
    of TorchDPBatcher on the CPU): its records and DI candidate ranges
    equal the reference's, and the device DI plug-in ran."""
    rec, = single_tr.fasta_records(PARAMS, seed, 1, 0, "r")
    fasta = tmp_path / "one.fasta"
    fasta.write_bytes(rec)
    out, ranges, grew = run_device(str(fasta), manhattan)
    assert grew["di_manhattan_passes" if manhattan else "di_pearson_passes"] > 0
    ref_lines, ref_ranges = check.reference_lines([rec], manhattan)
    assert out.splitlines() == ref_lines and ref_lines
    assert len(ranges) == 1 and check.same_ranges(ranges[0], ref_ranges)
    assert len(ref_ranges[0]) > 0
