"""Per-read oracle orchestrator (handle_one_read.c:77-266).

find_tandem_repeat sweeps k over a width-dependent range and keeps the
best match ratio subject to the acceptance filters; handle_one_tr walks
candidate ranges in position order, suppresses ranges subsumed by an
accepted repeat, and chains the accepted records.
"""

from __future__ import annotations

import numpy as np

from mtr_tpu_torch.config import MTRConfig, DEFAULT_CONFIG
from mtr_tpu_torch.records import RepeatRecord, ratio_less
from mtr_tpu_torch.oracle.arena import Arena
from mtr_tpu_torch.oracle.directional_index import fill_directional_index_with_end
from mtr_tpu_torch.oracle.dbg import (
    search_de_bruijn_graph,
    MIN_PERIOD,
    MIN_NUM_FREQ_UNIT,
)
from mtr_tpu_torch.oracle.wrap_dp import _assign
from mtr_tpu_torch.oracle.consensus import revise_representative_unit
from mtr_tpu_torch.chaining import chain_records


def find_tandem_repeat_sub(arena, input_len, qs, qe, rr, cfg: MTRConfig) -> None:
    """handle_one_read.c:77-100."""
    found, _table = search_de_bruijn_graph(
        arena.org_input, input_len, qs, qe, rr, cfg.min_match_ratio
    )
    if found == 0:
        _assign(rr, RepeatRecord())
        return
    if rr.rep_period * (qe - qs + 1) > cfg.wrap_dp_size:
        # reference warns and clears (handle_one_read.c:89-91)
        _assign(rr, RepeatRecord())
        return
    coverage = rr.repeat_len // rr.rep_period
    if 5 <= coverage <= 20 and rr.rep_period > 5:
        revise_representative_unit(arena.org_input, rr, input_len)


def find_tandem_repeat(arena, qs, qe, w, read_id, input_len, rr, cfg: MTRConfig) -> None:
    """handle_one_read.c:102-154 — the k sweep."""
    max_ratio = -1.0
    for k in cfg.k_sweep(w):
        tmp = RepeatRecord()
        tmp.read_id = read_id
        tmp.input_len = input_len
        tmp.kmer = k
        find_tandem_repeat_sub(arena, input_len, qs, qe, tmp, cfg)
        r = tmp.match_ratio()
        if (
            ratio_less(max_ratio, r)
            and cfg.min_match_ratio <= r
            and tmp.num_freq_unit > MIN_NUM_FREQ_UNIT
            and MIN_PERIOD <= tmp.rep_period
        ):
            max_ratio = r
            _assign(rr, tmp)


def handle_one_read_oracle(
    arena: Arena,
    read_id: str,
    input_len: int,
    cfg: MTRConfig = DEFAULT_CONFIG,
    di_compute_k=None,
) -> list[RepeatRecord]:
    """handle_one_read.c:190-266 — returns the chained records."""
    min_rsl = 100
    rsl = min_rsl if input_len < min_rsl * 10 else input_len // 10

    di, di_end, di_w = fill_directional_index_with_end(
        arena, input_len, rsl, manhattan=cfg.manhattan_distance,
        di_compute_k=di_compute_k, use_native=cfg.use_native,
    )

    accepted: list[RepeatRecord] = []
    for qs in range(input_len):
        qe = int(di_end[qs])
        if -1 < qe < input_len:
            w = int(di_w[qs])
            rr = RepeatRecord()
            find_tandem_repeat(arena, qs, qe, w, read_id, input_len, rr, cfg)
            if rr.repeat_len > 0 and rr.rep_start + MIN_PERIOD * MIN_NUM_FREQ_UNIT < rr.rep_end:
                accepted.append(rr)
                # suppress pending ranges ending inside the accepted repeat
                for i in range(rr.rep_start, rr.rep_end):
                    if di[i] != -1 and di_end[i] < rr.rep_end:
                        di[i] = -1.0
                        di_end[i] = -1
                        di_w[i] = -1
    return chain_records(accepted)


def run_file_oracle(path: str, cfg: MTRConfig = DEFAULT_CONFIG):
    """handle_one_file equivalent; yields chained records per read."""
    from mtr_tpu_torch.io.fasta import iter_fasta

    arena = Arena(cfg.max_input_length)
    for read in iter_fasta(path, cfg.max_input_length):
        arena.load_read(read.codes)
        yield read, handle_one_read_oracle(arena, read.read_id, read.length, cfg)
