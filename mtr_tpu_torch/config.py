"""Framework configuration.

One dataclass mirrors every compile-time constant of the reference
(`mTR.h:30-58`) plus its four CLI flags (`main.c:59-84`), so parity runs
can be configured without recompilation and production runs can relax
the reference limits (e.g. larger reads, more devices).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MTRConfig:
    # ---- reference compile-time constants (mTR.h:30-58) ----
    max_input_length: int = 1_000_000   # MAX_INPUT_LENGTH
    min_match_ratio: float = 0.6        # MIN_MATCH_RATIO (flag -m)
    min_period: int = 2                 # MIN_PERIOD
    max_period: int = 500               # MAX_PERIOD
    min_num_freq_unit: int = 5          # MIN_NUM_FREQ_UNIT
    alignment_width_printing: int = 50  # ALIGNMENT_WIDTH_PRINTING
    max_len_overlapping: int = 10       # MAX_LEN_overlapping
    min_window: int = 5                 # MIN_WINDOW
    max_window: int = 10240             # MAX_WINDOW
    min_kmer: int = 5                   # minKmer
    max_kmer: int = 15                  # maxKmer
    max_tiebreaks: int = 1024           # MAX_tiebreaks
    min_jaccard_index: float = 0.98     # MIN_jaccard_index
    blk: int = 4096                     # BLK (input buffer / readID width)
    wrap_dp_size: int = 200_000_000     # WrapDPsize (capacity guard)
    count_max_kmer: int = 6             # count_maxKmer (dense-count cutoff)
    max_id_length: int = 1000           # MAX_ID_LENGTH

    # ---- reference CLI flags (main.c:59-84) ----
    print_alignment: bool = False       # -a
    print_computation_time: bool = False  # -c
    manhattan_distance: bool = True     # default; -p selects Pearson

    # ---- framework-only knobs (no reference equivalent) ----
    backend: str = "auto"     # "oracle" | "device" | "host" | "hybrid" | "auto"
    reads_per_batch: int = 64  # device pipeline batching granularity
    # long-read workloads also cut batches by total bases so the
    # two-stage pipeline (walks overlapping the previous batch's device
    # DP) engages within a file of few huge reads
    bases_per_batch: int = 1 << 19
    use_native: bool = True    # use the C++ host runtime when available
    # reads at least this long compute their DI passes on device when
    # backend == "device" (the sliding histograms dominate long reads;
    # short reads lose to dispatch latency)
    device_di_threshold: int = 65_536
    pipeline_depth: int = 2    # read batches in flight (overlaps device pulls)
    # backend == "device" runs DBG k-mer counting + greedy walks on
    # device by default (ops/dbg_device.py); per-query host fallback
    # keeps parity.  The walk/lookahead loops are BOUNDED fori_loops
    # (masked no-ops after convergence), so proxied TPU runtimes no
    # longer see data-dependent while_loops (their worker watchdogs
    # killed long ones).  host/hybrid backends keep the native engine.
    use_device_walks: bool = True

    def k_sweep(self, w: int) -> range:
        """k-mer range for the DBG sweep, by detected window width.

        Mirrors handle_one_read.c:104-118.
        """
        if w < 100:
            return range(self.min_kmer - 3, self.max_kmer - 5 + 1)
        if w < 1000:
            return range(self.min_kmer - 3, self.max_kmer - 3 + 1)
        return range(self.min_kmer, self.max_kmer + 1)

    def di_max_w(self, k: int) -> int:
        """Max sliding-window width for DI pass with k-mer size k.

        Mirrors fill_directional_index.c:563-570.
        """
        if k == 1:
            return 20
        if k == 3:
            return 80
        return self.max_window


DEFAULT_CONFIG = MTRConfig()
