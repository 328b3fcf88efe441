"""mTR-compatible command line of the PyTorch port (the flags of
mtr_tpu/cli.py, main.c:40-123).

    python -m mtr_tpu_torch.cli --backend hybrid reads.fasta

--backend: oracle (bit-exact NumPy path), host (native C++ DP engine),
hybrid (host engine + torch DP kernels on the CUDA card), device (every
DP job, long-read DI and the DBG walks on the card: mtr_tpu's default
device configuration), auto (the default: hybrid).  auto, hybrid and
device need a CUDA card and exit 1 where torch finds none; the CPU is
reached only by asking for host or oracle.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from mtr_tpu_torch.config import MTRConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mtr-tpu-torch",
        description="Tandem repeat detection on PyTorch + CUDA "
                    "(mTR-compatible)",
    )
    p.add_argument("-a", action="store_true", dest="print_alignment",
                   help="Output the alignment between the input sequence and predicted tandem repeat.")
    p.add_argument("-c", action="store_true", dest="print_computation_time",
                   help="Print the computation time of each step.")
    p.add_argument("-m", type=float, default=0.6, dest="min_match_ratio", metavar="ratio",
                   help="Give a minimum match ratio ranging from 0 to 1.")
    p.add_argument("-p", action="store_false", dest="manhattan",
                   help="Use Pearson's correlation coefficient distance in place of Manhattan distance.")
    p.add_argument("--cluster", action="store_true",
                   help="after all reads, run the cross-read unit clustering "
                        "stage (legacy phase 2) and print '#CLUSTER repID "
                        "groupFreq unit' lines to stdout")
    p.add_argument("--backend", choices=["oracle", "device", "host", "hybrid", "auto"], default="auto",
                   help="oracle = bit-exact NumPy path (CPU); host = native C++ DP "
                        "engine (CPU); hybrid = host engine + CUDA DP kernels; auto = "
                        "hybrid; device = every DP job, DI and the DBG walks on the "
                        "card.  auto, hybrid and device need a CUDA card.")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="resume file: skips reads already emitted by a previous run.")
    p.add_argument("--no-strict", action="store_false", dest="strict",
                   help="skip failing read batches instead of aborting.")
    p.add_argument("fasta", help="input FASTA file")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not (0 <= args.min_match_ratio <= 1):
        print("The input minimum match ratio must range from 0 to 1.", file=sys.stderr)
        return 1
    cfg = MTRConfig(
        min_match_ratio=args.min_match_ratio,
        print_alignment=args.print_alignment,
        print_computation_time=args.print_computation_time,
        manhattan_distance=args.manhattan,
        backend=args.backend,
    )
    if not os.path.exists(args.fasta):
        print(f"fatal error: cannot open {args.fasta}", file=sys.stderr)
        return 1
    if args.cluster and args.checkpoint:
        print("--cluster needs every record of the run; it cannot be "
              "combined with --checkpoint resume", file=sys.stderr)
        return 1
    t0 = time.time()
    out = sys.stdout
    from mtr_tpu_torch.io.fasta import FatalInputError
    from mtr_tpu_torch.utils.encoding import InvalidBaseError
    from mtr_tpu_torch.pipeline import BackendUnavailable

    try:
        collected = [] if args.cluster else None
        if cfg.backend == "oracle":
            from mtr_tpu_torch.oracle.pipeline import run_file_oracle

            for _read, records in run_file_oracle(args.fasta, cfg):
                for rec in records:
                    out.write(rec.format_record() + "\n")
                    if collected is not None:
                        collected.append(rec)
                    if cfg.print_alignment:
                        from mtr_tpu_torch.pretty import pretty_print_alignment
                        out.write("\n")
                        pretty_print_alignment(_read.codes, rec, out)
                out.flush()
        else:
            from mtr_tpu_torch.pipeline import run_file

            run_file(args.fasta, cfg, out, checkpoint=args.checkpoint,
                     strict=args.strict,
                     record_sink=collected.append if args.cluster else None)
        if args.cluster:
            from mtr_tpu_torch.clustering import cluster_repeats

            device = "cpu" if cfg.backend in ("host", "oracle") else "cuda"
            for c in cluster_repeats(collected, cfg.min_match_ratio,
                                     device=device):
                out.write(
                    f"#CLUSTER\t{c.rep_id}\t{c.group_freq}\t"
                    f"{c.record.read_id}\t{c.record.string}\n"
                )
    except (InvalidBaseError, FatalInputError, BackendUnavailable) as e:
        # reference behavior: diagnostic to stderr + EXIT_FAILURE
        # (handle_one_file.c:185,244)
        print(str(e), file=sys.stderr)
        return 1
    if cfg.print_computation_time:
        from mtr_tpu_torch.utils.timers import TIMERS

        TIMERS.add("all", time.time() - t0)
        TIMERS.print_summary(sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
