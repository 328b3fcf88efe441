"""Multi-process orchestration (counterpart of
mtr_tpu/parallel/distributed.py).

Reads are embarrassingly parallel, so the multi-process strategy is plain
data parallelism with deterministic output order:

  * every process streams the same FASTA and processes reads whose index
    satisfies idx % process_count == process_index (round-robin keeps
    per-process load balanced across length distributions);
  * the arena-reuse quirks (stale buffer contents) belong to one
    sequential run, so every process replays the arena over ALL reads
    (cheap: one memcpy per read) and each process's per-read buffers match
    the single-process run bit for bit;
  * records are written to per-process files; merge_outputs interleaves
    them back into single-process order.

Initialization uses torch.distributed (gloo) when RANK and WORLD_SIZE are
in the environment; otherwise there is one process.
"""

from __future__ import annotations

import datetime
import os

from mtr_tpu_torch.config import DEFAULT_CONFIG, MTRConfig


def init_distributed(timeout_s: float | None = None) -> tuple[int, int]:
    """Returns (process_index, process_count).

    With RANK and WORLD_SIZE (and MASTER_ADDR / MASTER_PORT) in the
    environment, joins the gloo process group: what crosses processes are
    small host arrays of records, and NCCL refuses two ranks on one card.
    Where there is a card, the process's CUDA device becomes LOCAL_RANK (or
    RANK) modulo the number of cards.  Without those variables: (0, 1).
    A failing initialisation raises; nothing degrades to one process."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return 0, 1
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        kwargs = {}
        if timeout_s is not None:
            kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group("gloo", **kwargs)
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        torch.cuda.set_device(local % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


def run_file_sharded(
    path: str,
    out_path_prefix: str,
    cfg: MTRConfig = DEFAULT_CONFIG,
    process_index: int | None = None,
    process_count: int | None = None,
    checkpoint: bool = False,
    strict: bool = True,
):
    """Process this process's share of the reads; writes
    {out_path_prefix}.part{pid} plus a .meta file with the read indices
    handled (for the deterministic merge).

    Delegates to pipeline.run_file with a round-robin read filter, so
    the multi-process path inherits the single-process features verbatim:
    compute/IO overlap thread, per-batch failure isolation
    (strict=False), and exact checkpoint/resume (checkpoint=True resumes
    from {out_path_prefix}.ckpt{pid}, appending to the part files)."""
    from mtr_tpu_torch.pipeline import run_file

    if process_index is None or process_count is None:
        process_index, process_count = init_distributed()

    ckpt_path = f"{out_path_prefix}.ckpt{process_index}" if checkpoint else None
    mode = "a" if checkpoint and os.path.exists(ckpt_path or "") else "w"
    out_f = open(f"{out_path_prefix}.part{process_index}", mode)
    meta_f = open(f"{out_path_prefix}.meta{process_index}", mode)
    try:
        run_file(
            path,
            cfg,
            out_f,
            checkpoint=ckpt_path,
            strict=strict,
            read_filter=lambda r: r % process_count == process_index,
            read_meta=lambda r, n: (
                meta_f.write(f"{r}\t{n}\n"), meta_f.flush())[0],
        )
    finally:
        out_f.close()
        meta_f.close()


def merge_outputs(out_path_prefix: str, process_count: int, out) -> None:
    """Deterministic single-process-order merge of per-process outputs."""
    parts = []
    for pid in range(process_count):
        lines = open(f"{out_path_prefix}.part{pid}").read().splitlines(True)
        meta = [
            (int(a), int(b))
            for a, b in (
                ln.split("\t") for ln in open(f"{out_path_prefix}.meta{pid}")
            )
        ]
        pos = 0
        for rid, n in meta:
            parts.append((rid, lines[pos : pos + n]))
            pos += n
    parts.sort(key=lambda t: t[0])
    for _rid, lines in parts:
        out.writelines(lines)
