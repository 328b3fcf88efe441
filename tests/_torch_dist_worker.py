"""Worker of the port's real multi-process runs (tests/test_torch_distributed.py
and chip_smoke.py's two-process phase).

Usage: RANK=<r> WORLD_SIZE=<n> MASTER_ADDR=127.0.0.1 MASTER_PORT=<port> \\
       python tests/_torch_dist_worker.py <prefix> <fasta> [backend]

Joins the gloo group through init_distributed, processes this rank's
round-robin share of the reads with run_file_sharded (backend `host` unless
given), all-gathers every rank's records with gather_records_multihost and
writes their packed columns to <prefix>.gather<rank>.npy.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    prefix, fasta = sys.argv[1], sys.argv[2]
    backend = sys.argv[3] if len(sys.argv) > 3 else "host"

    import numpy as np

    from mtr_tpu_torch import pipeline
    from mtr_tpu_torch.clustering import (
        gather_records_multihost,
        pack_records,
    )
    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.parallel.distributed import (
        init_distributed,
        run_file_sharded,
    )

    rank, world = init_distributed(timeout_s=100)
    assert (rank, world) == (int(os.environ["RANK"]),
                             int(os.environ["WORLD_SIZE"])), (rank, world)

    # run_file_sharded hands no records back: keep them as run_file emits
    # them, for the gather
    records: list = []
    run_file = pipeline.run_file
    pipeline.run_file = lambda *a, **kw: run_file(
        *a, record_sink=records.append, **kw)
    t0 = time.perf_counter()
    run_file_sharded(fasta, prefix, MTRConfig(backend=backend),
                     process_index=rank, process_count=world)
    dt = time.perf_counter() - t0
    gathered = gather_records_multihost(records)
    np.save(f"{prefix}.gather{rank}.npy", pack_records(gathered))
    print(f"rank {rank} of {world}: {len(records)} records of "
          f"{len(gathered)}, run_file_sharded {dt:.3f} s", flush=True)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
