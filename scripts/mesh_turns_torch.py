"""The bench set under the port's device backend (host walks), one device
and under ShardedTorchDPBatcher on two slots of the one card, in turns in
one process, with the card's memory state printed between the runs: empty,
with 40 GiB held, with a device-whole run's recorded launches held, and
after the allocator's cache was emptied.  It drives chip_smoke.py's own
phases (main_path, device_path, mesh_path, device_walk_path), which print
the seconds.  Needs a CUDA card; run from the repository root:

    python3 scripts/mesh_turns_torch.py
"""

import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    def mem(tag):
        st = torch.cuda.memory_stats()
        print(f"[{tag}] reserved {torch.cuda.memory_reserved() / 2**30:.2f} "
              f"GiB, allocated {torch.cuda.memory_allocated() / 2**30:.2f} "
              f"GiB, alloc_retries {st.get('num_alloc_retries')}, segments "
              f"{st.get('segment.all.allocated')}", flush=True)

    sys.meta_path.insert(0, cs._NoJax())
    cs.preflight()
    build = os.path.join(HERE, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        fasta, golden, hybrid, host, _, _ = cs.main_path(tmp)
        one = cs.device_path(fasta, golden, hybrid, host)
        mem("after one device")
        for n in (1, 2):
            cs.mesh_path(fasta, golden, one)
            mem(f"after mesh {n}")
        one = cs.device_path(fasta, golden, hybrid, host)
        hold = torch.empty(40 << 30, dtype=torch.uint8, device="cuda")
        mem("holding 40 GiB")
        cs.mesh_path(fasta, golden, one)
        cs.device_path(fasta, golden, hybrid, host)
        del hold
        _, spies = cs.device_walk_path(fasta, golden)
        mem("after the device-whole run, its launches held")
        cs.mesh_path(fasta, golden, one)
        del spies
        torch.cuda.empty_cache()
        cs.mesh_path(fasta, golden, one)
        mem("after mesh 5, cache emptied")
    return 0


if __name__ == "__main__":
    sys.exit(main())
