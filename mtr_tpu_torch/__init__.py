"""mtr_tpu_torch — the PyTorch and CUDA port of mtr_tpu.

Same detection, same output.  The package stands alone: it keeps its own
copies of mtr_tpu's host stages (config, records, FASTA reading, the
oracle, chaining, the clustering stage, the bench-set generator) under
the same module names, its own binding to the C++ host engine
(native.py, built from native/mtr_host.cpp into its own directory), and
the device leg, which runs on an NVIDIA Hopper card through kernels
written by hand in CUDA C++.  It imports torch, and nothing of jax or of
mtr_tpu.

Layering (top to bottom):
  cli        — mTR-compatible command line
  pipeline   — host DP batcher, torch DP batcher, hybrid host/device
               engine, walk stage and wave loop, per-file main loop
  clustering — cross-read unit clustering (--cluster), near matrix on torch
  native     — ctypes binding to the C++ host engine
  oracle/, chaining, records, config, io/, utils/, pretty, testutil/
             — copies of mtr_tpu's host modules
  ops/       — the device ops (wrap-around DP in counts and consensus
               mode, DBG walks, walk pre-filter, DI) with their plain
               PyTorch versions, and the kernels' build and binding
  csrc/      — CUDA C++ kernels (sm_90a)
"""

__version__ = "0.1.0"

from mtr_tpu_torch.config import MTRConfig  # noqa: F401


def find_repeats(sequences, config: "MTRConfig | None" = None):
    """Programmatic entry point: detect tandem repeats in sequences.

    sequences: a str/bytes DNA sequence, or an iterable of them (or of
    (read_id, sequence) pairs).  Returns a list of per-read lists of
    RepeatRecord, exactly as mtr_tpu.find_repeats does, computed by this
    package's pipeline.
    """
    import io
    import os
    import tempfile

    if isinstance(sequences, (str, bytes)):
        sequences = [sequences]
    cfg = config or MTRConfig()
    from mtr_tpu_torch.pipeline import run_file

    order: list[str] = []
    with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
        path = f.name
        for idx, item in enumerate(sequences):
            if isinstance(item, tuple):
                rid, seq = item
            else:
                rid, seq = str(idx), item
            if isinstance(seq, bytes):
                seq = seq.decode()
            order.append(rid)
            f.write(f">{rid}\n{seq}\n")
    try:
        per_read: dict[str, list] = {rid: [] for rid in order}

        def sink(rec):
            per_read[rec.read_id].append(rec)

        run_file(path, cfg, io.StringIO(), record_sink=sink)
        return [per_read[rid] for rid in order]
    finally:
        os.unlink(path)
