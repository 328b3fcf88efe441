"""Entry points of the port (counterpart of __graft_entry__.py).

entry()             -> (step, example_args): one forward step of the counts
                       kernel, wrap_dp_counts at (8, 128, 256).
dryrun_multichip(n) -> builds an n-card mesh (raising where there are fewer
                       cards), runs that step with the batch cut over it,
                       then the whole read pipeline under the one-device
                       and the sharded batcher, and compares the bytes.
"""

from __future__ import annotations

import io
import tempfile

import numpy as np

from mtr_tpu_torch.parallel.mesh import make_mesh, sharded_wrap_dp_step

_B, _U, _R = 8, 128, 256


def _example_args(b=_B, u_pad=_U, r_pad=_R):
    rng = np.random.default_rng(0)
    unit = rng.integers(0, 4, 7)
    rep = np.tile(unit, r_pad // 7 + 1)[: r_pad - 10]
    reps = np.full((b, r_pad), -1, dtype=np.int32)
    units = np.full((b, u_pad), -2, dtype=np.int32)
    reps[:, : len(rep)] = rep
    units[:, :7] = unit
    scal = np.zeros((b, 8), dtype=np.int32)
    scal[:, 0] = len(rep)
    scal[:, 1] = 7
    scal[:, 2:5] = (1, 1, 3)
    return scal, reps, units


def entry(device="cuda"):
    """Forward step: the counts kernel (fill and traceback counts in one
    launch) on `device`, step(scal, rep, unit) -> (counts, counts[:, 7:])."""
    mesh = make_mesh(devices=[device])
    return sharded_wrap_dp_step(mesh, _B, _U, _R), _example_args()


def sharded_pipeline_outputs(mesh) -> tuple[str, str]:
    """The whole read pipeline (DI, walks, wrap-DP, polish, chaining) on a
    small set whose repeats reach the polish rounds (unit 20 x 10 copies:
    coverage in [5, 20], period > 5), under the one-device batcher on the
    mesh's first device and under the sharded batcher -> both outputs."""
    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.pipeline import (
        ShardedTorchDPBatcher,
        TorchDPBatcher,
        run_file,
    )
    from mtr_tpu_torch.testutil.rand_seq import write_fasta

    cfg = MTRConfig(backend="device", reads_per_batch=4, use_native=False)

    def run_with(batcher) -> str:
        buf = io.StringIO()
        run_file(fa, cfg, buf, batcher=batcher)
        return buf.getvalue()

    with tempfile.TemporaryDirectory() as td:
        fa = td + "/dry.fasta"
        write_fasta(fa, td + "/dry.units", 20, 10, 2.0, 2.0, 2.0,
                    200, 200, 3, seed=7)
        return (run_with(TorchDPBatcher(mesh.devices[0])),
                run_with(ShardedTorchDPBatcher(mesh)))


def dryrun_multichip(n_devices: int) -> None:
    """Two stages: (1) the counts step over an n-card mesh; (2) the whole
    read pipeline with every DP launch cut over the mesh, byte-compared
    with the one-device run.  make_mesh raises where the cards do not
    exist, so this cannot pass on a machine with fewer; it does not reuse
    one card."""
    mesh = make_mesh(n_devices)
    b = max(_B, n_devices * _B)
    b = (b // n_devices) * n_devices
    _res, best = sharded_wrap_dp_step(mesh, b, _U, _R)(*_example_args(b=b))
    if not bool((best[:, 1] > 0).all()):
        raise RuntimeError("dryrun produced no positive DP scores")
    single, sharded = sharded_pipeline_outputs(mesh)
    if not single:
        raise RuntimeError("dryrun pipeline produced no records")
    if single != sharded:
        raise RuntimeError("sharded pipeline diverged from single-device")
