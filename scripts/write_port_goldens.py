"""Write the goldens that hold the PyTorch port to the JAX package where
no JAX runs (the card's machine): each set's FASTA is made from its seed by
the port's generators, and each `.out` is the stdout of

    python -m mtr_tpu.cli --backend host [flags] <fasta>

Only the `.out` files are kept (tests/golden/); every reader regenerates
the FASTA from `SETS` below.  Needs JAX (mtr_tpu imports it); run from the
repo root:

    JAX_PLATFORMS=cpu python scripts/write_port_goldens.py [name ...]
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from mtr_tpu_torch.testutil.golden_sets import SETS, write_set  # noqa: E402


def main(argv) -> int:
    names = argv or list(SETS)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            flags = SETS[name][1]
            fasta = write_set(name, tmp)
            cmd = [sys.executable, "-m", "mtr_tpu.cli", "--backend", "host",
                   *flags, fasta]
            t0 = time.time()
            out = subprocess.run(cmd, cwd=ROOT, env=env, check=True,
                                 capture_output=True, text=True).stdout
            dest = os.path.join(ROOT, "tests", "golden", name + ".out")
            with open(dest, "w") as f:
                f.write(out)
            print(f"{name}.out: {len(out.splitlines())} lines, "
                  f"{time.time() - t0:.1f} s: python {' '.join(cmd[1:-1])} "
                  f"{os.path.basename(fasta)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
