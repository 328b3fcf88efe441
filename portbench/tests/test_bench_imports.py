"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port either.  Module names compare by their whole
top-level name: mtr_tpu_torch is not mtr_tpu."""

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench.run import forbidden_loaded

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_SIDE = {"jax", "jaxlib", "flax", "mtr_tpu"}


@pytest.mark.parametrize("names, found", [
    (["mtr_tpu_torch", "mtr_tpu_torch.pipeline", "numpy", "torch"], []),
    (["mtr_tpu.cli"], ["mtr_tpu"]),
    (["mtr_tpu"], ["mtr_tpu"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["jax_helpers", "mtr_tpu_torchx", "flaxen"], []),
])
def test_forbidden_names_compare_whole(names, found):
    assert forbidden_loaded(names) == found


def loaded_tops(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_either_package():
    tops = loaded_tops("import portbench.check, portbench.reference.read, "
                       "portbench.control; portbench.check.reference_lines")
    assert not tops & (JAX_SIDE | {"mtr_tpu_torch", "torch"})


def test_the_harness_loads_no_jax():
    tops = loaded_tops("import portbench.run, portbench.trace, portbench.manifest, "
                       "portbench.roofline\nfrom mtr_tpu_torch import pipeline")
    assert not tops & JAX_SIDE


def test_no_source_of_the_benchmark_imports_jax():
    for dirpath, _dirs, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                         else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in JAX_SIDE, (f, n)
                    if "reference" in dirpath:
                        assert n.split(".")[0] not in ("mtr_tpu_torch", "torch"), (f, n)
