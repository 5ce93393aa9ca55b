"""No module the benchmark runs is JAX's or the JAX package's, and the
reference imports nothing of the program: checked in fresh interpreters, by
each loaded module's top-level name taken whole, and on the reference's
sources."""

import ast
import glob
import json
import os
import subprocess
import sys

from benchmark.tests.tiny import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "tpuasr"}


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(sub: str) -> list:
    return sorted(glob.glob(os.path.join(REPO, "benchmark", sub, "*.py")))


def test_no_jax_anywhere_the_benchmark_runs():
    files = [p for d in ("traffic", "metrics", "kernels", "flops") for p in _modules(d)]
    code = ("import benchmark.harness, benchmark.program, benchmark.weights\n"
            "import benchmark.reference.train_check, benchmark.reference.stream_check\n"
            "import benchmark.reference.greedy, benchmark.reference.trace\n"
            "import tpuasr_torch.train, tpuasr_torch.decode, tpuasr_torch.audio\n"
            "from benchmark.harness import load_module\n"
            + "".join(f"load_module({os.path.basename(os.path.dirname(p))!r}, "
                      f"{os.path.basename(p)[:-3]!r})\n" for p in files))
    loaded = _loaded_after(code)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN
    assert "tpuasr_torch" in loaded  # the name 'tpuasr' is compared whole


def test_reference_imports_nothing_of_the_program():
    mods = [os.path.basename(p)[:-3] for p in _modules("reference") if not p.endswith("__.py")]
    loaded = _loaded_after("".join(f"import benchmark.reference.{m}\n" for m in mods))
    assert not loaded & (FORBIDDEN | {"tpuasr_torch"})
    for path in _modules("reference"):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {"tpuasr_torch"}, (path, n)
