"""Run one cell of the port's benchmark once and print one JSON line:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout holding `tpuasr_torch`. Needs the CUDA card(s)
the cell asks for; exits 2 without a result otherwise. The port builds its
kernels into `build/tpuasr_torch/` of the checkout; the caches that torch
could use are set to fixed directories under `build/benchmark/`. The
process runs one intra-op thread: its host work is the dispatch.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[0] = ROOT

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
