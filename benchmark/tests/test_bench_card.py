"""On the card, at each cell's own size: the program's readings pass the
cell's limits and the control's (the reference in the next lower precision
in the program's place; in the stream cell serving its own greedy tokens)
fail one, as does a training cell's step with half of each batch left out.
Run on a machine with an H100:

    python3 -m pytest -q benchmark/tests/test_bench_card.py
"""

import json
import os

import pytest

from benchmark.tests.tiny import REPO

pytestmark = pytest.mark.cuda


def _cells():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_control_fails_where_the_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark.harness import load_json
    from benchmark.tools import readings

    params = load_json(REPO, "benchmark", "workloads", cell + ".json")
    read = readings.train_readings if params["traffic"] == "train" else readings.stream_readings
    out = read(cell, 2**31 + 101, torch.device("cuda"))
    lim = params["limits"]
    assert all(out["program"][k] <= lim[k] for k in lim), out
    assert any(out["control"][k] > lim[k] for k in lim), out
    if "half_batch" in out:
        assert any(out["half_batch"][k] > lim[k] for k in lim), out
