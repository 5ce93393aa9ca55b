"""Each traffic kind end to end at a tiny size on the CPU, through the
port's plain versions, in a copy of the benchmark to which the tiny
configuration and cells were added as files only."""

import pytest

from benchmark.tests.tiny import run_cpu, run_tree


@pytest.mark.parametrize("cell,metrics", [
    ("tiny_rnnt.train.b4", {"setup_s", "train_audio_s_per_s"}),
    ("tiny_rnnt.stream.s6", {"setup_s", "stream_audio_s_per_s", "chunk_latency_p95_ms"}),
    ("tiny_u2pp.train.b4", {"setup_s", "train_audio_s_per_s"}),
])
def test_cell_runs_and_is_correct(in_tree, cell, metrics):
    r = run_cpu(cell)
    assert r["correct"] is True, r["checks"]
    assert set(r["metrics"]) == metrics
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell,metrics", [
    ("tiny_rnnt.train.b4", {"dispatch_ms.train", "mfu.train"}),
    ("tiny_rnnt.stream.s6", {"mfu.stream"}),
    ("tiny_u2pp.train.b4", {"dispatch_ms.train", "mfu.train"}),
])
def test_traced_run_on_the_cpu(in_tree, cell, metrics):
    """The CPU has no device trace: the trace's metrics are left out, those
    of the host clock reported."""
    r = run_cpu(cell, trace=1)
    assert r["correct"] is True
    assert set(r["metrics"]) == metrics
    assert "busy_s" not in r["device"]


def test_a_new_cell_runs_after_files_only(tree):
    """The copy's own harness, in a process of its own, finds the added
    configuration, cells and FLOP count by name."""
    rc, r, err = run_tree(tree, "tiny_rnnt.stream.s6")
    assert rc == 0 and r is not None, err[-2000:]
    assert r["correct"] is True and "stream_audio_s_per_s" in r["metrics"]
