"""The trace arithmetic on a hand-made Chrome trace: busy time as the union
of device intervals, idle time by the span it falls in, kernel families,
the kernels' roofline sum and its launch cross-check, and the metric
readers, which report nothing where there is nothing to read."""

import json

import pytest

from benchmark import harness
from benchmark.harness import PEAKS, kernel_bound, load_module
from benchmark.reference import trace as tr


def _trace(tmp_path):
    ev = [
        {"ph": "X", "cat": "kernel", "name": "void ffn_fwd_tc_kernel<4, 2>(float*)", "ts": 100,
         "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "(anonymous namespace)::ffn_fwd_sum_kernel(int)",
         "ts": 250, "dur": 150},  # overlaps the first: the union is 100-400
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1200, "dur": 100},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 10},
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    t = tr.load(str(p))
    t["spans"] = [("readback", 1000, 1500), ("step", 0, 1000)]  # the harness's, any order
    return t


def test_union_idle_and_families(tmp_path):
    r = tr.reduce(_trace(tmp_path))
    assert r["window_s"] == pytest.approx(1500e-6)
    assert r["busy_s"] == pytest.approx(400e-6)  # 100-400 and 1200-1300
    gaps = dict(r["idle_gaps"])
    assert gaps["step"] == pytest.approx(700e-6)  # 0-100 and 400-1000
    assert gaps["readback"] == pytest.approx(400e-6)  # 1000-1200 and 1300-1500
    fam = r["families"]
    assert fam["ffn_fwd_tc_kernel"] == [pytest.approx(200e-6), 1]
    assert fam["ffn_fwd_sum_kernel"][1] == 1
    assert tr.kernel_family("void fbank_tc_kernel<5, 1, 4>(float const*)") == "fbank_tc_kernel"


def test_no_device_events_reads_nothing(tmp_path):
    p = tmp_path / "e.json"
    p.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 5}]}))
    t = tr.load(str(p))
    assert t["device"] == []
    t["spans"] = [("step", 0, 5)]
    assert tr.reduce(t) is None
    assert tr.reduce(_trace(tmp_path) | {"spans": []}) is None  # no host span to measure from


def test_kernel_bound_and_its_cross_check(tmp_path):
    reduced = tr.reduce(_trace(tmp_path))
    ctx = {"ffn_rows": 1024, "d": 256, "ffn": 1024, "dtype": "bfloat16", "dropout": False}
    k = load_module("kernels", "ffn_fwd")
    got = kernel_bound([(ctx, {"ffn_fwd": 1})], reduced, PEAKS, print)
    assert got["bound_s"] == pytest.approx(k.bound_s(k.shape(ctx), PEAKS))
    assert got["device_s"] == pytest.approx(350e-6)
    # launched twice, one launch's events missing from the trace: nothing
    assert kernel_bound([(ctx, {"ffn_fwd": 2}), (ctx, {"ffn_fwd": 1})], reduced, PEAKS,
                        print) is None
    assert kernel_bound([(ctx, {"fbank_tc": 3})], reduced, PEAKS, print) is None  # a route


@pytest.mark.parametrize("name", ["dispatch_ms.train", "mfu.train", "kernel_roofline.train",
                                  "device_idle.train", "mfu.stream", "kernel_roofline.stream",
                                  "device_idle.stream"])
def test_readers_report_nothing_without_their_inputs(name):
    assert load_module("metrics", name).read({}) is None


def test_readers_values():
    r = {"unit": "step", "dispatch_s": [0.1, 0.3], "model_flops": 989e12, "window_s": 2.0,
         "peak_flops": 989e12, "kernels": {"bound_s": 1.0, "device_s": 4.0},
         "trace": {"window_s": 2.0, "busy_s": 1.5}}
    read = lambda n: load_module("metrics", n).read(r)
    assert read("dispatch_ms.train") == pytest.approx(200.0)
    assert read("mfu.train") == pytest.approx(50.0)
    assert read("kernel_roofline.train") == pytest.approx(25.0)
    assert read("device_idle.train") == pytest.approx(25.0)
    assert read("mfu.stream") is None  # another cell's unit
    names = lambda section: {m["name"] for m in harness.metric_entries(
        json.load(open(harness.ROOT + "/BENCHMARK.json")), "online_rnnt.train.b128", section)}
    assert names("end_to_end") == {"setup_s", "train_audio_s_per_s"}
    assert names("per_layer") == {"dispatch_ms.train", "mfu.train", "kernel_roofline.train",
                                  "device_idle.train"}


def test_spans_are_timed_only_while_a_part_is_profiled():
    h = harness.Harness({}, {"config": "online_rnnt"}, {}, {}, 1, 1.0, True, "cpu")
    with h.span("step"):
        pass
    assert h.spans is None
    h.spans = []
    with h.span("fbank"):
        pass
    with h.span("readback"):
        pass
    assert [n for n, _, _ in h.spans] == ["fbank", "readback"]
    (_, a0, a1), (_, b0, b1) = h.spans
    assert a0 <= a1 <= b0 <= b1
