"""The port's profiling tools on the CPU at a tiny width (on the card they
time the flagship; chip_smoke.py phase 18 runs them there).

- `profile_step` prints and returns the JAX tool's seven stages, each a
  positive time;
- `batch_sweep` prints a line a batch size and the throughput ratio lines,
  and `train_bench` (what chip_smoke's phases 6b-6d time) returns finite
  losses, one launch count a kernel wrapper and the profiled step;
- `profile_trace` writes a Chrome trace of its steps; `report_device_time`
  reads that trace (a CPU run holds no device event: None) and, on a trace
  with device events, gives the device ms a step and the kernel families
  (template arguments, parameters and the anonymous namespace stripped).
"""

import json

import torch

from tpuasr_torch.tools import batch_sweep, profile_step, profile_trace

torch.set_num_threads(1)  # six test workers share the cores

TINY = ["--set", "model.encoder.num_blocks=1", "model.encoder.output_size=32",
        "model.encoder.attention_heads=2", "model.encoder.linear_units=64",
        "model.encoder.cnn_module_kernel=7", "model.vocab_size=24",
        "model.predictor.embed_size=16", "model.predictor.hidden_size=16",
        "model.predictor.output_size=32", "model.joint.join_dim=32"]


def test_profile_step_times_every_stage(capsys):
    t = profile_step.main(["--device", "cpu", "--batch", "2", "--frames", "48", "--tokens", "4",
                           "--iters", "1", *TINY])
    assert list(t) == ["fbank", "encoder fwd", "predictor fwd", "joint fwd", "rnnt loss fwd",
                       "full fwd", "full grad"]
    assert all(v > 0 for v in t.values())
    out = capsys.readouterr().out
    assert out.startswith("audio per batch: ") and out.count(" audio-s/s)") == 7


def test_batch_sweep_and_train_bench(capsys):
    res = batch_sweep.main(["--device", "cpu", "--frames", "48", "--tokens", "4", "--batches",
                            "2", "4", "--steps", "2", *TINY])
    assert [r["batch"] for r in res] == [2, 4] and all(r["ms"] > 0 for r in res)
    out = capsys.readouterr().out
    assert "B=  2:" in out and "B=4 vs B=2:" in out

    cfg = batch_sweep.fast_path_cfg(48000, TINY[1:])
    cpu = torch.device("cpu")
    batch = profile_trace.bench_batch(cfg, cpu, 2, 48, 32)
    r = batch_sweep.train_bench(cfg, batch, cpu, n_steps=2, warmup=1)
    assert len(r["losses"]) == 3 and all(r["finite"]) and len(r["step_ms"]) == 2
    assert r["state"].step == 5 and r["max_memory_allocated"] is None  # 3 + the profiled 2
    assert r["launches"]["fbank"] == 0  # the CPU launches nothing: the plain versions
    assert r["profiled_step_device_ops"] == 0 and r["port_kernels"] == {}


def test_profile_trace_writes_and_reads_its_trace(tmp_path, capsys):
    report = profile_trace.main(["--device", "cpu", "--out", str(tmp_path), "--steps", "2",
                                 "--batch", "2", "--frames", "48", "--fused", *TINY])
    trace = tmp_path / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    steps = [e for e in events if e.get("name", "").startswith("ProfilerStep#")]
    assert report is None and len(steps) == 2  # the two recorded steps, no device event
    assert "no device events" in capsys.readouterr().out

    fake = tmp_path / "device.json"  # the shape of a card's trace
    kernel = "void (anonymous namespace)::fbank_tc_kernel<5, 1, 4>(float const*, int)"
    fake.write_text(json.dumps({"traceEvents": events + [
        {"ph": "X", "cat": "kernel", "name": kernel, "dur": 150.0},
        {"ph": "X", "cat": "kernel", "name": kernel, "dur": 158.0},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise_kernel<128, 4>(int)",
         "dur": 2.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)",
         "dur": 40.0}]}))
    got = profile_trace.report_device_time(str(fake), 2, 10.0)
    assert abs(got["ms_per_step"] - 0.175) < 1e-12
    assert got["families"]["fbank_tc_kernel"] == [0.154, 1.0]
    assert set(got["families"]) == {"fbank_tc_kernel", "at::native::elementwise_kernel",
                                    "Memcpy HtoD"}
