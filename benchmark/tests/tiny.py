"""The tiny cells of the benchmark's CPU tests: a copy of the benchmark
with a tiny configuration and tiny cells added as files only, and runs of
those cells on the CPU through the port's plain versions."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_TRAIN = {"config": "tiny_rnnt", "traffic": "train", "batch": 4, "frames": 96, "tokens": 8,
              "min_tokens": 4, "max_tokens": 6, "batches": 3, "checked_steps": 3,
              "trace_steps": 2, "ref_rows": 2,
              "limits": {"loss": 0.05, "grad": 0.2, "change": 0.2}}
TINY_STREAM = {"config": "tiny_rnnt", "traffic": "stream", "streams": 6, "min_s": 1.0,
               "max_s": 3.0, "mean_s": 1.8, "sigma": 0.4, "token_s": 0.2, "waves": 2,
               "max_tokens": 60, "sample": 6, "ref_rows": 2, "weights_seed": 1,
               "blank_bias": 1.8, "limits": {"gap": 1e-4}}


# the stream kind's metrics, as a cell of that kind brings them into BENCHMARK.json
STREAM_METRICS = {
    "end_to_end": [
        {"name": "stream_audio_s_per_s", "unit": "audio-s/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": []},
        {"name": "chunk_latency_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": []}],
    "per_layer": [
        {"name": name, "unit": "%", "better": better, "source": source, "layer": layer,
         "moves": "stream_audio_s_per_s", "workloads": []}
        for name, better, source, layer in (
            ("mfu.stream", "higher", "host_clock", "streaming decode"),
            ("kernel_roofline.stream", "higher", "device_trace", "kernels"),
            ("device_idle.stream", "lower", "device_trace", "device"))]}


def tiny_config() -> dict:
    """online_rnnt cut to a CPU test's size (every width small, 2 blocks)."""
    with open(os.path.join(REPO, "benchmark", "configs", "online_rnnt.json")) as f:
        c = json.load(f)
    c["name"] = "tiny_rnnt"
    c["feature"]["sample_rate"] = 16000
    c["model"]["encoder"].update(output_size=32, attention_heads=2, linear_units=64,
                                 num_blocks=2, cnn_module_kernel=7)
    c["model"]["vocab_size"] = 64
    c["model"]["predictor"].update(embed_size=16, hidden_size=16, output_size=32)
    c["model"]["joint"]["join_dim"] = 32
    c["streaming"].update(chunk_size=4, num_left_chunks=2)
    c["model"]["blank_bias"] = 1.8  # a third of a token an encoder frame at this size
    return c


TINY_AED_TRAIN = dict(TINY_TRAIN, config="tiny_u2pp", first_token=2, sos_eos=False,
                      limits={"loss": 0.05, "grad": 0.2, "change": 0.3})


def tiny_aed_config() -> dict:
    """u2pp_conformer cut to a CPU test's size (every width small, 2 encoder
    blocks, one decoder layer each way)."""
    with open(os.path.join(REPO, "benchmark", "configs", "u2pp_conformer.json")) as f:
        c = json.load(f)
    c["name"] = "tiny_u2pp"
    c["feature"]["sample_rate"] = 16000
    c["model"]["encoder"].update(output_size=32, attention_heads=2, linear_units=64,
                                 num_blocks=2, cnn_module_kernel=4)
    c["model"].update(vocab_size=50, sos_id=49, eos_id=49)
    c["model"]["att_decoder"].update(blocks=1, r_blocks=1, heads=2, ffn=64)
    return c


def add_tiny_cells(root: str) -> None:
    """Add the tiny configuration and cells to the benchmark under `root`:
    files only, and entries in its BENCHMARK.json (with the stream kind's
    metrics where no cell there brings them)."""
    b = os.path.join(root, "benchmark")
    for name, cfg, flops in (("tiny_rnnt", tiny_config(), "online_rnnt"),
                             ("tiny_u2pp", tiny_aed_config(), "u2pp_conformer")):
        with open(os.path.join(b, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        shutil.copy(os.path.join(b, "flops", flops + ".py"), os.path.join(b, "flops",
                                                                          name + ".py"))
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    for group, metrics in STREAM_METRICS.items():
        have = {m["name"] for m in man[group]}
        man[group] += [dict(m, workloads=[]) for m in metrics if m["name"] not in have]
    for name in ("tiny_rnnt", "tiny_u2pp"):
        man["configs"].append({"name": name, "source": "test", "reduced": [],
                               "file": f"benchmark/configs/{name}.json", "why": "test"})
    for name, params in (("tiny_rnnt.train.b4", TINY_TRAIN), ("tiny_rnnt.stream.s6", TINY_STREAM),
                         ("tiny_u2pp.train.b4", TINY_AED_TRAIN)):
        with open(os.path.join(b, "workloads", name + ".json"), "w") as f:
            json.dump(params, f)
        man["workloads"].append({"name": name, "config": params["config"],
                                 "traffic": params["traffic"], "chips": 1, "why": "test"})
        moves = "train_audio_s_per_s" if params["traffic"] == "train" else "stream_audio_s_per_s"
        for m in man["end_to_end"] + man["per_layer"]:
            if "workloads" in m and (m["name"] == moves or m.get("moves") == moves or
                                     (moves == "stream_audio_s_per_s"
                                      and m["name"] == "chunk_latency_p95_ms")):
                m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f, indent=1)


def run_cpu(cell: str, seed: int = 2**31 + 12345, seconds: float = 0.5, trace: int = 0) -> dict:
    """One run of `cell` in this process on the CPU (the harness pointed at
    a tree by `in_tree`)."""
    from benchmark import harness

    return harness.run(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                        "--trace", str(trace)], require_cuda=False, device="cpu")


def run_tree(root: str, cell: str, seed: int = 7, seconds: float = 0.5, trace: int = 0):
    """One CPU run of `cell` by the harness of the tree at `root`, in a
    process of its own -> (returncode, the result's dict or None, stderr)."""
    code = ("import json, sys; from benchmark.harness import run; "
            f"r = run({['--workload', cell, '--seed', str(seed), '--seconds', str(seconds), '--trace', str(trace)]!r}, "
            "require_cuda=False, device='cpu'); print(json.dumps(r))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, REPO]))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                       text=True, timeout=600)
    line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else "null"
    return p.returncode, json.loads(line), p.stderr

