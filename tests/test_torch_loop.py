"""The port's epoch loop, checkpoints and trainer CLI on the CPU.

A tiny online_rnnt (one causal conformer block, d64, the fused FFN,
dropout 0.1, SpecAugment, dynamic chunks) on the hard synthetic corpus
(8 utterances, batch 4, prefetch depth 2, a 4-utterance dev split):
- `train_loop` for 2 epochs writes train.yaml, log.txt and "latest" (+ its
  JSON info); restoring "latest" into a fresh model gives back every weight,
  the Adam count and moments, the step, the plateau scale and the skipped
  count exactly, and the info holds the epoch, step and plateau state;
- with `train.save_interval` 1, every step runs a dev pass (cv/loss in the
  log) and writes a `step_<n>` checkpoint with its cv loss;
- resuming from "latest" for a third epoch gives the uninterrupted 3-epoch
  run's epoch-3 train and dev losses exactly (the step's generators come
  from (seed, step), the data order from (seed, epoch), and the CPU's
  kernels are deterministic at one thread);
- `python -m tpuasr_torch.tools.train --device cpu --synthetic 8 --epochs 1`
  with a tiny `--set` exits 0 and leaves a checkpoint; the encoder
  families and the Paraformer workload, refused until they were ported,
  train an epoch (the corpus on disk: tests/test_torch_eval_cli.py);
- `--workload ctc` (a tiny CTCModel) trains an epoch and checkpoints it,
  and a resume for the second epoch gives the uninterrupted run's losses
  and step exactly.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from tpuasr_torch.config import Config, load_yaml, override
from tpuasr_torch.data import synthetic_pipeline
from tpuasr_torch.tools.train import build_model, main
from tpuasr_torch.train import (
    TrainState, latest_path, load_info, make_optimizer, restore_checkpoint, train_loop,
)

torch.set_num_threads(1)  # six test workers share the cores

ROOT = Path(__file__).resolve().parents[1]
TINY = {
    "model.vocab_size": 64, "model.encoder.num_blocks": 1, "model.encoder.output_size": 64,
    "model.encoder.attention_heads": 2, "model.encoder.linear_units": 128,
    "model.encoder.cnn_module_kernel": 7, "model.encoder.fused_ffn": True,
    "model.predictor.embed_size": 16, "model.predictor.hidden_size": 16,
    "model.predictor.output_size": 32, "specaug.enabled": True, "data.batch_size": 4,
    "data.num_prefetch": 2, "data.synth_hard": True, "data.synth_min_tokens": 2,
    "data.synth_max_tokens": 4, "train.log_every": 1, "train.log_dir": "",
}


def _run(save_dir, epochs, resume=False, **sets):
    cfg = override(Config(), {**TINY, "train.save_dir": str(save_dir), **sets})
    model = build_model(cfg, "online_rnnt", "cpu")
    state = TrainState.create(model, make_optimizer(cfg.optim))
    start, plateau = 0, None
    if resume:
        state = restore_checkpoint(latest_path(str(save_dir)), state)
        info = load_info(latest_path(str(save_dir)))
        start, plateau = info["epoch"] + 1, info["plateau"]
    return train_loop(cfg, model, state, synthetic_pipeline(cfg, 8, seed=0),
                      synthetic_pipeline(cfg, 4, seed=1), epochs=epochs,
                      start_epoch=start, plateau_init=plateau)


@pytest.fixture(scope="module")
def two_epochs(tmp_path_factory):
    d = tmp_path_factory.mktemp("two")
    return d, _run(d, 2)


def test_loop_writes_and_checkpoint_round_trips(two_epochs):
    d, res = two_epochs
    assert len(res.train_losses) == len(res.dev_losses) == 2
    assert all(torch.isfinite(torch.tensor(res.train_losses + res.dev_losses)))
    assert {"train.yaml", "log.txt", "latest", "latest.json"} <= set(os.listdir(d))
    assert load_yaml(str(d / "train.yaml")).model.encoder.causal  # online_rnnt's change
    state = res.state
    cfg = override(Config(), TINY)
    fresh = TrainState.create(build_model(cfg, "online_rnnt", "cpu"),
                              make_optimizer(cfg.optim))
    back = restore_checkpoint(latest_path(str(d)), fresh)
    ref_sd, got_sd = state.model.state_dict(), back.model.state_dict()
    assert ref_sd.keys() == got_sd.keys()
    assert all(torch.equal(ref_sd[k], got_sd[k]) for k in ref_sd)
    for a, b in zip(state.opt_state, back.opt_state):
        assert (a is None and b is None) or torch.equal(a, b)
    assert int(back.opt_state.count) == state.step > 0
    assert (back.step, back.lr_scale, int(back.skipped)) == \
        (state.step, state.lr_scale, int(state.skipped))
    info = load_info(latest_path(str(d)))
    assert info["epoch"] == 1 and info["step"] == state.step
    assert info["plateau"]["scale"] == state.lr_scale
    assert info["plateau"]["best"] == min(res.dev_losses)


def test_save_interval_runs_the_cv_hook(tmp_path):
    res = _run(tmp_path, 1, **{"train.save_interval": 1})
    steps = res.state.step
    assert steps == 2  # 8 utterances at batch 4
    for step in range(1, steps + 1):
        info = load_info(str(tmp_path / f"step_{step}"))
        assert info["step"] == step and info["epoch"] == 0 and info["cv_loss"] > 0
    log = (tmp_path / "log.txt").read_text()
    assert log.count("cv_loss") == steps


def test_resume_gives_the_uninterrupted_runs_third_epoch(two_epochs, tmp_path):
    d, _ = two_epochs
    straight = _run(tmp_path, 3)
    resumed = _run(d, 3, resume=True)
    assert resumed.train_losses == straight.train_losses[2:]
    assert resumed.dev_losses == straight.dev_losses[2:]
    assert resumed.state.step == straight.state.step
    assert load_info(latest_path(str(d)))["epoch"] == 2


def test_trainer_cli_on_cpu(tmp_path):
    sets = [f"{k}={v}" for k, v in TINY.items()] + [f"train.save_dir={tmp_path}"]
    proc = subprocess.run([sys.executable, "-m", "tpuasr_torch.tools.train", "--device", "cpu",
                           "--synthetic", "8", "--epochs", "1", "--set", *sets],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final train loss" in proc.stdout
    assert load_info(latest_path(str(tmp_path)))["epoch"] == 0


CTC_TINY = ["ctc_model.hidden_dim=32", "ctc_model.attention_heads=2", "ctc_model.num_blocks=1",
            "ctc_model.kernel_size=7", "model.vocab_size=64", "data.batch_size=4",
            "data.synth_hard=True", "train.log_dir="]


def test_trainer_cli_ctc_workload_and_resume(tmp_path):
    run = lambda d, *extra: main(["--workload", "ctc", "--device", "cpu", "--synthetic", "8",
                                  *extra, "--set", *CTC_TINY, f"train.save_dir={d}"])
    first = run(tmp_path / "a", "--epochs", "1")
    assert load_yaml(str(tmp_path / "a" / "train.yaml")).ctc_model.hidden_dim == 32
    assert load_info(latest_path(str(tmp_path / "a")))["epoch"] == 0
    resumed = main(["--workload", "ctc", "--device", "cpu", "--synthetic", "8", "--epochs", "2",
                    "--resume", latest_path(str(tmp_path / "a"))])
    straight = run(tmp_path / "b", "--epochs", "2")
    assert resumed.train_losses == straight.train_losses[1:]
    assert resumed.dev_losses == straight.dev_losses[1:]
    assert resumed.state.step == straight.state.step == 2 * first.state.step
    assert all(torch.isfinite(torch.tensor(straight.train_losses + straight.dev_losses)))
    assert int(straight.state.skipped) == 0


FAMILY_TINY = [f"{k}={v}" for k, v in TINY.items() if k != "model.encoder.num_blocks"] + [
    "model.encoder.num_blocks=4", "model.encoder.causal=True",
    "model.encoder.use_dynamic_chunk=True"]


@pytest.mark.parametrize("argv", [
    ["--workload", "rnnt", "--synthetic", "8", "--set", "model.encoder.encoder_type=squeezeformer",
     "model.encoder.reduce_idx=[1]", "model.encoder.recover_idx=[3]",
     "model.encoder.time_reduction_type=stream", *FAMILY_TINY],
    ["--workload", "online_rnnt", "--synthetic", "8", "--set",
     "model.encoder.encoder_type=efficient_conformer", "model.encoder.stride_layer_idx=[1]",
     "model.encoder.group_size=2", *FAMILY_TINY],
    ["--workload", "paraformer", "--synthetic", "8", "--set", "model.encoder.encoder_type=sanm",
     "model.att_decoder.blocks=1", "model.att_decoder.heads=2", "model.att_decoder.ffn=64",
     *FAMILY_TINY]])
def test_trainer_cli_refuses_what_is_not_ported(argv, tmp_path):
    """What the trainer refused before it was ported, the encoder families
    and the Paraformer workload (its SANM stack here), trains an epoch of
    the tiny hard corpus with finite losses and no skipped step, and its
    config reaches the checkpoint's train.yaml."""
    run = main(argv + [f"train.save_dir={tmp_path}", "--device", "cpu", "--epochs", "1"])
    assert all(torch.isfinite(torch.tensor(run.train_losses + run.dev_losses)))
    assert int(run.state.skipped) == 0 and run.state.step > 0
    enc = load_yaml(str(tmp_path / "train.yaml")).model.encoder
    assert f"model.encoder.encoder_type={enc.encoder_type}" in argv and enc.num_blocks == 4
    if "paraformer" in argv:
        model = run.state.model
        assert type(model).__name__ == "Paraformer" and len(model.decoder.layers) == 1
        assert type(model.encoder).__name__ == "SanmEncoder"
    else:
        assert (enc.reduce_idx, enc.stride_layer_idx) in (((1,), (3,)), ((5,), (1,)))
