"""The port's campaign tools against the JAX package's, on the CPU.

- `campaign_report`: on a log in the JAX loop's format (a resumed epoch
  repeated, plateau decays, the rss suffix, step lines) its parse and its
  printed report equal `tools/campaign_report.py`'s; on the log the port's
  own trainer writes (2 epochs of a tiny model), with the AED workload's
  step lines (loss_att, th_accuracy) appended, it reads every boundary and
  step line, where the JAX parser misses the AED ones.
- `campaign_eval`: the sweep of `tools/campaign_eval.sh` (the five offline
  modes on the held-out split, rnnt_beam with CTC fusion 0.3,
  eval_streaming, rnnt_greedy and ctc_greedy on the held-in split; one
  max-size bucket); on a tiny port checkpoint it exits 0 with every mode's
  result, and with one mode raising it runs the others and exits 1.
"""

import sys
from pathlib import Path

import pytest
import torch

from tpuasr_torch.tools import campaign_eval, campaign_report

torch.set_num_threads(1)  # six test workers share the cores

ROOT = Path(__file__).resolve().parents[1]
TINY = ["model.encoder.num_blocks=1", "model.encoder.output_size=32",
        "model.encoder.attention_heads=2", "model.encoder.linear_units=64",
        "model.encoder.cnn_module_kernel=7", "model.vocab_size=24",
        "model.predictor.embed_size=16", "model.predictor.hidden_size=16",
        "model.predictor.output_size=32", "model.joint.join_dim=32"]

JAX_LOG = """\
[2026-01-02 10:00:00] epoch 0 step 10 loss 45.1234 (812.5 audio-s/s)
[2026-01-02 10:00:30] epoch 0 train_loss 40.0000 dev_loss 38.5000 lr_scale 1.0000 rss 3.1G
[2026-01-02 10:00:40] epoch 1 step 20 loss 30.1000 (820.0 audio-s/s)
[2026-01-02 10:01:00] epoch 1 train_loss 30.0000 dev_loss 39.0000 lr_scale 1.0000 rss 3.2G
[2026-01-02 10:01:30] epoch 2 train_loss 25.0000 dev_loss 39.5000 lr_scale 0.5000
[2026-01-02 11:30:00] epoch 2 step 30 loss 24.5000 (700.0 audio-s/s)
[2026-01-02 11:30:30] epoch 2 train_loss 24.0000 dev_loss 37.0000 lr_scale 0.5000
[2026-01-02 11:31:00] epoch 3 train_loss nan dev_loss nan lr_scale 0.2500
[2026-01-02 11:31:30] epoch 4 train_loss 20.0000
"""


@pytest.fixture(scope="module")
def jax_report():
    sys.path.insert(0, str(ROOT))
    from tools import campaign_report as jax_campaign_report

    return jax_campaign_report


def test_report_matches_jax_on_a_jax_log(jax_report, tmp_path, capsys, monkeypatch):
    log = tmp_path / "log.txt"
    log.write_text(JAX_LOG)
    # repr: the nan epoch's losses compare equal as text
    assert repr(campaign_report.parse(str(log))) == repr(jax_report.parse(str(log)))
    for every in ("1", "2"):
        monkeypatch.setattr(sys, "argv", ["campaign_report", str(log), "--every", every])
        jax_report.main()
        want = capsys.readouterr().out
        lines = campaign_report.main([str(log), "--every", every])
        assert capsys.readouterr().out == want == "\n".join(lines) + "\n"
    assert "plateau decays: epoch 2: lr_scale -> 0.5; epoch 3: lr_scale -> 0.25" in want


def test_report_reads_the_port_trainers_log(jax_report, tmp_path):
    from tpuasr_torch.tools import train

    save = tmp_path / "run"
    res = train.main(["--device", "cpu", "--synthetic", "8", "--epochs", "2", "--set", *TINY,
                      "data.batch_size=4", f"train.save_dir={save}", "train.log_dir=",
                      "train.log_every=1"])
    log = save / "log.txt"
    with open(log, "a") as f:  # the AED workload's step lines (train/loop.py:71-75)
        f.write("[2026-01-02 12:00:00] epoch 2 step 9 loss 12.3456 loss_att 10.0000 "
                "th_accuracy 0.1250 (99.5 audio-s/s)\n")
    epochs, steps = campaign_report.parse(str(log))
    assert [e["epoch"] for e in epochs] == [0, 1]
    assert [round(e["train"], 4) for e in epochs] == [round(x, 4) for x in res.train_losses]
    assert [round(e["dev"], 4) for e in epochs] == [round(x, 4) for x in res.dev_losses]
    assert [s["step"] for s in steps] == list(range(1, res.state.step + 1)) + [9]
    jax_epochs, jax_steps = jax_report.parse(str(log))
    assert jax_epochs == epochs and jax_steps == steps[:-1]  # JAX's misses the AED line
    lines = campaign_report.main([str(log)])
    assert lines[:2] == ["| epoch | train_loss | dev_loss | lr_scale | wall (s) |",
                         "|---|---|---|---|---|"] and "final step 9" in lines[-1]


def test_campaign_eval_runs_the_jax_sweep(monkeypatch, capsys):
    calls = []

    def fake(cli):
        def main(argv):
            calls.append((cli, argv))
            if cli == "evaluate" and "rnnt_rescoring" in argv:
                raise RuntimeError("a mode that fails")
            return cli
        return main

    from tpuasr_torch.tools import eval_streaming, evaluate

    monkeypatch.setattr(evaluate, "main", fake("evaluate"))
    monkeypatch.setattr(eval_streaming, "main", fake("eval_streaming"))
    with pytest.raises(SystemExit) as e:
        campaign_eval.main(["ck", "64", "a.b=1", "--device", "cpu"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "***** FAILED: evaluate --checkpoint ck --workload online_rnnt --mode rnnt_rescoring" \
           in out and "1 failed mode(s)" in out
    tail = ["--set", "data.frame_buckets=(1536,)", "data.token_buckets=(64,)", "a.b=1",
            "--device", "cpu"]
    head = ["--checkpoint", "ck"]
    want = [("evaluate", head + ["--workload", "online_rnnt", "--mode", m, "--synthetic", "8",
                                 "--seed", "1"] + tail)
            for m in ("ctc_greedy", "ctc_prefix_beam", "rnnt_greedy", "rnnt_beam",
                      "rnnt_rescoring")]
    want.append(("evaluate", head + ["--workload", "online_rnnt", "--mode", "rnnt_beam",
                                     "--ctc_fusion_weight", "0.3", "--synthetic", "8", "--seed",
                                     "1"] + tail))
    want.append(("eval_streaming", head + ["--synthetic", "8", "--seed", "1"] + tail))
    want += [("evaluate", head + ["--workload", "online_rnnt", "--mode", m, "--synthetic", "8",
                                  "--seed", "0"] + tail) for m in ("rnnt_greedy", "ctc_greedy")]
    assert calls == want


def test_campaign_eval_exits_0_on_a_tiny_checkpoint(tmp_path, capsys):
    from tpuasr_torch.tools import train

    train.main(["--device", "cpu", "--synthetic", "8", "--epochs", "1", "--set", *TINY,
                "data.batch_size=4", f"train.save_dir={tmp_path}", "train.log_dir="])
    results = campaign_eval.main([str(tmp_path / "latest"), "32", "data.frame_buckets=(200,)",
                                  "data.token_buckets=(16,)", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(results) == 9 and all(r is not None for r in results)
    assert "all modes ok" in out and out.count("CER") >= 9
