"""The port's counterpart of tests/test_campaign_ckpt.py: the round-4
campaign checkpoint (exp/campaign/epoch_0049, the 50-epoch causal streaming
RNN-T that the JAX package trained and saved with orbax) read through the
port's orbax reader (`train.restore_checkpoint`), decoded by the port on
the CPU in fp32 with the fused routes off, held to the same CER gates on the
same 32-utterance subset of the seed-1 held-out generator. The checkpoint
lives on the build machine, not in git (309 MB with the optimizer state):
the gates skip where it is absent. Slow, as the JAX gates are: the
full-width flagship decodes on the CPU.
"""

import os

import pytest

CKPT = "exp/campaign/epoch_0049"
N_UTTS = 32


def _load():
    if not os.path.isdir(CKPT):
        pytest.skip(f"{CKPT} not on this machine (campaign artifacts are not in git)")
    import torch

    from tpuasr_torch.config import load_yaml, override
    from tpuasr_torch.data import synthetic_pipeline
    from tpuasr_torch.text import Tokenizer
    from tpuasr_torch.tools.train import build_model
    from tpuasr_torch.train import (
        TrainState, find_effective_config, make_optimizer, restore_checkpoint,
    )

    cfg_path = find_effective_config(CKPT)
    assert cfg_path, "campaign train.yaml missing next to the checkpoint"
    cfg = override(load_yaml(cfg_path), {"model.compute_dtype": "float32",
                                         "model.fused_joint_loss": False,
                                         "model.encoder.fused_attention": False})
    tokenizer = Tokenizer(tokens=[f"syl{i}" for i in range(cfg.model.vocab_size - 6)])
    pipe = synthetic_pipeline(cfg, N_UTTS, seed=1)  # the held-out split's generator
    model = build_model(cfg, "online_rnnt", torch.device("cpu"))
    restore_checkpoint(CKPT, TrainState.create(model, make_optimizer(cfg.optim)))
    return cfg, model.eval(), pipe, tokenizer


@pytest.mark.slow
@pytest.mark.parametrize("mode,band", [
    ("ctc_greedy", 0.01),   # sweep: 0.02% on 512 utterances
    ("rnnt_greedy", 0.02),  # sweep: see eval_sweep.log
])
def test_campaign_ckpt_dev_cer(mode, band):
    from tpuasr_torch.eval import evaluate_offline

    cfg, model, pipe, tokenizer = _load()
    res = evaluate_offline(model, pipe.batches(0), cfg, tokenizer, mode=mode)
    assert res.counts.cer <= band, (
        f"{mode} held-out CER {100 * res.counts.cer:.2f}% exceeds the campaign gate "
        f"{100 * band:.1f}%: the port's reading or decoding of the JAX checkpoint regressed")
