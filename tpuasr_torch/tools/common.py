"""What the evaluation CLIs (`evaluate`, `eval_streaming`, `decode_stream`)
share: the config a checkpoint is evaluated with, the dev or test split (or
the synthetic corpus) with its tokenizer, and the model restored from the
port's checkpoint, a JAX orbax directory or its npz."""

from __future__ import annotations

import os

DEVICE_HELP = (
    "cuda (the default) or cpu; without a card and without cpu it raises. With the "
    "train.yaml saved beside the checkpoint (no --config), the card evaluates in the "
    "yaml's numerics (a checkpoint trained on the card: bf16 compute, fbank precision "
    "\"default\" through kernel #1's tensor-core route, the attention kernel #2, and "
    "kernel #10 if it trained with encoder.fused_ffn), while cpu evaluates in fp32 "
    "with fused_attention and fused_joint_loss off, as the JAX CLIs do off the TPU "
    "(the fbank precision stays the yaml's)")


def add_config_args(ap) -> None:
    ap.add_argument("--config", default=None,
                    help="a yaml (default: the train.yaml saved beside the checkpoint)")
    ap.add_argument("--set", nargs="*", default=[], help="dotted overrides k=v")
    ap.add_argument("--device", default=None, help=DEVICE_HELP)


def eval_config(checkpoint: str | None, config_path: str | None, sets, device):
    """-> the Config to evaluate `checkpoint` (None: seeded weights) with:
    the yaml at `config_path`, else the one saved beside the checkpoint,
    else the defaults; the dotted --set pairs and `resolve` on top. An
    auto-loaded yaml evaluated on the CPU computes in fp32 with the fused
    attention and joint-loss routes off (what the JAX CLIs'
    adapt_to_backend does off the TPU)."""
    from tpuasr_torch.config import Config, load_yaml, override, resolve
    from tpuasr_torch.tools.train import parse_overrides
    from tpuasr_torch.train import find_effective_config

    auto = config_path is None
    if auto and checkpoint:
        # the loop saves the resolved config beside its checkpoints, so
        # evaluation needs no architecture flags
        config_path = find_effective_config(checkpoint)
        if config_path:
            print(f"effective config: {config_path}")
    cfg = load_yaml(config_path) if config_path else Config()
    cfg = resolve(override(cfg, parse_overrides(sets)))
    if auto and device.type == "cpu":
        cfg.model.compute_dtype = "float32"
        cfg.model.fused_joint_loss = False
        cfg.model.encoder.fused_attention = False
    return cfg


def eval_split(cfg, split: str, synthetic: int, seed: int, data_root: str):
    """-> (tokenizer, pipeline) of the dev or test split on disk, tokenized by
    cfg.data.vocab_file (model.vocab_size becomes its size), or of
    `synthetic` synthetic utterances from `seed` with placeholder tokens."""
    from tpuasr_torch.data import make_pipeline, scan_split, synthetic_pipeline
    from tpuasr_torch.text import Tokenizer

    if synthetic:
        tokenizer = Tokenizer(tokens=[f"syl{i}" for i in range(cfg.model.vocab_size - 6)])
        return tokenizer, synthetic_pipeline(cfg, synthetic, seed=seed)
    d = cfg.data
    tokenizer = Tokenizer(d.vocab_file)
    cfg.model.vocab_size = tokenizer.size
    scp, txt = (d.dev_wav_scp, d.dev_text) if split == "dev" else (d.test_wav_scp, d.test_text)
    return tokenizer, make_pipeline(scan_split(scp, txt, tokenizer, data_root), cfg)


def vocab_tokenizer(cfg, vocab: str | None):
    """decode_stream's tokenizer: `vocab`, else cfg.data.vocab_file if it
    exists (model.vocab_size becomes its size), else placeholder tokens of
    the configured size."""
    from tpuasr_torch.text import Tokenizer

    path = vocab or (cfg.data.vocab_file if os.path.exists(cfg.data.vocab_file) else None)
    if path:
        tokenizer = Tokenizer(path)
        cfg.model.vocab_size = tokenizer.size
        return tokenizer
    return Tokenizer(tokens=[f"syl{i}" for i in range(cfg.model.vocab_size - 6)])


def restore_model(cfg, workload: str, device, checkpoint: str):
    """The workload's model (built as the trainer builds it) on `device`
    with the weights of `checkpoint`, in eval mode: the port's file
    (`train.restore_checkpoint`), or a JAX orbax directory or the npz of one,
    of which only the params are read (strict)."""
    from tpuasr_torch.convert import load_jax_params
    from tpuasr_torch.tools.train import build_model
    from tpuasr_torch.train import TrainState, make_optimizer, restore_checkpoint
    from tpuasr_torch.train.orbax import read_checkpoint

    model = build_model(cfg, workload, device)
    tree = read_checkpoint(checkpoint, only="params")
    if tree is not None:
        load_jax_params(model, tree["params"])
    else:
        restore_checkpoint(checkpoint, TrainState.create(model, make_optimizer(cfg.optim)))
    return model.eval()
