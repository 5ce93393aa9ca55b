"""Train the CTC, RNN-T, AED and Paraformer workloads (port of
``tools/train.py``).

    python -m tpuasr_torch.tools.train --workload online_rnnt|rnnt|ctc|aed|paraformer \\
        [--config cfg.yaml] [--set model.encoder.num_blocks=6 ...] \\
        [--synthetic N | --data_root DIR] [--epochs E] [--resume SAVE_DIR/latest] \
        [--device cuda|cpu]

On N ranks, under torchrun (or any launcher that sets RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR and MASTER_PORT):

    python -m torch.distributed.run --standalone --nproc_per_node N \\
        -m tpuasr_torch.tools.train ... [--set mesh.zero_stage=zero1 \\
        mesh.model_parallel_size=2 model.shard_joint=True]

Each rank trains on cuda:LOCAL_RANK over NCCL (with --device cpu, on the CPU
over gloo); the ranks form the (data x model) mesh of cfg.mesh, each data
rank reads its shard of the corpus (host_id = data rank, num_hosts = the
data size; the ranks of one model group read the same rows), and rank 0
alone prints, logs and writes checkpoints (`train_loop`).

On the card the defaults are the JAX trainer's TPU fast path (bf16 compute
with fp32 parameters, the fused joint loss, the rel-pos attention kernels,
fbank precision "default"); a yaml or --set layers on top, and a
non-empty train.dtype then sets model.compute_dtype (`config.resolve`, as
the JAX trainer applies it). `--resume`
takes the port's checkpoint, a JAX orbax directory (SAVE_DIR/latest or
SAVE_DIR/epoch_NNNN of the JAX trainer) or the npz of one
(`tpuasr_torch.tools.orbax_to_npz`); it loads the config saved beside the
checkpoint unless --config is given, and continues at the saved step and
epoch with the saved moments and plateau state. The
workload online_rnnt makes the encoder causal with dynamic chunks (static
chunk = streaming.chunk_size when unset). Without --synthetic it trains on
the BZNSYP corpus on disk: the train and dev splits of cfg.data (wav.scp
entries relative to --data_root), tokenized by cfg.data.vocab_file (the
built-in pinyin table when the file is absent), with model.vocab_size set to
the tokenizer's size. The ctc workload trains `CTCModel` (cfg.ctc_model,
conv2d8 by default) in fp32 whatever model.compute_dtype and train.dtype
say, as the JAX trainer's does; its steps run fbank (with the card's
precision default) and the CTC loss, without SpecAugment or chunk masks.
The aed workload trains the hybrid CTC/attention `ASRModel` (the encoder of
model.encoder, the decoders of model.att_decoder, model.ctc_weight) through
the transducer's steps: SpecAugment, the chunk draw and dropout as there;
its logs add loss_att and th_accuracy. The paraformer workload trains the
CIF `Paraformer` (model.att_decoder's blocks, heads, FFN, lsm_weight,
sampler and sampling_ratio; the conformer stack of model.encoder, or the
LFR + SANM stack with model.encoder.encoder_type=sanm) through the same
steps, which add the glancing sampler's generator.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import sys

def parse_overrides(pairs) -> dict:
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def build_model(cfg, workload: str, device):
    """The workload's model on `device`, with seeded weights
    (cfg.train.seed): `CTCModel` for ctc, `ASRModel` for aed, `Paraformer`
    for paraformer, else the Transducer (online_rnnt first makes the
    encoder streamable)."""
    from tpuasr_torch.models import (
        AEDConfig, ASRModel, CTCModel, Paraformer, Transducer, init_weights,
    )

    m = cfg.model
    if workload == "ctc":
        return init_weights(CTCModel(cfg.ctc_model, m.vocab_size, m.blank_id, device),
                            cfg.train.seed)
    if workload == "aed":
        d = m.att_decoder
        return init_weights(ASRModel(AEDConfig(
            vocab_size=m.vocab_size, blank_id=m.blank_id, ctc_weight=m.ctc_weight,
            lsm_weight=d.lsm_weight, decoder_blocks=d.blocks, decoder_heads=d.heads,
            decoder_ffn=d.ffn, r_decoder_blocks=d.r_blocks, reverse_weight=d.reverse_weight,
            apply_non_blank_embedding=d.apply_non_blank_embedding,
            compute_dtype=m.compute_dtype, encoder=m.encoder), device), cfg.train.seed)
    if workload == "paraformer":
        return init_weights(Paraformer(paraformer_config(cfg), device), cfg.train.seed)
    if workload == "online_rnnt":
        m.encoder.causal = True
        m.encoder.use_dynamic_chunk = True
        if m.encoder.static_chunk_size == 0:
            m.encoder.static_chunk_size = cfg.streaming.chunk_size
    return init_weights(Transducer(m, device=device), cfg.train.seed)


def paraformer_config(cfg, **extra):
    """The paraformer workload's `ParaformerConfig` (tools/train.py:55-66):
    model.att_decoder's blocks, heads, FFN, lsm_weight and sampler fields,
    model.vocab_size, model.compute_dtype and model.encoder, the SANM stack
    when model.encoder.encoder_type is sanm; `extra` sets other fields (the
    CTC and timestamp branches, which the workload leaves off)."""
    from tpuasr_torch.models import ParaformerConfig

    m, d = cfg.model, cfg.model.att_decoder
    return ParaformerConfig(
        vocab_size=m.vocab_size, lsm_weight=d.lsm_weight, decoder_blocks=d.blocks,
        decoder_heads=d.heads, decoder_ffn=d.ffn, sampler=d.sampler,
        sampling_ratio=d.sampling_ratio, compute_dtype=m.compute_dtype, encoder=m.encoder,
        encoder_type="sanm" if m.encoder.encoder_type == "sanm" else "conformer", **extra)


def effective_config(device_type: str, config_path: str | None, sets):
    """-> the trainer's Config: the card's fast-path defaults when it trains
    on the card, the yaml at `config_path` layered on top, the dotted --set
    pairs, then `resolve` (train.dtype into model.compute_dtype)."""
    from tpuasr_torch.config import Config, layer_yaml, override, resolve

    cfg = Config()
    if device_type == "cuda":
        # the flagship fast path (the JAX trainer's TPU defaults)
        cfg.model.compute_dtype = "bfloat16"
        cfg.model.fused_joint_loss = True
        cfg.model.encoder.fused_attention = True
        cfg.feature.fbank_precision = "default"
    if config_path:
        cfg = layer_yaml(cfg, config_path)
    return resolve(override(cfg, parse_overrides(sets)))


def main(argv=None):
    """Run the trainer -> its LoopResult."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", choices=["ctc", "rnnt", "online_rnnt", "aed", "paraformer"],
                    default="online_rnnt")
    ap.add_argument("--config", default=None)
    ap.add_argument("--set", nargs="*", default=[], help="dotted overrides k=v")
    ap.add_argument("--synthetic", type=int, default=0,
                    help="train on N synthetic utterances instead of BZNSYP")
    ap.add_argument("--data_root", default="",
                    help="the BZNSYP corpus root that the split's wav.scp entries are "
                         "relative to")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from tpuasr_torch.parallel import init_distributed

    created = not dist.is_initialized()
    _, rank, device = init_distributed(args.device)
    try:
        return _train(args, rank, device)
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, rank: int, device):
    import torch.distributed as dist

    from tpuasr_torch.config import to_dict
    from tpuasr_torch.data import make_pipeline, scan_split, synthetic_pipeline
    from tpuasr_torch.parallel import make_mesh
    from tpuasr_torch.text import Tokenizer
    from tpuasr_torch.train import (
        TrainState, find_effective_config, load_info, make_ctc_eval_step, make_ctc_train_step,
        make_optimizer, restore_checkpoint, train_loop,
    )

    say = print if rank == 0 else (lambda *a, **k: None)
    if args.resume and args.config is None:
        # continue with the numerics the checkpoint was trained with
        args.config = find_effective_config(args.resume)
        if args.config is not None:
            say(f"resume: effective config {args.config}")
    cfg = effective_config(device.type, args.config, args.set)
    mesh = None
    if dist.is_initialized():  # under a launcher, at any world size
        mesh = make_mesh(cfg.mesh.model_parallel_size, device)
        say(f"world size {mesh.world_size} ({dist.get_backend()}): a {mesh.data_size} x "
            f"{mesh.model_parallel_size} (data x model) mesh, zero stage "
            f"{cfg.mesh.zero_stage!r}, shard_joint {cfg.model.shard_joint}")
    shard = {} if mesh is None else {"host_id": mesh.data_rank, "num_hosts": mesh.data_size}

    if args.synthetic:
        train_pipe = synthetic_pipeline(cfg, args.synthetic, seed=0, **shard)
        dev_pipe = synthetic_pipeline(cfg, max(args.synthetic // 8, 4), seed=1, **shard)
    else:
        d = cfg.data
        tokenizer = Tokenizer(d.vocab_file if os.path.exists(d.vocab_file) else None)
        cfg.model.vocab_size = tokenizer.size
        train_pipe = make_pipeline(scan_split(d.train_wav_scp, d.train_text, tokenizer,
                                              args.data_root), cfg, **shard)
        dev_pipe = make_pipeline(scan_split(d.dev_wav_scp, d.dev_text, tokenizer,
                                            args.data_root), cfg, **shard)

    model = build_model(cfg, args.workload, device)
    # the effective config after the workload's changes (the loop saves it
    # as save_dir/train.yaml too)
    say(json.dumps(to_dict(cfg), default=str))
    tx = make_optimizer(cfg.optim)
    step_fn = eval_fn = None
    if args.workload == "ctc":
        say(f"ctc workload: CTCModel {to_dict(cfg.ctc_model)} in float32 (model.compute_dtype "
            f"{cfg.model.compute_dtype!r} and the transducer's options are not read)")
        step_fn = make_ctc_train_step(model, tx, cfg, mesh)
        eval_fn = make_ctc_eval_step(model, cfg, mesh)
    state = TrainState.create(model, tx)
    start_epoch, plateau_init = 0, None
    if args.resume:
        state = restore_checkpoint(args.resume, state)
        try:
            info = load_info(args.resume)
            start_epoch = int(info.get("epoch", -1)) + 1
            plateau_init = info.get("plateau")
        except FileNotFoundError:
            pass
        say(f"resumed from {args.resume}: step {state.step}, starting at epoch {start_epoch}")
    result = train_loop(cfg, model, state, train_pipe, dev_pipe, step_fn, eval_fn,
                        epochs=args.epochs, start_epoch=start_epoch, plateau_init=plateau_init,
                        mesh=mesh)
    say("final train loss:", result.train_losses[-1] if result.train_losses else None)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
