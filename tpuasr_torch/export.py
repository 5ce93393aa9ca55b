"""Serving export: the streaming inference surface as `torch.export`
artifacts (port of ``tpuasr/export.py``).

The reference's export surface for a serving runtime (wenet
transducer.py:443-472: `forward_encoder_chunk`, `forward_predictor_step`,
`forward_joint_step`) and the fused `process_chunk` (the chunk encoder and
the greedy emission in one program), each traced for a fixed number of
parallel streams and saved with `torch.export.save` as a ``.pt2`` file
that holds its graph and the model's weights; a serving process loads it
with `load_exported` without building the model (the package still gives
the state types and kernel #10's operator).

Three things make the surface traceable. The conformer's stream offset is
a 0-d tensor in `EncoderStreamState`, so an artifact runs at every chunk
index and not only at the one it was traced at. The exported
`process_chunk` runs the greedy emission loop with `sync_free=True` (all
`n_steps` masked steps, no host read), which gives the eager loop's tokens.
Kernel #10 is the registered operator `torch.ops.tpuasr.ffn_fwd`
(`tpuasr_torch.ops.ffn`), so a model with `encoder.fused_ffn` keeps the
kernel inside its artifacts: on the card they launch it, on the CPU they
run its plain version. The cached attention takes kernel #2's plain
version and the artifacts take feature windows, not waves, so no other
kernel is on the exported surface.

An artifact runs on the device it was traced on (`platforms` in the
manifest): trace on the card for the card.
"""

from __future__ import annotations

import json
import os
from typing import Any

import torch
from torch import nn
from torch.utils import _pytree


def register_state_types() -> None:
    """Register the decode states as pytree nodes under stable names, so an
    exported function takes and returns them and `torch.export.load`
    restores them: the list of the JAX package's `_register_state_types`
    (the encoder families' `FamilyStreamState` is not on it)."""
    from tpuasr_torch.decode.rnnt_beam import BeamCarry
    from tpuasr_torch.decode.rnnt_greedy import GreedyCarry
    from tpuasr_torch.decode.rnnt_streaming import StreamingBeamState, StreamingState
    from tpuasr_torch.nn.conformer import EncoderStreamState

    for cls in (EncoderStreamState, GreedyCarry, StreamingState, StreamingBeamState,
                BeamCarry):
        if cls not in _pytree.SUPPORTED_NODES:
            torch.export.register_dataclass(cls,
                                            serialized_type_name=f"tpuasr_torch.{cls.__name__}")


class _Surface(nn.Module):
    """One function of the streaming surface over `module`, as the module
    `torch.export` traces: forward(*args) = fn(module, *args). An artifact
    holds the weights of its module alone."""

    def __init__(self, module: nn.Module, fn):
        super().__init__()
        self.module, self.fn = module, fn

    def forward(self, *args):
        return self.fn(self.module, *args)


def export_streaming(model, cfg, out_dir: str, batch: int = 1, max_tokens: int = 200) -> dict:
    """Trace and save the streaming surface of a conformer `Transducer` for
    `batch` parallel streams on the model's device; -> the manifest.

    Artifacts (one ``.pt2`` file each + manifest.json):
      encoder_chunk     (window_feats, enc_state)        -> (enc_out, enc_state')
      predictor_step    (tokens, pred_state)             -> (pred_out, pred_state')
      joint_step        (enc_t, pred_u)                  -> logits
      process_chunk     (window_feats, streaming_state)  -> streaming_state'
    with `cfg.streaming`'s chunk size, left chunks and `n_steps`."""
    from tpuasr_torch.decode.rnnt_streaming import init_streaming_state, process_chunk
    from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES
    from tpuasr_torch.streaming.chunkwise import decoding_window

    c = model.cfg
    if c.encoder.encoder_type != "conformer":
        raise ValueError(
            f"export_streaming exports the conformer's stream; encoder_type "
            f"{c.encoder.encoder_type!r} keeps per-layer caches (FamilyStreamState) that are "
            f"not an exported state type, as in the JAX package (tpuasr/export.py:24-42)")
    register_state_types()
    chunk, left = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks
    sub = SUBSAMPLE_CLASSES[c.encoder.input_layer]
    window = decoding_window(chunk, sub.subsampling_rate, sub.right_context)
    dev = model.device
    f32 = dict(dtype=torch.float32, device=dev)
    win = torch.zeros((batch, window, c.encoder.input_size), **f32)
    # (the module whose weights the artifact holds, the function, its inputs)
    fns = {
        "encoder_chunk": (model.encoder, lambda e, w, s: e.forward_chunk(w, s),
                          (win, model.init_encoder_state(batch, chunk, left))),
        "predictor_step": (model.predictor, lambda p, t, s: p.forward_step(t, s),
                           (torch.zeros(batch, dtype=torch.long, device=dev),
                            model.init_predictor_state(batch))),
        "joint_step": (model.joint, lambda j, e, p: j.step(e, p),
                       (torch.zeros((batch, c.encoder.output_size), **f32),
                        torch.zeros((batch, c.predictor.output_size), **f32))),
        "process_chunk": (model, lambda m, w, s: process_chunk(
                              m, w, s, c.blank_id, cfg.streaming.n_steps, sync_free=True),
                          (win, init_streaming_state(model, batch, chunk, left, c.blank_id,
                                                     max_tokens))),
    }
    os.makedirs(out_dir, exist_ok=True)
    manifest: dict[str, Any] = {"batch": batch, "chunk_size": chunk, "num_left_chunks": left,
                                "window": window, "functions": {}}
    for name, (module, fn, args) in fns.items():
        with torch.no_grad():
            exported = torch.export.export(_Surface(module, fn).eval(), args, strict=False)
        # the artifact keeps its graph and weights, not the tracing inputs (the
        # states would be pickled, and a weights-only load refuses them)
        exported.example_inputs = None
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(exported, path)
        manifest["functions"][name] = {"file": os.path.basename(path),
                                       "platforms": [dev.type]}
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def load_exported(out_dir: str) -> dict:
    """Load the artifacts of `export_streaming` back as callables {name:
    module}, each called with arguments of the shapes it was traced with,
    its weights frozen. The state types and kernel #10's operator are
    registered first."""
    import tpuasr_torch.ops.ffn  # noqa: F401  (registers torch.ops.tpuasr.ffn_fwd)

    register_state_types()
    with open(os.path.join(out_dir, "manifest.json")) as f:
        manifest = json.load(f)
    # check_guards=False: the generated guard code names each input by
    # string replacement of its pytree path, which breaks on a field whose
    # name extends another's (`hyp` / `hyp_len`, `enc` / `enc_lens`); the
    # module's pre-hook still checks the inputs against the traced ones;
    # serving computes no gradient, so the weights need none
    return {name: torch.export.load(os.path.join(out_dir, info["file"])).module(
                check_guards=False).requires_grad_(False)
            for name, info in manifest["functions"].items()}
