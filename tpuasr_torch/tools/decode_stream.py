"""Single-utterance streaming decode demo (port of ``tools/decode_stream.py``):
feeds one WAV chunk by chunk through the incremental APIs and prints each
chunk's greedy output so far, then the final beam candidates.

    python -m tpuasr_torch.tools.decode_stream --checkpoint exp/latest \\
        --wav utt.wav [--beam_size 4] [--vocab vocab.txt] [--config cfg.yaml] \\
        [--set k=v ...] [--device cuda|cpu]

The WAV's end is known, so both searches stop at its true encoder length:
frames derived from the zero-padded tail of the last chunk window are never
decoded (no spurious trailing token). feature.sample_rate is taken from the
WAV.
"""

from __future__ import annotations

import argparse
import sys

from tpuasr_torch.tools.common import add_config_args


def main(argv=None) -> list[str]:
    """Decode -> the printed lines."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--wav", required=True)
    ap.add_argument("--beam_size", type=int, default=4)
    ap.add_argument("--vocab", default=None)
    add_config_args(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tpuasr_torch.audio import fbank
    from tpuasr_torch.data import read_wav
    from tpuasr_torch.decode.rnnt_streaming import (
        init_streaming_beam_state, init_streaming_state, process_chunk, process_chunk_beam,
    )
    from tpuasr_torch.device import resolve_device
    from tpuasr_torch.models.transducer import stream_output_len
    from tpuasr_torch.nn.subsampling import SUBSAMPLE_CLASSES
    from tpuasr_torch.streaming import chunk_windows, num_chunks
    from tpuasr_torch.tools.common import eval_config, restore_model, vocab_tokenizer

    device = resolve_device(args.device)
    cfg = eval_config(args.checkpoint, args.config, args.set, device)
    tokenizer = vocab_tokenizer(cfg, args.vocab)
    model = restore_model(cfg, "online_rnnt", device, args.checkpoint)
    wave, sr = read_wav(args.wav)
    cfg.feature.sample_rate = sr
    feats = fbank(torch.from_numpy(wave).to(device), cfg.feature)[None]  # [1, T, 80]
    enc_lens = stream_output_len(cfg.model.encoder, torch.tensor([feats.shape[1]]))

    c = cfg.model
    chunk, left = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks
    sub = SUBSAMPLE_CLASSES[c.encoder.input_layer]
    n = num_chunks(feats.shape[1], chunk, sub.subsampling_rate, sub.right_context)
    windows = chunk_windows(feats, chunk, sub.subsampling_rate, sub.right_context, n)
    lines = []

    def say(line: str) -> None:
        print(line)
        lines.append(line)

    say(f"=== streaming greedy ({n} chunks of "
        f"{chunk * sub.subsampling_rate * cfg.feature.hop_length / sr:.2f}s) ===")
    g_state = init_streaming_state(model, 1, chunk, left, c.blank_id, enc_lens=enc_lens)
    for i in range(n):
        g_state = process_chunk(model, windows[i], g_state, c.blank_id, cfg.streaming.n_steps)
        hyp = g_state.dec.hyp[0, : int(g_state.dec.hyp_len[0])].tolist()
        say(f"chunk {i + 1:3d}: {' '.join(tokenizer.decode(hyp))}")

    say(f"=== streaming beam-{args.beam_size} ===")
    b_state = init_streaming_beam_state(model, 1, chunk, left, args.beam_size,
                                        enc_lens=enc_lens)
    for i in range(n):
        b_state = process_chunk_beam(model, windows[i], b_state, c.blank_id)
    logp = b_state.beam.logp[0].cpu().numpy()
    for rank, j in enumerate(np.argsort(-logp)):
        if logp[j] < -1e29:
            continue
        hyp = b_state.beam.tokens[0, j, : int(b_state.beam.lens[0, j])].tolist()
        say(f"cand {rank + 1} (logp {float(logp[j]):8.2f}): "
            f"{' '.join(tokenizer.decode(hyp))}")
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
