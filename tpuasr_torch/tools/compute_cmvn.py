"""Compute global CMVN stats over a split (port of ``tools/compute_cmvn.py``;
the wenet tools/compute_cmvn_stats role, stats read by
`tpuasr_torch.audio.cmvn`).

    python -m tpuasr_torch.tools.compute_cmvn --wav_scp dataset/split/train/wav.scp \\
        --text dataset/split/train/pinyin --data_root dataset --out cmvn.json \\
        [--max_utts N] [--device cuda|cpu]

Each utterance's log-mel fbank (the default features at the WAV's sample
rate; kernel #1 on the card, its plain version with --device cpu), summed
in float64 on the host.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys


def main(argv=None):
    """Write the stats -> (mean, istd)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--wav_scp", required=True)
    ap.add_argument("--text", required=True)
    ap.add_argument("--out", default="cmvn.json")
    ap.add_argument("--data_root", default="")
    ap.add_argument("--max_utts", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from tpuasr_torch.audio import fbank
    from tpuasr_torch.audio.cmvn import compute_cmvn_stats, save_cmvn
    from tpuasr_torch.config import FeatureConfig
    from tpuasr_torch.data.bznsyp import iter_utterances, read_wav
    from tpuasr_torch.device import resolve_device

    device = resolve_device(args.device)
    feats_list, lens_list = [], []
    for i, (_, path, _) in enumerate(iter_utterances(args.wav_scp, args.text, args.data_root)):
        if args.max_utts and i >= args.max_utts:
            break
        wave, sr = read_wav(path)
        cfg = dataclasses.replace(FeatureConfig(), sample_rate=sr)
        f = fbank(torch.from_numpy(wave).to(device), cfg).cpu().numpy()
        feats_list.append(f[None])
        lens_list.append([f.shape[0]])
    mean, istd = compute_cmvn_stats(feats_list, lens_list)
    save_cmvn(args.out, mean, istd)
    print(f"wrote {args.out} over {len(feats_list)} utterances")
    return mean, istd


if __name__ == "__main__":
    main(sys.argv[1:])
