"""Split the BZNSYP corpus into train/dev/test wav.scp + pinyin files (port
of ``tools/split_data.py``).

    python -m tpuasr_torch.tools.split_data \\
        --transcript dataset/ProsodyLabeling/000001-010000.txt --out_dir dataset/split

Utterance ids <= --train_max are train, <= --dev_max dev, the rest test;
pinyin lines are normalized (tones stripped, erhua split, the IY and P
artifacts handled: `tpuasr_torch.data.bznsyp.normalize_pinyin`).
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> dict:
    """Split -> {split: utterance count} (also printed)."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--transcript", default="dataset/ProsodyLabeling/000001-010000.txt")
    ap.add_argument("--out_dir", default="dataset/split")
    ap.add_argument("--wav_pattern", default="Wave/{utt}.wav")
    ap.add_argument("--train_max", type=int, default=8000)
    ap.add_argument("--dev_max", type=int, default=9000)
    args = ap.parse_args(argv)

    from tpuasr_torch.data.bznsyp import split_dataset

    counts = split_dataset(args.transcript, args.out_dir, args.wav_pattern, args.train_max,
                           args.dev_max)
    print(counts)
    return counts


if __name__ == "__main__":
    main(sys.argv[1:])
