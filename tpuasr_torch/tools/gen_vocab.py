"""Build a vocabulary file (port of ``tools/gen_vocab.py``).

    python -m tpuasr_torch.tools.gen_vocab --pinyin_files dataset/split/*/pinyin \\
        --out tokenizer/vocab.txt

Writes the unique syllables of the split pinyin files, sorted (token id 6 +
i is the i-th); `--full-pinyin`, or no pinyin files, writes the complete
standard syllable table instead, so the port is usable without the corpus.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    """Write the vocabulary -> its count of tokens."""
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--pinyin_files", nargs="*", default=[])
    ap.add_argument("--out", default="tokenizer/vocab.txt")
    ap.add_argument("--full-pinyin", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.full_pinyin or not args.pinyin_files:
        from tpuasr_torch.text.pinyin import PINYIN_SYLLABLES, write_vocab

        write_vocab(args.out)
        print(f"wrote full pinyin table to {args.out}")
        return len(PINYIN_SYLLABLES)

    seen = set()
    for path in args.pinyin_files:
        with open(path, encoding="utf-8") as f:
            for line in f:
                _, _, toks = line.strip().partition("\t")
                seen.update(tok for tok in toks.split(" ") if tok)
    with open(args.out, "w", encoding="utf-8") as f:
        for tok in sorted(seen):
            f.write(tok + "\n")
    print(f"wrote {len(seen)} tokens to {args.out}")
    return len(seen)


if __name__ == "__main__":
    main(sys.argv[1:])
