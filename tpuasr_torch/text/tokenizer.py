"""The tokenizer's six special tokens and their ids (a copy of the constants
of ``tpuasr/text/tokenizer.py:16-18``; the tokenizers themselves are not
ported yet)."""

SPECIAL_TOKENS = ("<pad>", "<unk>", "<sos>", "<eos>", " ", "<blk>")

PAD, UNK, SOS, EOS, SPACE, BLK = range(6)
