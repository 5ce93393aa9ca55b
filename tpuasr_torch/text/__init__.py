"""Text side of the port: the tokenizer's special ids."""

from tpuasr_torch.text.tokenizer import BLK, EOS, PAD, SOS, SPACE, SPECIAL_TOKENS, UNK

__all__ = ["BLK", "EOS", "PAD", "SOS", "SPACE", "SPECIAL_TOKENS", "UNK"]
