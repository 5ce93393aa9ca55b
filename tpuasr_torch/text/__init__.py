"""Text side of the port: tokenizers (the pinyin / character ones and the
pure-Python BPE and seg-dict ones), the special ids, the pinyin table, CER
and display text."""

from tpuasr_torch.text.beautify import beautify_result
from tpuasr_torch.text.cer import CerCounts, cer_details, corpus_cer
from tpuasr_torch.text.pinyin import PINYIN_SYLLABLES, write_vocab
from tpuasr_torch.text.tokenizer import (
    BLK, EOS, PAD, SOS, SPACE, SPECIAL_TOKENS, UNK, CharTokenizer, Tokenizer,
    read_non_lang_symbols,
)
from tpuasr_torch.text.tokenizers_ext import (
    BaseTokenizer, ParaformerTokenizer, PureBpeTokenizer, tokenize_mixed, train_bpe,
)

__all__ = ["Tokenizer", "CharTokenizer", "cer_details", "corpus_cer", "PINYIN_SYLLABLES",
           "BLK", "EOS", "PAD", "SOS", "SPACE", "SPECIAL_TOKENS", "UNK", "CerCounts",
           "beautify_result", "read_non_lang_symbols", "write_vocab", "BaseTokenizer",
           "ParaformerTokenizer", "PureBpeTokenizer", "tokenize_mixed", "train_bpe"]
