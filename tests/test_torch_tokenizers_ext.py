"""The port's pure-Python tokenizers == the JAX package's
(`tpuasr/text/tokenizers_ext.py`), on tests/test_longtail.py's cases:

- `ParaformerTokenizer`: seg-dict expansion, ids, vocabulary size, and
  seg-dict words inside mixed CJK / Latin text;
- `train_bpe` + `PureBpeTokenizer`: the same model (vocabulary and merges)
  from the same corpus, the same tokens and ids, round trips, <unk> for
  unknown symbols, and the JSON model file;
- `tokenize_mixed`: CJK characters split out, the other runs encoded, with
  and without upper-casing.

The JAX module's whisper (tiktoken), HuggingFace and sentencepiece
tokenizers are not ported (packages outside the port's dependencies).
"""

import json

import pytest

from tpuasr.text import tokenizers_ext as jax_ext
from tpuasr_torch.text import tokenizers_ext as ext

SYM = {"<unk>": 0, "ni": 1, "hao": 2, "你": 3, "好": 4, "OK": 5}
CORPUS = ["the quick brown fox jumps over the lazy dog", "the dog barks at the quick fox",
          "lazy dogs and quick foxes"] * 5


def test_paraformer_tokenizer():
    seg = {"nihao": "ni hao"}
    tok, ref = ext.ParaformerTokenizer(SYM, seg_dict=seg), jax_ext.ParaformerTokenizer(SYM, seg)
    for line in ("nihao 你好", "你nihao好 OK", "zai 你 OK nihao"):
        assert tok.tokenize(line) == ref.tokenize(line)
    assert tok.tokenize("nihao 你好") == (["ni", "hao", "你", "好"], [1, 2, 3, 4])
    assert tok.text2tokens("你nihao好 OK") == ["你", "ni", "hao", "好", "OK"]
    assert tok.detokenize([3, 4, 9]) == ref.detokenize([3, 4, 9]) == ("你好<unk>",
                                                                       ["你", "好", "<unk>"])
    assert tok.vocab_size() == ref.vocab_size() == 6
    assert isinstance(tok, ext.BaseTokenizer)


def test_pure_bpe_train_and_roundtrip(tmp_path):
    model = ext.train_bpe(CORPUS, vocab_size=60)
    assert model == jax_ext.train_bpe(CORPUS, vocab_size=60)
    tok, ref = ext.PureBpeTokenizer(model), jax_ext.PureBpeTokenizer(model)
    assert tok.vocab_size() == ref.vocab_size() <= 60
    for text in ("the quick dog", "lazy foxes jump", "你好 the dog"):
        assert tok.tokenize(text) == ref.tokenize(text)
    tokens, ids = tok.tokenize("the quick dog")
    assert tokens and len(ids) == len(tokens)
    # frequent words compress below character granularity
    assert len(tokens) < len("thequickdog") + 3
    assert tok.detokenize(ids) == ref.detokenize(ids) == ("the quick dog", tokens)
    assert tok.tokens2ids(["@@nope@@"]) == [tok.symbol_table["<unk>"]]
    path = tmp_path / "bpe.json"
    path.write_text(json.dumps(model))
    assert ext.PureBpeTokenizer(str(path)).tokenize("the quick dog") == (tokens, ids)


@pytest.mark.parametrize("upper", [True, False])
def test_tokenize_mixed(upper):
    enc = lambda run: run.split()
    for text in ("你好IT'S OK的", "mixed 中文 and English", "  ", "全中文"):
        assert ext.tokenize_mixed(text, enc, upper) == jax_ext.tokenize_mixed(text, enc, upper)
    if upper:
        assert ext.tokenize_mixed("你好IT'S OK的", enc) == ["你", "好", "IT'S", "OK", "的"]
