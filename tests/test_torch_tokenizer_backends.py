"""The port's HuggingFace, tiktoken (whisper) and sentencepiece tokenizer
backends against the JAX package's on the same inputs, on the CPU.

- `HuggingFaceTokenizer` on tests/test_text.py's local BertTokenizer
  directory (no hub access: HF_HUB_OFFLINE): tokens, ids, text, vocab size
  and symbol table equal JAX's, and a pickled copy rebuilds its backend;
- `WhisperTokenizer` on tests/test_longtail.py's strings and more: both
  sides with `tiktoken.get_encoding` raising (as it does on a machine with
  no network and no cached rank file), so both take the byte-level
  fallback and no test reaches for the registry; ids and round trips
  equal;
- `BpeTokenizer` raises JAX's ImportError message where sentencepiece is
  missing (it is, on both machines).

Each package is imported only by `importorskip`, as the backends import
theirs only when first used.
"""

import pickle

import pytest

import tpuasr.text.tokenizers_ext as jax_ext
import tpuasr_torch.text.tokenizers_ext as port_ext

LINES = ["hello world", "hello  world\n", "don't stop", "数字 123 and ümlaut", ""]


def test_huggingface_tokenizer_matches_jax(tmp_path, monkeypatch):
    pytest.importorskip("transformers")
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    (tmp_path / "vocab.txt").write_text(
        "[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\nhello\nworld\nhel\n##lo\n##world\n",
        encoding="utf-8")
    (tmp_path / "tokenizer_config.json").write_text(
        '{"tokenizer_class": "BertTokenizer", "do_lower_case": true}', encoding="utf-8")
    jax_tok = jax_ext.HuggingFaceTokenizer(str(tmp_path))
    tok = port_ext.HuggingFaceTokenizer(str(tmp_path))
    assert tok.tokenizer is None  # nothing built before the first use
    for line in ["hello world", "helloworld", "Hello World hel", "unknown words"]:
        assert tok.tokenize(line) == jax_tok.tokenize(line)
        ids = tok.tokenize(line)[1]
        assert tok.detokenize(ids) == jax_tok.detokenize(ids)
    assert tok.vocab_size() == jax_tok.vocab_size() == 10
    assert tok.symbol_table == jax_tok.symbol_table
    again = pickle.loads(pickle.dumps(tok))
    assert again.tokenizer is None and again.text2tokens("helloworld") == ["hello", "##world"]


def test_whisper_tokenizer_matches_jax(monkeypatch):
    tiktoken = pytest.importorskip("tiktoken")

    def offline(name):
        raise OSError(f"no rank file for {name} (offline)")

    monkeypatch.setattr(tiktoken, "get_encoding", offline)
    jax_tok, tok = jax_ext.WhisperTokenizer(), port_ext.WhisperTokenizer()
    for line in LINES:
        toks, ids = tok.tokenize(line)
        assert (toks, ids) == jax_tok.tokenize(line)
        assert tok.detokenize(ids) == jax_tok.detokenize(ids)
        assert tok.detokenize(ids)[0] == line
    assert tok.vocab_size() == jax_tok.vocab_size() == 256
    assert tok.symbol_table == jax_tok.symbol_table
    again = pickle.loads(pickle.dumps(tok))
    assert again.tokenizer is None and again.tokenize("hello")[1] == tok.tokenize("hello")[1]


def test_bpe_tokenizer_needs_sentencepiece(tmp_path):
    try:
        import sentencepiece  # noqa: F401
        pytest.skip("sentencepiece is installed here")
    except ImportError:
        pass
    with pytest.raises(ImportError) as jax_err:
        jax_ext.BpeTokenizer(str(tmp_path / "bpe.model"))
    with pytest.raises(ImportError) as err:
        port_ext.BpeTokenizer(str(tmp_path / "bpe.model"))
    assert str(err.value) == str(jax_err.value)
