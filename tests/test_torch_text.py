"""The port's text and BZNSYP modules == the JAX package's on the same inputs.

Pure Python and numpy on both sides, so every result must be equal, not
close: the pinyin table and the vocabulary file it writes; `Tokenizer` from
a file, a token list and the built-in table (encode with unknown tokens,
decode with and without specials, sizes and special ids);
`read_non_lang_symbols` from a file (and its error on a bad symbol);
`CharTokenizer` with and without protected symbols, `split_with_space` and
`connect_symbol`; `beautify_result` on random mixes of CJK characters,
English words, `@@` pieces and specials; `cer_details` / `corpus_cer` on
random pairs over a small alphabet and on crafted ties, where the
backtrace's order (substitution or match, then deletion, then insertion)
decides the S/D/I split; `normalize_pinyin`'s erhua, IY and P rules;
`parse_prosody_labeling`, `split_dataset` (the files it writes, byte for
byte), `read_scp`, `read_text`, `iter_utterances` and their errors; and
`read_wav` bit for bit at 8, 16 and 32 bits, mono and stereo, as float32
and as int16.
"""

import wave

import numpy as np
import pytest

from tpuasr.data import bznsyp as jax_bz
from tpuasr.text import beautify as jax_beautify
from tpuasr.text import cer as jax_cer
from tpuasr.text import pinyin as jax_pinyin
from tpuasr.text import tokenizer as jax_tok
from tpuasr_torch.data import bznsyp
from tpuasr_torch.text import beautify, cer, pinyin
from tpuasr_torch.text import tokenizer as tok

SYMS = ["{NOISE}", "<LAUGH>", "[COUGH]"]


def _rng(*key):
    return np.random.default_rng(list(key))


def _sdin(c):
    return c.substitutions, c.deletions, c.insertions, c.ref_len


def test_pinyin_table_and_vocab_file_equal_jax(tmp_path):
    assert pinyin.PINYIN_SYLLABLES == jax_pinyin.PINYIN_SYLLABLES
    assert len(pinyin.PINYIN_SYLLABLES) == 409
    pinyin.write_vocab(str(tmp_path / "port.txt"))
    jax_pinyin.write_vocab(str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()


@pytest.mark.parametrize("source", ["file", "tokens", "builtin"])
def test_tokenizer_matches_jax(source, tmp_path):
    r = _rng(1, len(source))
    vocab = sorted(r.choice(pinyin.PINYIN_SYLLABLES, 40, replace=False).tolist())
    path = tmp_path / "vocab.txt"
    path.write_text("\n".join(vocab[:20] + ["", vocab[3]] + vocab[20:]) + "\n", encoding="utf-8")
    kw = {"file": {"vocab_file": str(path)}, "tokens": {"tokens": vocab},
          "builtin": {}}[source]
    p, j = tok.Tokenizer(**kw), jax_tok.Tokenizer(**kw)
    assert p.size == j.size and p.token2id == j.token2id and p.id2token == j.id2token
    assert p.size == (415 if source == "builtin" else 46)
    assert p.special_token_ids() == j.special_token_ids() == list(range(6))
    assert (p.pad_id, p.sos_id, p.eos_id, p.blk_id) == (j.pad_id, j.sos_id, j.eos_id, j.blk_id)
    words = list(p.token2id) + ["zzz", "qq", "<x>"]
    seq = [words[i] for i in r.integers(0, len(words), 60)]
    assert p(seq) == j(seq) == j.encode(seq) == p.encode(seq)
    ids = r.integers(-2, p.size + 3, 80).tolist()
    for ignore in (True, False):
        assert p.decode(ids, ignore) == j.decode(ids, ignore)


def test_non_lang_symbols_from_a_file_and_the_bad_symbol_error(tmp_path):
    good = tmp_path / "syms.txt"
    good.write_text("{NOISE}\n\n<LAUGH>\n  [COUGH]  \n", encoding="utf-8")
    assert tok.read_non_lang_symbols(str(good)) == jax_tok.read_non_lang_symbols(str(good)) == SYMS
    assert tok.read_non_lang_symbols(None) == jax_tok.read_non_lang_symbols(None) == []
    bad = tmp_path / "bad.txt"
    bad.write_text("{NOISE}\nNOISE\n", encoding="utf-8")
    msgs = []
    for fn in (tok.read_non_lang_symbols, jax_tok.read_non_lang_symbols):
        with pytest.raises(ValueError, match="must be formatted") as e:
            fn(str(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


TEXTS = ["今天天气很好", " 你好 世界 ", "我{noise}们<laugh>好[cough]的[other]", "<sos>开始<eos>",
         "hello 世界 ok", "a b  c", "未闭合<的括号", "[NOISE]{COUGH}"]


@pytest.mark.parametrize("opts", [
    {}, {"non_lang_syms": SYMS}, {"non_lang_syms": "file"},
    {"non_lang_syms": SYMS, "split_with_space": True},
    {"split_with_space": True, "connect_symbol": " "}, {"connect_symbol": "▁"},
], ids=["default", "syms_list", "syms_file", "syms_split_space", "split_space_join",
        "connect_symbol"])
def test_char_tokenizer_options_match_jax(opts, tmp_path):
    if opts.get("non_lang_syms") == "file":
        f = tmp_path / "syms.txt"
        f.write_text("\n".join(SYMS) + "\n", encoding="utf-8")
        opts = {**opts, "non_lang_syms": str(f)}
    chars = sorted({c for t in TEXTS for c in t if not c.isspace()})
    p = tok.CharTokenizer(tokens=chars + SYMS + ["▁"], **opts)
    j = jax_tok.CharTokenizer(tokens=chars + SYMS + ["▁"], **opts)
    assert p.non_lang_syms == j.non_lang_syms
    for text in TEXTS:
        pt = p.tokenize_text(text)
        assert pt == j.tokenize_text(text), text
        assert p.encode_text(text) == j.encode_text(text)
        assert p.tokens2text(pt) == j.tokens2text(pt)


def test_beautify_result_matches_jax():
    pool = ["你", "好", "世界", "hello", "wor@@", "ld", "it's", "@@", "ab@@", "<sos>", "<eos>",
            "<unk>", "1", "。", "x@@", "A", "é", "ok", "大家"]
    r = _rng(2)
    for _ in range(300):
        toks = [pool[i] for i in r.integers(0, len(pool), r.integers(0, 12))]
        assert beautify.beautify_result(toks) == jax_beautify.beautify_result(toks), toks


def test_cer_matches_jax_on_random_pairs():
    """A 3-symbol alphabet makes equal-cost alignments common."""
    r = _rng(3)
    pairs = [(r.integers(0, 3, r.integers(0, 9)).tolist(),
              r.integers(0, 3, r.integers(0, 9)).tolist()) for _ in range(400)]
    for ref, hyp in pairs:
        got, want = cer.cer_details(ref, hyp), jax_cer.cer_details(ref, hyp)
        assert _sdin(got) == _sdin(want), (ref, hyp)
    got, want = cer.corpus_cer(pairs), jax_cer.corpus_cer(pairs)
    assert _sdin(got) == _sdin(want) and got.cer == want.cer and got.errors == want.errors


@pytest.mark.parametrize("ref,hyp,sdi", [
    ("ab", "ba", (2, 0, 0)),  # D + I costs the same; the walk takes the diagonal first
    ("abc", "bca", (0, 1, 1)),
    ("aab", "abb", (1, 0, 0)),
    ("abab", "baba", (0, 1, 1)),
    ("ab", "", (0, 2, 0)),
    ("", "ab", (0, 0, 2)),
    ("abc", "xyz", (3, 0, 0)),
    ("aaa", "aaaa", (0, 0, 1)),
    ("abcd", "acbd", (2, 0, 0)),
    ("abcb", "bcbb", (0, 1, 1)),  # one D and one I beat the diagonal here
])
def test_cer_tie_order_matches_jax(ref, hyp, sdi):
    p, j = cer.cer_details(list(ref), list(hyp)), jax_cer.cer_details(list(ref), list(hyp))
    assert _sdin(p) == _sdin(j) == (*sdi, len(ref))


@pytest.mark.parametrize("line", [
    "ka2 er2 pu3 pei2 wai4 sun1 wan2 hua2 ti1",
    "huar4 er2 nar3 zher4",  # erhua splits off "er"; "er" itself stays
    "ta1 IY1 shuo1 P ba4",  # IY is dropped, P becomes pi
    "  a1  o  r5 5 ",  # toneless, a bare r, a bare tone
])
def test_normalize_pinyin_matches_jax(line):
    assert bznsyp.normalize_pinyin(line) == jax_bz.normalize_pinyin(line)


def _transcript(path, ids):
    r = _rng(4)
    lines = []
    for i in ids:
        syl = r.choice(pinyin.PINYIN_SYLLABLES, r.integers(2, 6)).tolist()
        lines += [f"{i:06d}\t合成#1语音#4。", "\t" + " ".join(f"{s}{r.integers(1, 6)}" for s in syl)
                  + (" huar2" if i % 3 == 0 else "")]
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")


def test_prosody_labeling_and_split_dataset_match_jax(tmp_path):
    text = tmp_path / "labels.txt"
    _transcript(text, [1, 2, 7, 8, 9, 11, 12, 20])
    assert bznsyp.parse_prosody_labeling(str(text)) == jax_bz.parse_prosody_labeling(str(text))
    kw = dict(wav_pattern="Wave/{utt}.wav", train_max=8, dev_max=11)
    got = bznsyp.split_dataset(str(text), str(tmp_path / "port"), **kw)
    want = jax_bz.split_dataset(str(text), str(tmp_path / "jax"), **kw)
    assert got == want == {"train": 4, "dev": 2, "test": 2}
    for split in ("train", "dev", "test"):
        for f in ("wav.scp", "pinyin"):
            assert ((tmp_path / "port" / split / f).read_bytes()
                    == (tmp_path / "jax" / split / f).read_bytes())
    bad = tmp_path / "bad.txt"
    bad.write_text("000001 no tab\n\tka2\n", encoding="utf-8")
    for fn in (bznsyp.parse_prosody_labeling, jax_bz.parse_prosody_labeling):
        with pytest.raises(ValueError, match="bad transcript line"):
            fn(str(bad))


def test_scp_text_readers_and_iter_utterances_match_jax(tmp_path):
    scp, text = tmp_path / "wav.scp", tmp_path / "pinyin"
    scp.write_text("000001\tWave/000001.wav\n000002\tWave/000002.wav\n000003\tWave/3.wav\n",
                   encoding="utf-8")
    text.write_text("000002\tka er\n000001\tni hao ma\n000009\tzhe\n", encoding="utf-8")
    for root in ("", "/corpus"):
        assert bznsyp.read_scp(str(scp), root) == jax_bz.read_scp(str(scp), root)
        assert (list(bznsyp.iter_utterances(str(scp), str(text), root))
                == list(jax_bz.iter_utterances(str(scp), str(text), root)))
    assert bznsyp.read_text(str(text)) == jax_bz.read_text(str(text))
    bad = tmp_path / "bad"
    bad.write_text("000001\n", encoding="utf-8")
    for fn, what in ((bznsyp.read_scp, "wav.scp"), (jax_bz.read_scp, "wav.scp"),
                     (bznsyp.read_text, "text"), (jax_bz.read_text, "text")):
        with pytest.raises(ValueError, match=f"bad {what} line"):
            fn(str(bad))


def _write_wav(path, width, channels, n=3001, rate=22050):
    r = _rng(5, width, channels)
    if width == 1:
        x = r.integers(0, 256, (n, channels)).astype(np.uint8)
    elif width == 2:
        x = r.integers(-32768, 32768, (n, channels)).astype("<i2")
        x[:3] = [[-32768], [32767], [0]]
    else:
        x = r.integers(-2**31, 2**31, (n, channels)).astype("<i4")
        x[:2] = [[-2**31], [2**31 - 1]]
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(x.tobytes())


@pytest.mark.parametrize("dtype", ["float32", "int16"])
@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("width", [1, 2, 4])
def test_read_wav_bit_for_bit(width, channels, dtype, tmp_path):
    path = tmp_path / "x.wav"
    _write_wav(path, width, channels)
    (got, sr), (want, jsr) = bznsyp.read_wav(str(path), dtype), jax_bz.read_wav(str(path), dtype)
    assert sr == jsr == 22050 and got.dtype == want.dtype and got.shape == want.shape == (3001,)
    assert got.dtype == (np.int16 if dtype == "int16" else np.float32)
    assert got.tobytes() == want.tobytes()


def test_read_wav_refuses_24_bit(tmp_path):
    path = tmp_path / "x.wav"
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(16000)
        w.writeframes(bytes(30))
    for fn in (bznsyp.read_wav, jax_bz.read_wav):
        with pytest.raises(ValueError, match="unsupported sample width 3"):
            fn(str(path))
