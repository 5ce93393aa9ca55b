"""The port's synthetic batch == JAX's, bit for bit.

`synth_corpus` + `make_batch` at bench.py's arguments (12 utterances of
24-30 content tokens, SOS and EOS added, 48 kHz, (768 - 6) * 512 // 30
samples per token, padded to 767 * 512 samples and 32 tokens) give the
arrays of `tpuasr.data`; `tensors` moves them unchanged; the tokenizer's
special ids are the JAX package's; an utterance read from disk (BZNSYP
metadata) loads into the JAX package's batch.
"""

import numpy as np
import torch

import tpuasr.text.tokenizer as jax_tokenizer
from tpuasr.data.pipeline import BatchSpec as JaxBatchSpec
from tpuasr.data.pipeline import make_batch as jax_make_batch
from tpuasr.data.synthetic import synth_corpus as jax_synth_corpus
from tpuasr_torch.data import BatchSpec, device_view, make_batch, synth_corpus, tensors
from tpuasr_torch.text import tokenizer

torch.set_num_threads(1)  # six test workers share the cores

B, FRAMES, TOKENS, HOP, SR, VOCAB = 12, 768, 32, 512, 48000, 412
CORPUS = dict(seed=0, min_tokens=24, max_tokens=30, sample_rate=SR,
              samples_per_token=(FRAMES - 6) * HOP // 30)


def test_bench_batch_is_bit_identical_to_jax():
    ref = jax_make_batch(jax_synth_corpus(B, VOCAB, **CORPUS),
                         JaxBatchSpec(B, (FRAMES - 1) * HOP, TOKENS))
    got = make_batch(synth_corpus(B, VOCAB, **CORPUS), BatchSpec(B, (FRAMES - 1) * HOP, TOKENS))
    assert got.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], np.ndarray):
            assert got[k].dtype == ref[k].dtype, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
        else:
            assert got[k] == ref[k], k
    # bench.py's labels: SOS, 24-30 content tokens, EOS
    assert got["text_lens"].min() >= 26 and got["text_lens"].max() <= 32
    assert np.all(got["texts"][:, 0] == tokenizer.SOS)
    dev = tensors(got, "cpu")
    assert dev.keys() == device_view(got).keys() == {"waves", "wave_lens", "texts", "text_lens"}
    for k, x in dev.items():
        assert torch.equal(x, torch.from_numpy(got[k]))


def test_special_ids_and_unported_corpus(tmp_path):
    assert tokenizer.SPECIAL_TOKENS == jax_tokenizer.SPECIAL_TOKENS
    assert (tokenizer.PAD, tokenizer.UNK, tokenizer.SOS, tokenizer.EOS, tokenizer.SPACE,
            tokenizer.BLK) == (jax_tokenizer.PAD, jax_tokenizer.UNK, jax_tokenizer.SOS,
                               jax_tokenizer.EOS, jax_tokenizer.SPACE, jax_tokenizer.BLK)
    # the BZNSYP corpus: an utterance's metadata scanned from disk loads into
    # the JAX package's batch
    import wave

    from tpuasr.config import Config as JaxConfig
    from tpuasr.data.corpus import UtteranceMeta as JaxMeta
    from tpuasr.data.corpus import make_pipeline as jax_make_pipeline
    from tpuasr_torch.config import Config
    from tpuasr_torch.data import UtteranceMeta, make_pipeline

    pcm = np.random.default_rng(0).integers(-32768, 32768, 40000).astype("<i2")
    path = str(tmp_path / "u.wav")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(48000)
        w.writeframes(pcm.tobytes())
    toks = np.array([2, 9, 7, 3], np.int32)
    got = next(make_pipeline([UtteranceMeta("u", path, toks, len(pcm))], Config()).batches(0))
    want = next(jax_make_pipeline([JaxMeta("u", path, toks, len(pcm))],
                                  JaxConfig()).batches(0))
    for k in ("waves", "wave_lens", "texts", "text_lens", "num_valid"):
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
