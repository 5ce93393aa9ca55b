"""The port's data pipeline == the JAX package's, bit for bit, and its
device prefetcher.

- `synth_corpus(hard=True)` (mel-grid chords, jitter, SNR noise, gain
  jitter, the Markov chain) gives the JAX corpus's waves and tokens exactly,
  and so do `hard_chord_table` and `markov_successors`.
- `LengthBucketPipeline` over two epochs gives the JAX pipeline's batches
  exactly (every array and id, in order, and `last_skipped`), with a fixed
  batch size, with `batch_audio_frames`/`batch_multiple` per-bucket sizes,
  with `drop_remainder`, and with per-host sharding; `batch_size_for` and
  `steps_per_epoch` agree.
- `synthetic_pipeline` (hard corpus, int16 wire encoded once at build) gives
  the JAX `synthetic_pipeline`'s batches exactly.
- `prefetch_to_device` on the CPU yields the synchronous path's batches
  (audio seconds and tensors) at depth 0 and 2, int16-encodes the wire, and
  raises an error of the batch iterator in the consumer after the batches
  before it.
"""

import dataclasses

import numpy as np
import pytest
import torch

import tpuasr.config as jax_config
import tpuasr.data.corpus as jax_corpus
import tpuasr.data.synthetic as jax_synth
from tpuasr.data.pipeline import LengthBucketPipeline as JaxPipeline
from tpuasr_torch.config import Config, from_dict, to_dict
from tpuasr_torch.data import (
    LengthBucketPipeline, prefetch_to_device, synth_corpus, synthetic_pipeline, tensors,
)
from tpuasr_torch.data import synthetic

torch.set_num_threads(1)  # six test workers share the cores

V, SR = 412, 16000
HARD = dict(seed=3, min_tokens=2, max_tokens=9, sample_rate=SR, samples_per_token=800,
            hard=True, snr_db=8.0, jitter_mel=10.0, gain_jitter_db=5.0)


def _same_batches(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            if isinstance(r[k], np.ndarray) or np.isscalar(r[k]) and not isinstance(r[k], str):
                assert np.asarray(g[k]).dtype == np.asarray(r[k]).dtype, k
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)
            else:
                assert g[k] == r[k], k
    return len(got)


@pytest.mark.parametrize("markov", [True, False])
def test_hard_corpus_is_bit_identical_to_jax(markov):
    ref = jax_synth.synth_corpus(12, V, markov=markov, **HARD)
    got = synth_corpus(12, V, markov=markov, **HARD)
    assert [u.utt_id for u in got] == [u.utt_id for u in ref]
    for g, r in zip(got, ref):
        assert g.wave.dtype == r.wave.dtype and g.wave_len == r.wave_len
        np.testing.assert_array_equal(g.wave, r.wave)
        np.testing.assert_array_equal(g.tokens, r.tokens)
    np.testing.assert_array_equal(synthetic.hard_chord_table(V, 48000),
                                  jax_synth.hard_chord_table(V, 48000))
    np.testing.assert_array_equal(synthetic.markov_successors(V),
                                  jax_synth.markov_successors(V))


PIPES = {
    "fixed": dict(batch_size=3),
    "audio_frames": dict(batch_size=3, batch_audio_frames=40, batch_multiple=2),
    "drop_remainder": dict(batch_size=3, drop_remainder=True),
    "host_1_of_2": dict(batch_size=2, host_id=1, num_hosts=2),
}


@pytest.mark.parametrize("kind", sorted(PIPES))
def test_length_bucket_pipeline_is_bit_identical_to_jax(kind):
    utts = synth_corpus(30, V, **HARD)
    ref_utts = jax_synth.synth_corpus(30, V, **HARD)
    kw = dict(frame_buckets=(8, 12, 16), token_buckets=(6, 10), hop_length=512, seed=5,
              **PIPES[kind])
    got, ref = LengthBucketPipeline(utts, **kw), JaxPipeline(ref_utts, **kw)
    for epoch in (0, 1):
        n = _same_batches(got.batches(epoch), ref.batches(epoch))
        assert n > 0 and got.last_skipped == ref.last_skipped
        assert got.steps_per_epoch(epoch) == ref.steps_per_epoch(epoch) == n
    for wb in got.wave_buckets:
        assert got.batch_size_for(wb) == ref.batch_size_for(wb)
    if kind == "audio_frames":
        assert {got.batch_size_for(w) for w in got.wave_buckets} == {4, 2}


def test_synthetic_pipeline_is_bit_identical_to_jax():
    jcfg = jax_config.Config()
    jcfg.feature.sample_rate = SR
    jcfg.data = dataclasses.replace(jcfg.data, batch_size=4, synth_hard=True,
                                    wire_dtype="int16", synth_frames_per_token=6,
                                    frame_buckets=(32, 64, 96), token_buckets=(8, 16))
    cfg = from_dict(Config, jax_config.to_dict(jcfg))
    assert to_dict(cfg)["data"] == {k: v for k, v in jax_config.to_dict(jcfg)["data"].items()
                                    if k in to_dict(cfg)["data"]}
    got, ref = synthetic_pipeline(cfg, 20, seed=2), jax_corpus.synthetic_pipeline(jcfg, 20, 2)
    for epoch in (0, 1):
        assert _same_batches(got.batches(epoch), ref.batches(epoch)) > 0
    assert next(iter(got.batches(0)))["waves"].dtype == np.int16


def _host_batches(n=5):
    utts = synth_corpus(4 * n, V, seed=1, sample_rate=SR, samples_per_token=400)
    return list(LengthBucketPipeline(utts, 4, (8, 16, 32), (12,), hop_length=512).batches(0))


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_yields_the_batches_in_order(depth):
    host = _host_batches()
    got = list(prefetch_to_device(iter(host), depth, "cpu", "float32", SR))
    assert len(got) == len(host)
    for (audio_s, db), b in zip(got, host):
        assert audio_s == float(np.sum(b["wave_lens"])) / SR
        ref = tensors(b, "cpu")
        assert db.keys() == ref.keys()
        for k in ref:
            assert torch.equal(db[k], ref[k]), k
    (_, db), = prefetch_to_device(iter(host[:1]), depth, "cpu", "int16", SR)
    assert db["waves"].dtype == torch.int16


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_raises_the_iterators_error_after_its_batches(depth):
    host = _host_batches(3)

    def batches():
        yield from host[:2]
        raise RuntimeError("corpus read failed")

    seen = []
    with pytest.raises(RuntimeError, match="corpus read failed"):
        for item in prefetch_to_device(batches(), depth, "cpu", "float32", SR):
            seen.append(item)
    assert len(seen) == 2
