"""The corpus-to-text path of the port == the JAX package's on the CPU.

A BZNSYP-layout corpus in a temporary directory (8 utterances of 3-5
syllables, 16 kHz 16-bit WAVs of the synthetic chord speech, ids 1-4 train,
5-8 dev), and the tiny flagship (2 blocks, d32; converted weights, the
blank logit at 0.9 so hypotheses both emit and take blanks, the other
special ids' logits at -10 as training leaves them) over the corpus'
vocabulary:
- `scan_split` + `make_pipeline` give the JAX package's batches exactly,
  for the float32 and the int16 wire formats;
- `evaluate_offline` in all five transducer modes gives the JAX package's
  `EvalResult`: S/D/I/N and every (utt, REF, HYP) sample, exactly;
- `evaluate_streaming` gives the JAX package's greedy and beam counts and
  samples exactly;
- `decode_stream` on a checkpoint of those weights stops at the WAV's true
  encoder length: its last greedy line is the library's streaming decode
  of the WAV, and the ungated decode of the zero-padded last window emits
  trailing tokens after it;
- the CLIs in this process through `main(argv)` with `--device cpu`, in the
  chain split_data -> gen_vocab -> the trainer with --data_root for one
  epoch -> evaluate -> eval_streaming -> decode_stream: split_data and
  gen_vocab write the JAX tools' files, and the printed CER, hypotheses and
  candidates equal the JAX functions' on the trained weights (converted
  back to the flax layout);
- every CLI that runs a model raises without `--device` on this card-less
  machine.
"""

import copy
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.audio import fbank as jax_fbank
from tpuasr.config import adapt_to_backend, to_dict
from tpuasr.config import load_yaml as jax_load_yaml
from tpuasr.data import bznsyp as jax_bz
from tpuasr.data.corpus import make_pipeline as jax_make_pipeline
from tpuasr.data.corpus import scan_split as jax_scan_split
from tpuasr.decode import rnnt_streaming as jax_streaming
from tpuasr.eval import evaluate_offline as jax_evaluate_offline
from tpuasr.eval import evaluate_streaming as jax_evaluate_streaming
from tpuasr.models import Transducer as JaxTransducer
from tpuasr.models.transducer import stream_output_len as jax_stream_output_len
from tpuasr.nn.subsampling import SUBSAMPLE_CLASSES as JAX_SUBSAMPLE
from tpuasr.streaming.chunkwise import chunk_windows as jax_chunk_windows
from tpuasr.streaming.chunkwise import num_chunks as jax_num_chunks
from tpuasr.text import Tokenizer as JaxTokenizer
from tpuasr_torch.config import Config, from_dict, save_yaml
from tpuasr_torch.audio import fbank
from tpuasr_torch.convert import _convert_leaf, load_jax_params
from tpuasr_torch.data import make_pipeline, read_wav, scan_split
from tpuasr_torch.data.synthetic import write_bznsyp_corpus
from tpuasr_torch.eval import evaluate_offline, evaluate_streaming
from tpuasr_torch.decode import streaming_greedy_decode
from tpuasr_torch.decode.rnnt_streaming import init_streaming_state, process_chunk
from tpuasr_torch.models import Transducer
from tpuasr_torch.streaming import chunk_windows, num_chunks
from tpuasr_torch.text import PINYIN_SYLLABLES, Tokenizer
from tpuasr_torch.tools import decode_stream, eval_streaming, evaluate, gen_vocab, split_data
from tpuasr_torch.tools import train as train_tool
from tpuasr_torch.train import TrainState, make_optimizer, save_checkpoint

torch.set_num_threads(1)  # six test workers share the cores

ROOT = Path(__file__).resolve().parents[1]
BLANK, BLANK_BIAS, CHUNK, LEFT, SR = 5, 0.9, 4, 2, 16000
MODES = ("rnnt_greedy", "rnnt_beam", "ctc_greedy", "ctc_prefix_beam", "rnnt_rescoring")
TINY = ["model.encoder.num_blocks=2", "model.encoder.output_size=32",
        "model.encoder.attention_heads=2", "model.encoder.linear_units=64",
        "model.encoder.cnn_module_kernel=7", "model.predictor.embed_size=16",
        "model.predictor.hidden_size=16", "model.predictor.output_size=32",
        "model.joint.join_dim=32", f"feature.sample_rate={SR}", "data.batch_size=4",
        f"streaming.chunk_size={CHUNK}", f"streaming.num_left_chunks={LEFT}"]


def _sdin(c):
    return c.substitutions, c.deletions, c.insertions, c.ref_len


def _argv_data(root):
    split = f"{root}/split"
    sets = [f"data.{s}_{k}={split}/{s}/{f}" for s in ("train", "dev", "test")
            for k, f in (("wav_scp", "wav.scp"), ("text", "pinyin"))]
    return sets + [f"data.vocab_file={root}/vocab.txt"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The corpus on disk, split and its vocabulary written by the port's
    CLIs; -> (root, transcript path, the split CLI's counts, gen_vocab's)."""
    root = str(tmp_path_factory.mktemp("corpus"))
    r = np.random.default_rng(0)
    syl = sorted(r.choice(PINYIN_SYLLABLES, 12, replace=False).tolist())
    transcripts = [r.choice(syl, int(r.integers(3, 6))).tolist() for _ in range(8)]
    text = write_bznsyp_corpus(root, transcripts, SR, 24 * 512, seed=0)
    counts = split_data.main(["--transcript", text, "--out_dir", f"{root}/split",
                              "--train_max", "4", "--dev_max", "8"])
    n = gen_vocab.main(["--pinyin_files", *(f"{root}/split/{s}/pinyin"
                                            for s in ("train", "dev", "test")),
                        "--out", f"{root}/vocab.txt"])
    return root, text, counts, n


@pytest.fixture(scope="module")
def models(corpus):
    """The tiny flagship over the corpus' vocabulary: (JAX config, model,
    params), (port config, model) with the converted weights, and both
    tokenizers."""
    root = corpus[0]
    jtok, ptok = JaxTokenizer(f"{root}/vocab.txt"), Tokenizer(f"{root}/vocab.txt")
    cfg = _flagship_config(tiny=True)
    cfg.model.vocab_size = jtok.size
    cfg.streaming.chunk_size, cfg.streaming.num_left_chunks = CHUNK, LEFT
    cfg.data.batch_size = 4
    jm = JaxTransducer(cfg.model)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 32, 80), np.float32),
                              np.full((1,), 32, np.int32), np.zeros((1, 2), np.int32),
                              np.full((1,), 2, np.int32))
    params = jax.tree.map(np.array, params)
    params["params"]["joint"]["ffn_out_bias"][BLANK] = BLANK_BIAS
    params["params"]["joint"]["ffn_out_bias"][:BLANK] = -10.0
    params["params"]["ctc"]["ctc_lo"]["bias"][:BLANK] = -10.0
    pcfg = from_dict(Config, to_dict(cfg))
    port = load_jax_params(Transducer(pcfg.model, device="cpu"), params)
    return (cfg, jm, params), (pcfg, port), (jtok, ptok)


def _split(root, name):
    return f"{root}/split/{name}/wav.scp", f"{root}/split/{name}/pinyin"


@pytest.fixture(scope="module")
def batches(corpus, models):
    """One batch of 4 a split, train then dev, from each package."""
    root = corpus[0]
    (cfg, _, _), (pcfg, _), (jtok, ptok) = models
    jb = [b for s in ("train", "dev") for b in
          jax_make_pipeline(jax_scan_split(*_split(root, s), jtok, root), cfg).batches(0)]
    pb = [b for s in ("train", "dev") for b in
          make_pipeline(scan_split(*_split(root, s), ptok, root), pcfg).batches(0)]
    return jb, pb


@pytest.mark.parametrize("wire", ["float32", "int16"])
def test_scan_split_and_pipeline_match_jax(corpus, models, wire):
    root = corpus[0]
    (cfg, _, _), (pcfg, _), (jtok, ptok) = models
    cfg.data.wire_dtype = pcfg.data.wire_dtype = wire
    try:
        for s in ("train", "dev"):
            jm, pm = jax_scan_split(*_split(root, s), jtok, root), scan_split(*_split(root, s),
                                                                              ptok, root)
            assert [(m.utt_id, m.path, m.wave_len) for m in pm] == \
                   [(m.utt_id, m.path, m.wave_len) for m in jm]
            for a, b in zip(pm, jm):
                np.testing.assert_array_equal(a.tokens, b.tokens)
                assert a.tokens[0] == 2 and a.tokens[-1] == 3  # <sos> ... <eos>
            got = list(make_pipeline(pm, pcfg).batches(0))
            want = list(jax_make_pipeline(jm, cfg).batches(0))
            assert len(got) == len(want) == 1 and int(got[0]["num_valid"]) == 4
            for g, w in zip(got, want):
                assert g.keys() == w.keys() and g["utt_ids"] == w["utt_ids"]
                for k in ("waves", "wave_lens", "texts", "text_lens", "num_valid"):
                    assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
            assert got[0]["waves"].dtype == (np.int16 if wire == "int16" else np.float32)
    finally:
        cfg.data.wire_dtype = pcfg.data.wire_dtype = "float32"


@pytest.mark.parametrize("mode", MODES)
def test_evaluate_offline_matches_jax(models, batches, mode):
    (cfg, jm, params), (pcfg, port), (jtok, ptok) = models
    jb, pb = batches
    want = jax_evaluate_offline(jm, params, jb, cfg, jtok, mode=mode, max_samples=8)
    got = evaluate_offline(port, pb, pcfg, ptok, mode=mode, max_samples=8)
    assert _sdin(got.counts) == _sdin(want.counts) and got.cer == want.cer
    assert got.samples == want.samples and len(got.samples) == 8
    assert any(h for _, _, h in got.samples), "every hypothesis is empty"


def test_evaluate_streaming_matches_jax(models, batches):
    (cfg, jm, params), (pcfg, port), (jtok, ptok) = models
    jb, pb = batches
    want = jax_evaluate_streaming(jm, params, jb, cfg, jtok, beam_size=4, max_samples=8)
    got = evaluate_streaming(port, pb, pcfg, ptok, beam_size=4, max_samples=8)
    assert _sdin(got.greedy) == _sdin(want.greedy) and _sdin(got.beam) == _sdin(want.beam)
    assert got.samples == want.samples and len(got.samples) == 8
    assert got.relative_improvement == want.relative_improvement


def _jax_decode_stream(cfg, jm, params, wav, tok, beam=4):
    """What the JAX demo (tools/decode_stream.py) prints for `wav`: each
    chunk's greedy hypothesis, then (text, logp) of each beam candidate; its
    chunk steps jitted."""
    wave, sr = jax_bz.read_wav(wav)
    cfg.feature.sample_rate = sr
    feats = jax_fbank(np.asarray(wave), cfg.feature)[None]
    enc_lens = jax_stream_output_len(cfg.model.encoder, np.array([feats.shape[1]], np.int32))
    c, sub = cfg.model, JAX_SUBSAMPLE[cfg.model.encoder.input_layer]
    chunk, left = cfg.streaming.chunk_size, cfg.streaming.num_left_chunks
    n = jax_num_chunks(feats.shape[1], chunk, sub.subsampling_rate, sub.right_context)
    windows = jax_chunk_windows(feats, chunk, sub.subsampling_rate, sub.right_context, n)
    greedy_step = jax.jit(lambda w, s: jax_streaming.process_chunk(
        jm, params, w, s, c.blank_id, cfg.streaming.n_steps))
    beam_step = jax.jit(lambda w, s: jax_streaming.process_chunk_beam(jm, params, w, s,
                                                                      c.blank_id))
    g = jax_streaming.init_streaming_state(jm, params, 1, chunk, left, c.blank_id,
                                           enc_lens=enc_lens)
    greedy = []
    for i in range(n):
        g = greedy_step(windows[i], g)
        greedy.append(" ".join(tok.decode(np.asarray(g.dec.hyp[0, : int(g.dec.hyp_len[0])])
                                          .tolist())))
    b = jax_streaming.init_streaming_beam_state(jm, params, 1, chunk, left, beam,
                                                enc_lens=enc_lens)
    for i in range(n):
        b = beam_step(windows[i], b)
    logp = np.asarray(b.beam.logp[0])
    cands = [(" ".join(tok.decode(np.asarray(b.beam.tokens[0, j, : int(b.beam.lens[0, j])])
                                  .tolist())), float(logp[j]))
             for j in np.argsort(-logp) if logp[j] >= -1e29]
    return greedy, cands


def _parse_stream(lines):
    greedy = [ln.split(": ", 1)[1] for ln in lines if ln.startswith("chunk")]
    cands = [(ln.split("): ", 1)[1], float(ln.split("logp", 1)[1].split(")")[0]))
             for ln in lines if ln.startswith("cand")]
    return greedy, cands


def _assert_stream_equal(lines, want):
    greedy, cands = _parse_stream(lines)
    assert greedy == want[0]
    assert [t for t, _ in cands] == [t for t, _ in want[1]]
    # the CLI prints logp to 2 decimals; fp32 sums in another order
    np.testing.assert_allclose([x for _, x in cands], [x for _, x in want[1]], atol=0.006)


def test_decode_stream_stops_at_the_wavs_end(corpus, models, tmp_path):
    """On the converted weights with the blank logit at 0.5 (a label at
    most frames): on a dev WAV whose encoder frames are not whole chunks,
    the demo's last greedy line is `streaming_greedy_decode` of the WAV
    gated at its encoder length, and the same chunk loop without the gate
    (every frame of the zero-padded last window decoded) emits trailing
    tokens after it."""
    root = corpus[0]
    (pcfg, port), ptok = models[1], models[2][1]
    model = copy.deepcopy(port)
    with torch.no_grad():
        model.joint.ffn_out_bias[BLANK] = 0.5
    save_yaml(pcfg, str(tmp_path / "train.yaml"))
    save_checkpoint(str(tmp_path / "latest"),
                    TrainState.create(model, make_optimizer(pcfg.optim)))
    hop = pcfg.feature.hop_length
    utt = next(u for u in range(5, 9) if (len(read_wav(f"{root}/Wave/{u:06d}.wav")[0]) // hop
                                          // 2 - 1) // 2 % CHUNK)
    wav = f"{root}/Wave/{utt:06d}.wav"
    lines = decode_stream.main(["--checkpoint", str(tmp_path / "latest"), "--wav", wav,
                                "--vocab", f"{root}/vocab.txt", "--device", "cpu"])
    gated = _parse_stream(lines)[0][-1].split()
    feats = fbank(torch.from_numpy(read_wav(wav)[0]), pcfg.feature)[None]
    st = pcfg.streaming
    toks, n, _ = streaming_greedy_decode(model, feats, torch.tensor([feats.shape[1]]),
                                         st.chunk_size, st.num_left_chunks, BLANK, st.n_steps)
    assert gated == ptok.decode(toks[0, : int(n[0])].tolist()) and gated
    state = init_streaming_state(model, 1, st.chunk_size, st.num_left_chunks, BLANK)
    for w in chunk_windows(feats, st.chunk_size, 4, 6,
                           num_chunks(feats.shape[1], st.chunk_size, 4, 6)):
        state = process_chunk(model, w, state, BLANK, st.n_steps)
    ungated = ptok.decode(state.dec.hyp[0, : int(state.dec.hyp_len[0])].tolist())
    assert len(ungated) > len(gated) and ungated[: len(gated)] == gated


def _flax_params(jm, sd):
    """The port's state_dict in the flax layout of `jm`'s (unrolled) tree:
    each leaf through the converter's own index map, inverted."""
    template = jax.jit(jm.init)(jax.random.PRNGKey(0), np.zeros((1, 32, 80), np.float32),
                                np.full((1,), 32, np.int32), np.zeros((1, 2), np.int32),
                                np.full((1,), 2, np.int32))

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            x = np.asarray(v)
            key, idx = _convert_leaf(path + (k,), np.arange(x.size).reshape(x.shape))
            y = np.empty(x.size, x.dtype)
            y[np.asarray(idx).ravel()] = sd[key].numpy().ravel()
            out[k] = y.reshape(x.shape)
        return out

    return {"params": walk(template["params"], ())}


def test_cli_chain_on_cpu(corpus, tmp_path, monkeypatch, capsys):
    root, text, counts, n_vocab = corpus
    # split_data and gen_vocab write the JAX tools' files
    monkeypatch.syspath_prepend(str(ROOT))
    from tools import gen_vocab as jax_gen_vocab

    assert jax_bz.split_dataset(text, str(tmp_path / "split"), train_max=4, dev_max=8) == counts
    for s in ("train", "dev", "test"):
        for f in ("wav.scp", "pinyin"):
            assert Path(f"{root}/split/{s}/{f}").read_bytes() == \
                   (tmp_path / "split" / s / f).read_bytes()
    monkeypatch.setattr(sys, "argv", ["gen_vocab", "--pinyin_files",
                                      *(f"{root}/split/{s}/pinyin" for s in ("train", "dev")),
                                      "--out", str(tmp_path / "vocab.txt")])
    jax_gen_vocab.main()
    assert Path(f"{root}/vocab.txt").read_bytes() == (tmp_path / "vocab.txt").read_bytes()
    assert n_vocab == len((tmp_path / "vocab.txt").read_text().split())

    # the trainer from disk, one epoch
    exp = tmp_path / "exp"
    res = train_tool.main(["--device", "cpu", "--workload", "online_rnnt", "--data_root", root,
                           "--epochs", "1", "--set", *TINY, *_argv_data(root),
                           f"train.save_dir={exp}", "train.log_dir="])
    assert res.state.step == 1 and np.isfinite(res.train_losses[0])
    ckpt = str(exp / "latest")
    cfg = adapt_to_backend(jax_load_yaml(str(exp / "train.yaml")), "cpu")
    assert cfg.model.vocab_size == n_vocab + 6
    jm = JaxTransducer(cfg.model)
    params = _flax_params(jm, torch.load(ckpt, weights_only=True)["model"])
    jtok = JaxTokenizer(f"{root}/vocab.txt")
    dev = jax_make_pipeline(jax_scan_split(*_split(root, "dev"), jtok, root), cfg).batches(0)
    dev = list(dev)
    capsys.readouterr()

    for mode in ("rnnt_greedy", "rnnt_rescoring"):
        evaluate.main(["--checkpoint", ckpt, "--workload", "online_rnnt", "--mode", mode,
                       "--data_root", root, "--device", "cpu"])
        printed = capsys.readouterr().out.splitlines()
        want = jax_evaluate_offline(jm, params, dev, cfg, jtok, mode=mode)
        c = want.counts
        assert printed[0] == f"effective config: {exp / 'train.yaml'}"
        assert printed[1:] == [f"CER {100 * c.cer:.2f}%  (S={c.substitutions} D={c.deletions} "
                               f"I={c.insertions} N={c.ref_len})"] + [
            ln for u, r, h in want.samples for ln in (f"  [{u}] REF: {r}", f"  [{u}] HYP: {h}")]

    eval_streaming.main(["--checkpoint", ckpt, "--data_root", root, "--device", "cpu"])
    printed = capsys.readouterr().out.splitlines()
    want = jax_evaluate_streaming(jm, params, dev, cfg, jtok, beam_size=4)
    assert printed[1:] == [
        f"streaming greedy CER {100 * want.greedy.cer:.2f}%",
        f"streaming beam-4 CER {100 * want.beam.cer:.2f}%",
        f"relative improvement {100 * want.relative_improvement:.2f}%"] + [
        ln for u, r, g, b in want.samples
        for ln in (f"  [{u}] REF:    {r}", f"  [{u}] GREEDY: {g}", f"  [{u}] BEAM:   {b}")]

    wav = f"{root}/Wave/000006.wav"
    lines = decode_stream.main(["--checkpoint", ckpt, "--wav", wav, "--device", "cpu"])
    assert lines[0].startswith("=== streaming greedy (")
    _assert_stream_equal(lines, _jax_decode_stream(cfg, jm, params, wav, jtok))


@pytest.mark.parametrize("cli,argv", [
    (train_tool, ["--synthetic", "4"]),
    (evaluate, ["--checkpoint", "x"]),
    (eval_streaming, ["--checkpoint", "x"]),
    (decode_stream, ["--checkpoint", "x", "--wav", "x.wav"]),
], ids=["train", "evaluate", "eval_streaming", "decode_stream"])
def test_cli_without_device_refuses_to_run_on_the_cpu(cli, argv):
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
