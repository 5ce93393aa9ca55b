"""The port's library modules == JAX on the CPU: CTC forced alignment and
the timestamp helpers, the learning-rate schedules, checkpoint averaging
and partial loading, global CMVN and the compute_cmvn CLI.

- `ctc_forced_align` against JAX's on random log-probs (ragged input and
  label lengths, a row with no labels, a row too short for its labels)
  and on log-probs from integer logits, where many Viterbi candidates tie:
  alignments exact (ties go to the first candidate on both sides), scores
  to rtol 1e-5; `token_timestamps`, `replace_duplicates_with_blank`,
  `gen_ctc_peak_time` and `gen_timestamps_from_peak` on those alignments
  exact.
- All nine schedules over a step grid (0 to 5,000, both sides of each
  warmup and hold edge), as ints and as tensors: rtol 1e-6 (fp32 math,
  cos / sqrt / pow one ulp apart at most).
- `average_params` of three converted CTCModel trees equals JAX's average
  converted (float64 sums of three terms: exact), and so does
  `average_checkpoints` over the port's checkpoint files; `load_partial`
  with prefix "encoder" copies what JAX's does with "params.encoder"
  (the same entries, the same count).
- CMVN: `compute_cmvn_stats` (with and without lengths) and `apply_cmvn`
  against JAX (rtol 1e-6); the json stats round trip; the wenet json-stats
  and kaldi text files the test writes load to JAX's (mean, istd)
  exactly; a kaldi binary file raises on both sides.
- `python -m tpuasr_torch.tools.compute_cmvn` (in process, --device cpu)
  on a 3-utterance BZNSYP-layout corpus at 16 kHz against
  tools/compute_cmvn.py: mean and istd to rtol 1e-4 (the fbanks' dB
  differ by ~1e-5).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tools.compute_cmvn as jax_compute_cmvn
import tpuasr.audio.cmvn as jax_cmvn
import tpuasr.decode.alignment as jax_align
import tpuasr.train.average as jax_average
from tpuasr.config import CTCModelConfig as JaxCTCConfig
from tpuasr.models import CTCModel as JaxCTCModel
from tpuasr.train.schedules import SCHEDULES as JAX_SCHEDULES
from tpuasr.train.schedules import get_schedule as jax_get_schedule
from tpuasr_torch.audio import cmvn
from tpuasr_torch.config import CTCModelConfig, OptimConfig
from tpuasr_torch.convert import convert_params, load_jax_params
from tpuasr_torch.data.synthetic import write_bznsyp_corpus
from tpuasr_torch.decode import alignment
from tpuasr_torch.models import CTCModel
from tpuasr_torch.tools.compute_cmvn import main as compute_cmvn_main
from tpuasr_torch.train import TrainState, make_optimizer, save_checkpoint
from tpuasr_torch.train.average import average_checkpoints, average_params, load_partial
from tpuasr_torch.train.schedules import SCHEDULES, get_schedule

torch.set_num_threads(1)  # six test workers share the cores

# ----------------------------------------------------------------- alignment


def _align_case(kind: str):
    r = np.random.default_rng(3)
    b, t, v, u, blank = 4, 30, 9, 6, 0
    logits = r.standard_normal((b, t, v)) * 2
    if kind == "ties":
        logits = np.round(logits)  # integer logits: equal log-probs, tied candidates
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits.astype(np.float32)), -1))
    labels = r.integers(1, v, (b, u)).astype(np.int32)
    labels[0, 1] = labels[0, 0]  # a repeat: the blank between them is forced
    return (lp, labels, np.array([30, 22, 3, 17], np.int32),
            np.array([6, 4, 5, 0], np.int32), blank)


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_forced_align_and_timestamps_match_jax(kind):
    lp, labels, il, ll, blank = _align_case(kind)
    want_align, want_scores = (np.asarray(x) for x in jax_align.ctc_forced_align(
        jnp.asarray(lp), labels, il, ll, blank))
    got_align, got_scores = alignment.ctc_forced_align(
        torch.from_numpy(lp), torch.from_numpy(labels), torch.from_numpy(il),
        torch.from_numpy(ll), blank)
    np.testing.assert_array_equal(got_align.numpy(), want_align)
    np.testing.assert_allclose(got_scores.numpy(), want_scores, rtol=1e-5)
    assert alignment.token_timestamps(got_align, blank) == \
        jax_align.token_timestamps(want_align, blank)
    greedy = lp.argmax(-1)
    for row in list(want_align) + list(greedy):
        row = [int(x) for x in row]
        assert alignment.replace_duplicates_with_blank(row, blank) == \
            jax_align.replace_duplicates_with_blank(row, blank)
        peaks = alignment.gen_ctc_peak_time(row, blank)
        assert peaks == jax_align.gen_ctc_peak_time(row, blank)
        if peaks:
            assert alignment.gen_timestamps_from_peak(peaks, 1.1, 0.04, 0.3) == \
                jax_align.gen_timestamps_from_peak(peaks, 1.1, 0.04, 0.3)


# ----------------------------------------------------------------- schedules

def _schedule_kwargs(name: str) -> dict:
    kw = {"lr": 1e-3, "warmup_steps": 100}
    if name == "noam":
        kw = {"base_lr": 1e-3, "warmup_steps": 100, "d_model": 256}
    elif name in ("warmup_hold", "noam_hold_annealing"):
        kw.update(hold_steps=50, min_lr=1e-5)
    elif name.endswith("annealing"):
        kw.update(max_steps=1000, min_lr=1e-5)
    return kw


@pytest.mark.parametrize("name", sorted(JAX_SCHEDULES))
def test_schedules_match_jax(name):
    assert sorted(SCHEDULES) == sorted(JAX_SCHEDULES)
    kw = _schedule_kwargs(name)
    port, ref = get_schedule(name, **kw), jax_get_schedule(name, **kw)
    steps = [0, 1, 5, 98, 99, 100, 101, 148, 149, 150, 151, 500, 998, 999, 1000, 5000]
    want = np.array([float(ref(jnp.asarray(s))) for s in steps])
    for arg in (lambda s: s, lambda s: torch.tensor(s)):
        got = np.array([float(port(arg(s))) for s in steps])
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)


# ----------------------------------------------------------------- averaging

@pytest.fixture(scope="module")
def ctc_trees():
    jcfg = JaxCTCConfig(hidden_dim=16, attention_heads=2, num_blocks=1, kernel_size=3)
    feats = np.zeros((1, 40, 80), np.float32)
    model = JaxCTCModel(jcfg, 20, 5)
    trees = [jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(i), feats,
                                                 np.array([40], np.int32)))
             for i in range(3)]
    return jcfg, trees


def test_average_params_and_checkpoints_match_jax(ctc_trees, tmp_path):
    jcfg, trees = ctc_trees
    want = convert_params(jax_average.average_params([t["params"] for t in trees]))
    sds = [convert_params(t) for t in trees]
    got = average_params(sds)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    paths = []
    for i, t in enumerate(trees):
        model = load_jax_params(CTCModel(CTCModelConfig(**vars(jcfg)), 20, 5, device="cpu"), t)
        paths.append(str(tmp_path / f"epoch_{i}"))
        save_checkpoint(paths[-1], TrainState.create(model, make_optimizer(OptimConfig())))
    from_files = average_checkpoints(paths)
    for k in want:
        assert torch.equal(from_files[k], want[k]), k


def test_load_partial_matches_jax(ctc_trees):
    _, trees = ctc_trees
    a, b = trees[0], trees[1]
    want, want_copied = jax_average.load_partial(a, b, ["params.encoder"])
    got, copied = load_partial(convert_params(a), convert_params(b), ["encoder"])
    want = convert_params(want)
    assert len(copied) == len(want_copied) > 0
    assert all(n.startswith("encoder.") for n in copied)
    for k in want:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------------- CMVN

def test_cmvn_matches_jax(tmp_path):
    r = np.random.default_rng(4)
    batches = [(r.standard_normal((3, 50, 8)) * 3 + 5).astype(np.float32) for _ in range(2)]
    lens = [np.array([50, 31, 7], np.int32), np.array([12, 50, 40], np.int32)]
    for with_lens in (lens, None):
        want = jax_cmvn.compute_cmvn_stats(batches, with_lens)
        got = cmvn.compute_cmvn_stats([torch.from_numpy(x) for x in batches],
                                      None if with_lens is None else
                                      [torch.from_numpy(x) for x in with_lens])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-6)
    mean, istd = want
    for norm_var in (True, False):
        ref = np.asarray(jax_cmvn.apply_cmvn(jnp.asarray(batches[0]), mean, istd, norm_var))
        out = cmvn.apply_cmvn(torch.from_numpy(batches[0]), mean, istd, norm_var)
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)
    cmvn.save_cmvn(str(tmp_path / "cmvn.json"), torch.from_numpy(mean), istd)
    back = cmvn.load_cmvn(str(tmp_path / "cmvn.json"))
    assert all(np.array_equal(x, y) for x, y in zip(back, jax_cmvn.load_cmvn(
        str(tmp_path / "cmvn.json"))))
    np.testing.assert_array_equal(back[0], mean)

    sums = r.standard_normal(8) * 100
    sq = np.abs(r.standard_normal(8)) * 1e4 + sums**2 / 1000
    with open(tmp_path / "stats.json", "w") as f:
        json.dump({"mean_stat": sums.tolist(), "var_stat": sq.tolist(), "frame_num": 1000}, f)
    with open(tmp_path / "cmvn.ark", "w") as f:
        f.write(" [\n  " + " ".join(f"{x:.6f}" for x in sums) + " 1000\n  "
                + " ".join(f"{x:.6f}" for x in sq) + " 0 ]\n")
    with open(tmp_path / "binary.ark", "wb") as f:
        f.write(b"\0B" + bytes(16))
    for loader in ("load_cmvn_json_stats", "load_cmvn_kaldi"):
        path = str(tmp_path / ("stats.json" if loader.endswith("stats") else "cmvn.ark"))
        got, want = getattr(cmvn, loader)(path), getattr(jax_cmvn, loader)(path)
        assert all(np.array_equal(x, y) for x, y in zip(got, want)), loader
    for mod in (cmvn, jax_cmvn):
        with pytest.raises(ValueError, match="binary"):
            mod.load_cmvn_kaldi(str(tmp_path / "binary.ark"))


def test_compute_cmvn_cli_matches_jax(tmp_path, monkeypatch):
    root = tmp_path / "corpus"
    write_bznsyp_corpus(str(root), [["ba", "ma"], ["ni", "hao", "ba"], ["ma"]], 16000, 4000)
    (tmp_path / "wav.scp").write_text("".join(f"{i:06d}\tWave/{i:06d}.wav\n"
                                              for i in (1, 2, 3)))
    (tmp_path / "text").write_text("000001\tba ma\n000002\tni hao ba\n000003\tma\n")
    args = ["--wav_scp", str(tmp_path / "wav.scp"), "--text", str(tmp_path / "text"),
            "--data_root", str(root)]
    mean, istd = compute_cmvn_main(args + ["--out", str(tmp_path / "port.json"),
                                           "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["compute_cmvn.py", *args, "--out",
                                      str(tmp_path / "jax.json")])
    jax_compute_cmvn.main()
    want = jax_cmvn.load_cmvn(str(tmp_path / "jax.json"))
    got = cmvn.load_cmvn(str(tmp_path / "port.json"))
    np.testing.assert_array_equal(got[0], mean)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-4)
