"""The plain reference against the port at tiny sizes on the CPU: the fbank,
the encoder (full forward and streaming), the losses, and three whole
training steps of an fp32 program. The test imports both; the reference
imports nothing of the port."""

import numpy as np
import pytest
import torch

from benchmark import program, weights
from benchmark.reference import conformer, features, stream_check, synth, train_check
from benchmark.reference import transducer as rt
from benchmark.reference.precision import Precision, round_fp8, round_tf32
from benchmark.tests.tiny import (
    TINY_AED_TRAIN, TINY_STREAM, TINY_TRAIN, tiny_aed_config, tiny_config,
)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def built():
    cfg = tiny_config()
    pcfg, model = program.build_model(cfg, "serve", 11, CPU)
    w = weights.make(11, program.leaves(model), cfg, CPU)
    return cfg, pcfg, model, w


def test_weights_reach_the_program(built):
    cfg, _, model, w = built
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), w[n]), n
    blank = cfg["model"]["blank_id"]
    assert float(w["joint.ffn_out_bias"][blank]) == pytest.approx(cfg["model"]["blank_bias"])
    assert not w["joint.ffn_out_kernel"][:, blank].any()


def test_fbank(built):
    from tpuasr_torch.audio import fbank_batch

    cfg, pcfg, _, _ = built
    pool = synth.stream_waves(torch.Generator().manual_seed(1), TINY_STREAM, 64, 16000)
    waves, lens = pool["waves"][0], pool["lens"][0]
    ours = features.logmel(waves, cfg["feature"], Precision())
    theirs, _ = fbank_batch(waves, lens, pcfg.feature, device=CPU)
    assert (ours - theirs).abs().max() < 1e-3  # dB; both fp32 DFT products


def test_encoder_full_and_streaming(built):
    cfg, _, model, w = built
    g = torch.Generator().manual_seed(2)
    feats = torch.randn(3, 75, 80, generator=g)
    lens = torch.tensor([75, 60, 41])
    ref, ref_lens = conformer.encoder(w, cfg["model"]["encoder"], feats, lens, 4, 2, Precision())
    with torch.no_grad():
        out, out_lens = model.encode(feats, lens, decoding_chunk_size=4, num_decoding_left_chunks=2)
    valid = torch.arange(out.shape[1])[None, :] < out_lens[:, None]
    assert torch.equal(ref_lens, out_lens)
    assert (ref - out).abs()[valid].max() < 1e-5
    # the streaming view: chunk by chunk against the chunk-masked forward, no pad mask
    from tpuasr_torch.streaming import chunk_windows

    n = 4
    win = chunk_windows(feats, 4, 4, 6, n)
    st = model.init_encoder_state(3, 4, 2)
    outs = []
    with torch.no_grad():
        for k in range(n):
            y, st = model.encode_chunk(win[k], st)
            outs.append(y)
    need = stream_check._need_frames(n, 4)
    full = torch.nn.functional.pad(feats, (0, 0, 0, need - feats.shape[1]))
    ref, _ = conformer.encoder(w, cfg["model"]["encoder"], full, lens, 4, 2, Precision(),
                               pad_masked=False)
    assert (ref - torch.cat(outs, 1)).abs().max() < 1e-5


def test_losses():
    from tpuasr_torch.losses import ctc_loss_from_logits, rnnt_loss_from_logits

    g = torch.Generator().manual_seed(3)
    logits = torch.randn(3, 9, 5, 7, generator=g)
    labels = torch.randint(1, 7, (3, 4), generator=g)
    t_lens, u_lens = torch.tensor([9, 7, 5]), torch.tensor([4, 3, 2])
    ours = rt.rnnt_nll(logits, labels, t_lens, u_lens, 0).mean()
    theirs = rnnt_loss_from_logits(logits, labels, t_lens, u_lens, 0, "mean")
    assert ours.item() == pytest.approx(theirs.item(), rel=1e-5)
    c = torch.randn(3, 9, 7, generator=g)
    ours = rt.ctc_nll(c, t_lens, labels, u_lens, 0).sum() / 3
    theirs = ctc_loss_from_logits(c, t_lens, labels, u_lens, 0, "sum_over_batch")
    assert ours.item() == pytest.approx(theirs.item(), rel=1e-5)


@pytest.mark.parametrize("make_cfg,params", [(tiny_config, TINY_TRAIN),
                                             (tiny_aed_config, TINY_AED_TRAIN)])
def test_three_fp32_steps_follow_the_program(make_cfg, params):
    """An fp32 program and the fp32 reference from the same weights,
    batches, dropout masks (the attention probabilities' too) and chunk
    draws agree to rounding: the transducer and the hybrid CTC / attention
    model."""
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = make_cfg()
    cfg["modes"]["train"] = {"model.compute_dtype": "float32",
                             "feature.fbank_precision": "highest"}
    pcfg, model = program.build_model(cfg, "train", 5, CPU)
    tx = make_optimizer(pcfg.optim)
    state, step = TrainState.create(model, tx), make_train_step(model, tx, pcfg)
    batches = synth.train_batches(torch.Generator().manual_seed(9), params,
                                  cfg["model"]["vocab_size"], 16000, 512)
    losses = []
    for i in range(3):
        state, met = step(state, batches[i], 5)
        losses.append(met["loss"])
        if i == 0:
            mu1 = state.opt_state.mu.clone()
    p3 = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    w = weights.make(5, program.leaves(model), cfg, CPU)
    ref = train_check.follow(cfg, w, batches, 5, Precision(), rows=2)
    got = train_check.compare(train_check.program_side(losses, mu1, p3, w, cfg["optim"]), ref)
    assert got["loss"] < 1e-6 and got["grad"] < 1e-4 and got["change"] < 1e-3


def test_rounding():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(4))
    r = round_tf32(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)  # 10 mantissa bits left
    assert torch.all((r - x).abs() <= x.abs() * 2.0 ** -11)
    assert torch.equal(round_tf32(torch.tensor([1.0 + 2.0 ** -12])), torch.tensor([1.0]))
    y = round_fp8(torch.tensor([448.0, 1.0, 0.3]))
    assert y[0] == 448.0 and y[1] == 1.0 and abs(float(y[2]) - 0.3) < 0.02


def test_durations_are_the_same_set_for_every_seed():
    d = synth.stream_durations({"streams": 1024, "min_s": 2.0, "max_s": 10.0, "mean_s": 4.3,
                                "sigma": 0.4})
    assert d.min() >= 2.0 and d.max() == 10.0 and abs(d.mean() - 4.3) < 0.02
    a = synth.stream_waves(torch.Generator().manual_seed(1), TINY_STREAM, 64, 16000)["lens"]
    b = synth.stream_waves(torch.Generator().manual_seed(2), TINY_STREAM, 64, 16000)["lens"]
    assert np.array_equal(np.sort(a[0].numpy()), np.sort(b[0].numpy()))
    assert not torch.equal(a, b)
