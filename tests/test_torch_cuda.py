"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without an NVIDIA card. Edge shapes the
flagship path does not reach: rows not a multiple of the fbank tile, T and
S not multiples of the attention tiles, T != S, dk 16, 32 and 64, a broadcast
[B, 1, S] padding mask, a fully masked query row; for the fused RNN-T joint
(#4/#5) and the CTC lattice (#6/#7): U = 0, t_len = 0, an infeasible CTC
row, B = 1, V = 412 and V = 64, bf16 enc_p/pred_p from a bf16 model; and
the attention wrapper's refusal to run without its backward when a gradient
is asked for. This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

TF32 is off for every fp32 comparison. Tolerances: fp32 sums in another
order (fbank: rtol 1e-4, atol 1e-3 dB; attention: 1e-5); bf16-operand
fbank: one bf16 ulp of a power bin (0.034 dB); bf16 attention: 1e-2 +
1e-2*|ref|, the output and probability roundings to bf16 (2**-8 relative
each) happen at different points in the kernel and the plain version.
Fused joint: log-probs atol 5e-4 (fp32 sums of D products in another
order), gradients 1e-4 of each output's max |.| (the same, added with
atomics); bf16 gradients one bf16 ulp of that max (2**-8). CTC: alpha and ll
1e-3 + 1e-5*|ref| (log-adds whose exp/log1p may differ by an ulp over T
steps), gradients 2e-3*|ref| + 1e-5; the whole CTC loss card vs CPU,
gradient w.r.t. the logits atol 1e-4 (alpha and beta ~ -100 carry an ulp
of 7.6e-6 into the posterior).
"""

from dataclasses import astuple

import pytest
import torch

from tpuasr_torch.audio.fbank import _operands
from tpuasr_torch.config import FeatureConfig
import torch.nn.functional as F

from tpuasr_torch.losses.ctc import ctc_loss_from_logits, lattice_inputs
from tpuasr_torch.ops import (
    LAUNCHES, ctc_alpha, ctc_alpha_plain, ctc_beta_grad, ctc_beta_grad_plain, fbank_frames,
    fbank_frames_plain, relpos_attention, relpos_attention_plain, rnnt_fused_grads,
    rnnt_fused_grads_plain, rnnt_fused_lp, rnnt_fused_lp_plain, rnnt_loss_fused_mean,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("precision,atol", [("highest", 1e-3), ("default", 4e-2)])
@pytest.mark.parametrize("rows,n_fft,sr", [(37, 1024, 48000), (5, 512, 16000)])
def test_fbank_kernel_matches_plain(card, rows, n_fft, sr, precision, atol):
    cfg = FeatureConfig(sample_rate=sr, n_fft=n_fft, win_length=n_fft)
    ops = _operands(astuple(cfg), str(card))
    g = torch.Generator().manual_seed(rows)
    frames = (torch.randn(rows, n_fft, generator=g) * 0.1).to(card)
    frames[1] = 0.0  # a silent frame sits at the log floor
    before = LAUNCHES["fbank"]
    got = fbank_frames(frames, *ops, cfg.amin, precision)
    torch.cuda.synchronize()
    assert LAUNCHES["fbank"] == before + 1
    ref = fbank_frames_plain(frames, *ops, cfg.amin, precision)
    rtol = 1e-4 if precision == "highest" else 0.0
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(got[1], torch.full_like(got[1], -100.0))  # log floor


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,t,s,h,dk,mask_kind", [
    (3, 21, 21, 2, 32, "chunk"), (2, 40, 70, 4, 64, "pad"), (1, 187, 187, 4, 64, "chunk"),
    (3, 21, 21, 2, 16, "chunk"),
])
def test_relpos_attention_kernel_matches_plain(card, dtype, tol, b, t, s, h, dk, mask_kind):
    g = torch.Generator().manual_seed(t * s)
    d = h * dk
    q, k, v = (torch.randn(n, r, d, generator=g).to(card, dtype)
               for n, r in ((b, t), (b, s), (b, s)))
    p = torch.randn(1, s, d, generator=g).to(card, dtype)
    ub, vb = (0.1 * torch.randn(d, generator=g)).to(card, dtype), \
        (0.1 * torch.randn(d, generator=g)).to(card, dtype)
    if mask_kind == "pad":  # [B, 1, S]: read through a zero stride
        mask = torch.ones(b, 1, s, dtype=torch.bool)
        mask[-1, 0, s // 2:] = False
    else:
        i = torch.arange(t)[:, None]
        j = torch.arange(s)[None, :]
        mask = ((j // 4 <= i // 4) & (j >= i - 8)).expand(b, t, s).clone()
        mask[0, t - 1] = False  # fully masked row -> zeros
    mask = mask.to(card)
    scale = dk ** -0.5
    got = relpos_attention(q, k, p, v, ub, vb, mask, scale, h)
    torch.cuda.synchronize()
    ref = relpos_attention_plain(q, k, p, v, ub, vb, mask, scale, h)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    if mask_kind == "chunk":
        assert torch.all(got[0, t - 1] == 0)


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.randn(2, 5, 48, device=card)  # dk 24 is not a kernel width
    mask = torch.ones(2, 5, 5, dtype=torch.bool, device=card)
    with pytest.raises(ValueError, match="head width"):
        relpos_attention(x, x, x[:1], x, x[0, 0], x[0, 0], mask, 0.2, 2)
    y = torch.randn(2, 5, 64, device=card)
    with pytest.raises(ValueError, match="dtype"):
        relpos_attention(*(z.half() for z in (y, y, y[:1], y, y[0, 0], y[0, 0])), mask,
                         0.2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        relpos_attention(y, y.transpose(0, 1).contiguous().transpose(0, 1), y[:1], y,
                         y[0, 0], y[0, 0], mask, 0.2, 2)
    frames = torch.randn(3, 1024, device=card, dtype=torch.float64)
    ops = _operands(astuple(FeatureConfig()), str(card))
    with pytest.raises(ValueError, match="fp32"):
        fbank_frames(frames, *ops)


def _joint_inputs(card, b, t, u, d, v, blank, seed):
    g = torch.Generator().manual_seed(seed)
    enc = torch.randn(b, t, d, generator=g).to(card)
    pred = torch.randn(b, u + 1, d, generator=g).to(card)
    w = (torch.randn(d, v, generator=g) / d ** 0.5).to(card)
    bias = (0.1 * torch.randn(v, generator=g)).to(card)
    lab = torch.randint(0, v, (b, u), generator=g).to(torch.int32).to(card)
    return enc, pred, w, bias, lab


@pytest.mark.parametrize("b,t,u,d,v", [
    (2, 9, 0, 256, 412), (1, 13, 5, 64, 64), (3, 70, 7, 256, 412), (2, 5, 40, 32, 97),
])
def test_rnnt_fused_kernels_match_plain(card, b, t, u, d, v):
    blank = 5
    enc, pred, w, bias, lab = _joint_inputs(card, b, t, u, d, v, blank, t * 100 + u)
    before = (LAUNCHES["rnnt_fused_fwd"], LAUNCHES["rnnt_fused_bwd"])
    got = rnnt_fused_lp(enc, pred, w, bias, lab, blank)
    ref = rnnt_fused_lp_plain(enc, pred, w, bias, lab, blank)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=5e-4)
    g = torch.Generator().manual_seed(1)
    gb = -torch.rand(b, t, u + 1, generator=g).to(card)
    gl = F.pad(-torch.rand(b, t, u, generator=g), (0, 1)).to(card)
    args = (enc, pred, w, bias, lab, got[2], gb, gl, blank)
    grads = rnnt_fused_grads(*args)
    torch.cuda.synchronize()
    assert (LAUNCHES["rnnt_fused_fwd"], LAUNCHES["rnnt_fused_bwd"]) == (before[0] + 1,
                                                                      before[1] + 1)
    for x, y in zip(grads, rnnt_fused_grads_plain(*args)):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max()) + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rnnt_fused_loss_card_matches_cpu(card, dtype):
    """The autograd Function end to end (kernels, lattice, t_len = 0 and
    u_len = 0 rows); bf16 enc_p/pred_p as a bf16 model hands them over, their
    gradients returned in bf16."""
    b, t, u, d, v, blank = 3, 17, 4, 256, 412, 5
    enc, pred, w, bias, lab = _joint_inputs(card, b, t, u, d, v, blank, 7)
    t_lens = torch.tensor([t, 0, 11], dtype=torch.int32)
    u_lens = torch.tensor([u, 2, 0], dtype=torch.int32)
    outs = {}
    for dev in (card, torch.device("cpu")):
        leaves = [x.detach().to(dev, dt).clone().requires_grad_()
                  for x, dt in ((enc, dtype), (pred, dtype), (w, w.dtype), (bias, bias.dtype))]
        loss = rnnt_loss_fused_mean(*leaves, lab.to(dev), t_lens.to(dev), u_lens.to(dev),
                                    blank)
        loss.backward()
        outs[dev.type] = (float(loss.detach()), [x.grad.cpu() for x in leaves])
    assert outs["cuda"][0] == pytest.approx(outs["cpu"][0], rel=1e-5)
    for x, y in zip(outs["cuda"][1], outs["cpu"][1]):
        assert x.dtype == y.dtype
        tol = (2.0 ** -8 if x.dtype == torch.bfloat16 else 1e-4) * float(y.abs().max().float())
        assert float((x.float() - y.float()).abs().max()) <= tol + 1e-6
    assert float(outs["cuda"][1][0][1].abs().max()) == 0.0  # t_len = 0: no gradient


@pytest.mark.parametrize("b,t,u,v", [(1, 30, 6, 412), (4, 50, 12, 64), (3, 8, 0, 20)])
def test_ctc_kernels_match_plain(card, b, t, u, v):
    blank = 5
    g = torch.Generator().manual_seed(b * t)
    lp = torch.log_softmax(torch.randn(b, t, v, generator=g), -1).to(card)
    lab = torch.randint(0, v, (b, u), generator=g).to(card)
    u_lens = torch.full((b,), u, dtype=torch.int32, device=card)
    t_lens = torch.full((b,), t, dtype=torch.int32, device=card)
    if b > 1:
        t_lens[1] = 0  # no frames
    if b > 2 and u >= 3:
        lab[2, :3] = 7  # 7 7 7 needs 5 frames: infeasible in 3
        u_lens[2], t_lens[2] = 3, 3
    lp_states, skip, final = lattice_inputs(lp, lab, u_lens, blank)
    lp_states = lp_states.contiguous()
    ga, gll = ctc_alpha(lp_states, skip, t_lens, final)
    ra, rll = ctc_alpha_plain(lp_states, skip, t_lens, final)
    live = ra > -1e29
    assert torch.equal(live, ga > -1e29)
    assert bool(((ga - ra).abs() <= 1e-3 + 1e-5 * ra.abs())[live].all())
    assert bool(((gll - rll).abs() <= 1e-3 + 1e-5 * rll.abs()).all())
    gvec = torch.rand(b, generator=g).to(card)
    args = (lp_states, skip, t_lens, final, ra.contiguous(), rll.contiguous(), gvec)
    got, ref = ctc_beta_grad(*args), ctc_beta_grad_plain(*args)
    torch.cuda.synchronize()
    assert bool(((got - ref).abs() <= 2e-3 * ref.abs() + 1e-5).all())
    if b > 1:
        assert bool((got[1] == 0).all())


def test_ctc_loss_card_matches_cpu(card):
    b, t, u, v, blank = 4, 40, 9, 412, 5
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(b, t, v, generator=g)
    lab = torch.randint(6, v, (b, u), generator=g)
    t_lens = torch.tensor([t, 31, 0, 4], dtype=torch.int32)
    l_lens = torch.tensor([u, 0, 3, 9], dtype=torch.int32)  # the last row is infeasible
    outs = {}
    for dev in (card, torch.device("cpu")):
        z = logits.to(dev).requires_grad_()
        loss = ctc_loss_from_logits(z, t_lens.to(dev), lab.to(dev), l_lens.to(dev), blank,
                                    "none")
        loss.sum().backward()
        outs[dev.type] = (loss.detach().cpu(), z.grad.cpu())
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-5, atol=1e-3)
    # softmax - posterior; the posterior is exp(alpha + beta - lp - ll) with
    # alpha and beta ~ -100, whose ulp (7.6e-6) the card and the CPU may
    # round differently, so a posterior near 1 may differ by two such ulps
    # (1.5e-5; an H100 read 1.53e-5 at 10 of 65,920 entries): atol 1e-4
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=0, atol=1e-4)
    assert float(outs["cuda"][0][3]) == 0.0 and bool((outs["cuda"][1][3] == 0).all())


def test_relpos_attention_refuses_a_gradient(card):
    x = torch.randn(2, 5, 64, device=card, requires_grad=True)
    mask = torch.ones(2, 5, 5, dtype=torch.bool, device=card)
    with pytest.raises(NotImplementedError, match="#3"):
        relpos_attention(x, x, x[:1], x, x[0, 0], x[0, 0], mask, 0.125, 2)
    with torch.no_grad():  # serving: the kernel runs
        out = relpos_attention(x, x, x[:1], x, x[0, 0], x[0, 0], mask, 0.125, 2)
    assert out.shape == x.shape
