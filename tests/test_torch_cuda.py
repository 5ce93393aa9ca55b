"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without an NVIDIA card. Edge shapes the
flagship path does not reach: rows not a multiple of the fbank tiles, n_fft
not a multiple of the bf16 route's K tile, 128 and 160 mel filters, a shape
whose frames do not fit shared memory (ValueError, on the bf16 and the FFT
route), the FFT route at n_fft 64 to 2,048 and with a dense mel, T and
S not multiples of the attention tiles, T != S, dk 16, 32 and 64, a broadcast
[B, 1, S] padding mask, a fully masked query row; for the fused RNN-T joint
(#4/#5) and the CTC lattice (#6/#7): U = 0, t_len = 0, an infeasible CTC
row, B = 1, the CTC lattice by its warp and its block route at S 1, 31, 33,
63, 65 and 255 (the block route also at 257), with a t_len = 1 row or every
row shorter than T and two calls bit-identical, V = 412, 64 and 30, D 32, 64, 72 and 256, U+1 129, a ragged
last t-chunk of #5's row side, bench.py's training shape (#5 also twice,
bit-identical), bf16 enc_p/pred_p from a bf16 model; the
attention forward (#2) and backward (#3) in fp32 and bf16 at dk 16, 32 and
64 with a fully masked row and a broadcast mask, and at bench.py's training
shape (12 x 191, 4 heads of 64) and the trainer's (12 x 63) with the
encoder's padding and a chunk mask; the forward's saved fp32 output and
log-sum-exp (bf16) against the plain ones and torch.logsumexp of the plain
scores (1e-4 + 1e-5*|ref|, -inf for a fully masked row); autograd through
the Function in fp32 (which saves only the inputs) and in bf16 (one launch
of #2 and one of #3); the RNN-T lattice
(#8/#9) by its warp route at U+1 = 1, 17, 33, 65 and 256 and its block
route at 33, 256 and 257, with a t_len = 0 and a u_len = 0 row and two calls
bit-identical, and the materialized RNN-T loss card against CPU; the fused FFN (#10/#11) at R = 1, 70, 130 and the main paths' 128
(a streaming chunk), 748 (serving), 756 and 1,524 (the trainer) and 2,292
(bench.py's) rows, so one slice and many, a ragged last row tile; D 64 and
256, H 128, 1024 and 160 (not a multiple of the 64-unit weight tiles); fp32
and bf16, no masks and keep-masks at rate 0.1; two calls bit-identical at
the training shape; its autograd Function against plain autograd, and the
fused route against the module route of a training forward on the card; the
decoders (plain PyTorch on the card): the beam searches' top-k order among
ties, and a tiny model's RNN-T beam (one and three emissions a frame, CTC
fusion) and CTC prefix beam (a context graph) against the CPU; a tiny
CTCModel (conv2d8 and conv2d6, an infeasible row) card against CPU
(log-probs atol 1e-4, loss rtol 1e-5, gradients 1e-3 of each leaf's max:
cuDNN's convs sum in another order), CTC forced alignment and greedy
decoding card against CPU on the same log-probs (with ties: identical),
and gradient checkpointing through the attention and FFN kernels on the
card (the flag-off gradients to 1e-4 of the largest, #2 and #10 launched
twice); the Paraformer's CIF fire twice bit-identical on the card and a
tiny Paraformer of each stack decoding greedily to the CPU's counts, tokens
and fire frames; a tiny Whisper's greedy decode card against CPU (tokens
identical); the serving export traced on the card, its loaded artifacts
against the eager path with #10 launched by the artifact. This file
imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

TF32 is off for every fp32 comparison. Tolerances: fp32 sums in another
order (fbank: rtol 1e-4, atol 1e-3 dB; attention: 1e-5); bf16-operand
fbank (the tensor-core route): one bf16 ulp of a power bin (0.034 dB), atol
4e-2 dB, rtol 0, two calls bit-identical at bench.py's 9,216 frames; fbank's
FFT route (fp32): as the dense fp32 route, two calls bit-identical at the
serving requests' 4,112 frames; bf16 attention: 1e-2 +
1e-2*|ref|, the output and probability roundings to bf16 (2**-8 relative
each) happen at different points in the kernel and the plain version.
Fused joint: log-probs atol 5e-4 (fp32 sums of D products in another
order), gradients 1e-4 of each output's max |.| (3xTF32 products, about 22
bits, and sums in another order, fixed between calls); bf16 gradients one
bf16 ulp of that max (2**-8). CTC: alpha and ll
1e-3 + 1e-5*|ref| (log-adds whose exp/log1p may differ by an ulp over T
steps), gradients 2e-3*|ref| + 1e-5; the whole CTC loss card vs CPU,
gradient w.r.t. the logits atol 1e-4 (alpha and beta ~ -100 carry an ulp
of 7.6e-6 into the posterior). Attention backward: fp32 1e-4 of each
output's max (sums in another order; dp, du and dvb added with atomics), bf16
2**-6 of it (ds is rounded to bf16 before the products, and a value on a
rounding edge may round the other way on the other side; the outputs round
to bf16 too). RNN-T lattice: as CTC's (the block route repeats the plain
version's log-adds, exp/log1p may differ by an ulp; the warp route's
log-add of ex2/lg2 rounds at other points, over T + U dependent steps); the materialized loss
card vs CPU: loss rtol 1e-5, gradient atol 1e-4, as the CTC loss. Fused
FFN: fp32 output within 1e-5 of its max |.| and gradients within 1e-4 of
each one's max (sums in another order, fixed between calls); bf16 output within 2**-7 and gradients within 2**-6 of the
max (the same roundings, but a sum in another order can cross a bf16
rounding edge: one ulp is 2**-8 relative); the fused and module routes of a
training step agree to 1e-4 of the largest gradient (fp32, the kernels'
sums against cuBLAS's).
"""

import importlib
from dataclasses import astuple

import pytest
import torch

from tpuasr_torch.audio.fbank import _operands
from tpuasr_torch.config import FeatureConfig
import torch.nn.functional as F

from tpuasr_torch.losses import rnnt_loss_from_logits
from tpuasr_torch.losses.ctc import ctc_loss_from_logits, lattice_inputs
from tpuasr_torch.ops import (
    LAUNCHES, ctc_alpha, ctc_alpha_plain, ctc_beta_grad, ctc_beta_grad_plain, fbank_frames,
    fbank_frames_plain, ffn_bwd, ffn_bwd_plain, ffn_fwd, ffn_fwd_plain, fused_ffn,
    relpos_attention, relpos_attention_bwd, relpos_attention_bwd_plain,
    relpos_attention_plain, rnnt_alpha, rnnt_alpha_plain, rnnt_beta_grad,
    rnnt_beta_grad_plain, rnnt_fused_grads, rnnt_fused_grads_plain, rnnt_fused_lp,
    rnnt_fused_lp_plain, rnnt_loss_fused_mean,
)
from tpuasr_torch.nn.masks import chunk_mask
from tpuasr_torch.ops.relpos_attention import _relpos_fwd
from tpuasr_torch.ops.rnnt_lattice import mask_lattice_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (rows, n_fft, sample rate, n_mels, precision, atol); "highest" by the
# FFT (a power-of-two n_fft): 1, 15, 16, 17, 37 and the serving requests'
# 4,112 rows at n_fft 1024 (blocks of up to 32 frames, a ragged last one),
# n_fft 512, 2048 (two warps a frame) and 64 (16 filters at 8 kHz, several
# frames a warp); "highest" by the dense kernel at n_fft 400 and 130; the
# bf16 route's tile edges: 1, 63, 64, 65 rows (blocks of 32 frames), bench.py's
# 9,216 (blocks of 80, the last one 16), n_fft 512 and 400 at 16 kHz (400 not
# a multiple of the 128-deep K tile), n_fft 130 (frames loaded a float at a
# time, one K tile mostly padding), 128 and 160 mel filters (two slabs of 80
# columns), the last also in blocks of 80 at 6,144 rows
FBANK_CASES = [
    (37, 1024, 48000, 80, "highest", 1e-3), (5, 512, 16000, 80, "highest", 1e-3),
    (1, 1024, 48000, 80, "highest", 1e-3), (15, 1024, 48000, 80, "highest", 1e-3),
    (16, 1024, 48000, 80, "highest", 1e-3), (17, 1024, 48000, 80, "highest", 1e-3),
    (4112, 1024, 48000, 80, "highest", 1e-3), (300, 512, 16000, 80, "highest", 1e-3),
    (70, 2048, 48000, 80, "highest", 1e-3), (70, 64, 8000, 16, "highest", 1e-3),
    (65, 400, 16000, 80, "highest", 1e-3), (7, 130, 8000, 40, "highest", 1e-3),
    (37, 1024, 48000, 80, "default", 4e-2), (5, 512, 16000, 80, "default", 4e-2),
    (1, 1024, 48000, 80, "default", 4e-2), (63, 1024, 48000, 80, "default", 4e-2),
    (64, 1024, 48000, 80, "default", 4e-2), (65, 1024, 48000, 80, "default", 4e-2),
    (9216, 1024, 48000, 80, "default", 4e-2), (300, 512, 16000, 80, "default", 4e-2),
    (65, 400, 16000, 80, "default", 4e-2), (7, 130, 8000, 40, "default", 4e-2),
    (70, 512, 16000, 128, "default", 4e-2), (70, 512, 16000, 160, "default", 4e-2),
    (6144, 512, 16000, 160, "default", 4e-2),
]


def _fbank_route(n_fft, precision):
    """The route the plan must pick: by the FFT at a power-of-two n_fft."""
    if precision == "default":
        return "fbank_tc"
    return "fbank_fft" if n_fft & (n_fft - 1) == 0 else "fbank_fp32"


def _fbank_inputs(card, rows, n_fft, sr, n_mels):
    cfg = FeatureConfig(sample_rate=sr, n_fft=n_fft, win_length=n_fft, n_mels=n_mels)
    ops = _operands(astuple(cfg), str(card))
    g = torch.Generator().manual_seed(rows)
    frames = (torch.randn(rows, n_fft, generator=g) * 0.1).to(card)
    frames[min(1, rows - 1)] = 0.0  # a silent frame sits at the log floor
    return cfg, frames, ops


@pytest.mark.parametrize("rows,n_fft,sr,n_mels,precision,atol", FBANK_CASES)
def test_fbank_kernel_matches_plain(card, rows, n_fft, sr, n_mels, precision, atol):
    cfg, frames, ops = _fbank_inputs(card, rows, n_fft, sr, n_mels)
    counts = ("fbank", "fbank_fp32", "fbank_tc", "fbank_fft")
    before = {k: LAUNCHES[k] for k in counts}
    got = fbank_frames(frames, *ops, cfg.amin, precision)
    torch.cuda.synchronize()
    route = _fbank_route(n_fft, precision)
    assert {k: LAUNCHES[k] - before[k] for k in counts} == {
        k: int(k in ("fbank", route)) for k in counts}
    ref = fbank_frames_plain(frames, *ops, cfg.amin, precision)
    rtol = 1e-4 if precision == "highest" else 0.0
    torch.testing.assert_close(got, ref, rtol=rtol, atol=atol)
    silent = got[min(1, rows - 1)]
    torch.testing.assert_close(silent, torch.full_like(silent, -100.0))  # log floor


def test_fbank_bf16_route_repeats_bit_for_bit(card):
    """Two calls of the bf16 route at bench.py's 9,216 frames give the same
    bits: no atomics, every sum in a fixed order."""
    cfg, frames, ops = _fbank_inputs(card, 9216, 1024, 48000, 80)
    a = fbank_frames(frames, *ops, cfg.amin, "default")
    b = fbank_frames(frames, *ops, cfg.amin, "default")
    assert torch.equal(a, b)


def test_fbank_bf16_route_refuses_what_shared_memory_cannot_hold(card):
    """n_fft 4096: 32 frames of 4,104 bf16 samples alone are 262 KB, past a
    block's 227 KB. The wrapper raises before any launch; nothing else runs."""
    n_fft, n_freq, n_mels = 4096, 2049, 80
    frames = torch.randn(40, n_fft, device=card)
    window = torch.ones(n_fft, device=card)
    cos = sin = torch.zeros(n_fft, n_freq, device=card)
    mel = torch.zeros(n_freq, n_mels, device=card)
    before = (LAUNCHES["fbank"], LAUNCHES["fbank_tc"])
    with pytest.raises(ValueError, match="shared memory"):
        fbank_frames(frames, window, cos, sin, mel, 1e-10, "default")
    assert (LAUNCHES["fbank"], LAUNCHES["fbank_tc"]) == before


def test_fbank_fft_route_takes_a_dense_mel(card):
    """A random mel matrix with no zero entry on the FFT route: every
    filter's band is every bin."""
    cfg, frames, (window, cos, sin, _) = _fbank_inputs(card, 300, 512, 16000, 40)
    g = torch.Generator().manual_seed(3)
    mel = (0.01 + torch.rand(257, 40, generator=g)).to(card)
    before = LAUNCHES["fbank_fft"]
    got = fbank_frames(frames, window, cos, sin, mel, cfg.amin, "highest")
    torch.cuda.synchronize()
    assert LAUNCHES["fbank_fft"] == before + 1
    ref = fbank_frames_plain(frames, window, cos, sin, mel, cfg.amin, "highest")
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)


def test_fbank_fft_route_repeats_bit_for_bit(card):
    """Two calls of the FFT route at the serving requests' 4,112 frames give
    the same bits: no atomics, every sum in a fixed order."""
    cfg, frames, ops = _fbank_inputs(card, 4112, 1024, 48000, 80)
    a = fbank_frames(frames, *ops, cfg.amin, "highest")
    b = fbank_frames(frames, *ops, cfg.amin, "highest")
    assert torch.equal(a, b)


def test_fbank_fft_route_refuses_what_shared_memory_cannot_hold(card):
    """n_fft 32,768: a frame's 16,384 complex points and the twiddles are
    past a block's 227 KB. The plan raises before any launch."""
    n_fft, n_freq, n_mels = 32768, 16385, 80
    frames = torch.randn(3, n_fft, device=card)
    window = torch.ones(n_fft, device=card)
    cos = sin = torch.zeros(n_fft, n_freq, device=card)
    mel = torch.zeros(n_freq, n_mels, device=card)
    counts = ("fbank", "fbank_fp32", "fbank_tc", "fbank_fft")
    before = {k: LAUNCHES[k] for k in counts}
    with pytest.raises(ValueError, match="shared memory"):
        fbank_frames(frames, window, cos, sin, mel, 1e-10, "highest")
    assert {k: LAUNCHES[k] for k in counts} == before


# the last two: bench.py's training shape and the trainer's shorter bucket,
# with the encoder's padding and a dynamic chunk
ATTENTION_SHAPES = [
    (3, 21, 21, 2, 32, "chunk"), (2, 40, 70, 4, 64, "pad"), (1, 187, 187, 4, 64, "chunk"),
    (3, 21, 21, 2, 16, "chunk"), (12, 191, 191, 4, 64, "dynamic"),
    (12, 63, 63, 4, 64, "dynamic"),
]


def _attention_inputs(card, dtype, b, t, s, h, dk, mask_kind):
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
    elif mask_kind == "dynamic":  # padding (as a batch's lengths) and a chunk of t // 12
        lens = torch.linspace(s, s // 2, b).long()
        pad = torch.arange(s)[None, None, :] < lens[:, None, None]
        mask = pad & chunk_mask(t, t // 12, 3)[None]
        mask[0, t - 1] = False  # fully masked row -> zeros
    else:
        i = torch.arange(t)[:, None]
        j = torch.arange(s)[None, :]
        mask = ((j // 4 <= i // 4) & (j >= i - 8)).expand(b, t, s).clone()
        mask[0, t - 1] = False  # fully masked row -> zeros
    do = torch.randn(b, t, d, generator=g).to(card, dtype)
    return (q, k, p, v, ub, vb, mask.to(card), dk ** -0.5, h), do


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("b,t,s,h,dk,mask_kind", ATTENTION_SHAPES)
def test_relpos_attention_kernel_matches_plain(card, dtype, tol, b, t, s, h, dk, mask_kind):
    args, _ = _attention_inputs(card, dtype, b, t, s, h, dk, mask_kind)
    got = relpos_attention(*args)
    torch.cuda.synchronize()
    ref = relpos_attention_plain(*args)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), ref.float(), rtol=tol, atol=tol)
    if mask_kind != "pad":
        assert torch.all(got[0, t - 1] == 0)


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("b,t,s,h,dk,mask_kind", ATTENTION_SHAPES)
def test_relpos_attention_bwd_kernel_matches_plain(card, dtype, rel, b, t, s, h, dk, mask_kind):
    args, do = _attention_inputs(card, dtype, b, t, s, h, dk, mask_kind)
    q, k, p, v, ub, vb, mask, scale, n_head = args
    before = LAUNCHES["relpos_attention_bwd"]
    got = relpos_attention_bwd(q, k, p, v, ub, vb, mask, do, scale, n_head)
    torch.cuda.synchronize()
    assert LAUNCHES["relpos_attention_bwd"] == before + 1
    ref = relpos_attention_bwd_plain(q, k, p, v, ub, vb, mask, do, scale, n_head)
    for name, x, y in zip(("dq", "dk", "dv", "dp", "du", "dvb"), got, ref):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        err = float((x.float() - y.float()).abs().max())
        assert err <= rel * float(y.float().abs().max()) + 1e-6, (name, err)
    if mask_kind != "pad":
        assert torch.all(got[0][0, t - 1] == 0)  # fully masked row: no gradient


@pytest.mark.parametrize("b,t,s,h,dk,mask_kind", ATTENTION_SHAPES)
def test_relpos_attention_saved_statistics(card, b, t, s, h, dk, mask_kind):
    """What the bf16 forward saves for the backward: each row's log-sum-exp,
    torch.logsumexp of the plain version's masked scaled scores (-inf for a
    fully masked row), and the fp32 output a.v. Tolerance 1e-4 +
    1e-5*|ref|: fp32 sums in another order, bf16 p in two bf16 parts (16
    bits; an error of 1e-4 in L is 1e-4 relative in every probability the
    backward rebuilds, far below bf16's 2**-8)."""
    dtype = torch.bfloat16
    args, _ = _attention_inputs(card, dtype, b, t, s, h, dk, mask_kind)
    q, k, p, v, ub, vb, mask, scale, n_head = args
    before = LAUNCHES["relpos_attention"]
    out, out32, lse = _relpos_fwd(*args, saved=True)
    torch.cuda.synchronize()
    assert LAUNCHES["relpos_attention"] == before + 1
    assert out32.dtype == torch.float32 and torch.equal(out32.to(dtype), out)
    # without the saved output p rounds to bf16 once (serving): another
    # rounding point, within the forward's bf16 tolerance
    torch.testing.assert_close(_relpos_fwd(*args).float(), out.float(), rtol=1e-2, atol=1e-2)
    _, ref32, _ = relpos_attention_plain(*args, saved=True)
    assert bool(((out32 - ref32).abs() <= 1e-4 + 1e-5 * ref32.abs()).all())
    heads = lambda x: x.float().reshape(x.shape[0], x.shape[1], n_head, dk)
    scores = (torch.einsum("bthd,bshd->bhts", heads(q + ub), heads(k))
              + torch.einsum("bthd,pshd->bhts", heads(q + vb), heads(p))) * scale
    ref = torch.logsumexp(scores.masked_fill(~mask[:, None], -torch.inf), dim=-1)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    dead = torch.isinf(ref)
    assert torch.equal(torch.isinf(lse), dead) and bool((lse[dead] < 0).all())
    assert bool(((lse - ref).abs() <= 1e-4 + 1e-5 * ref.abs())[~dead].all())
    if mask_kind != "pad":
        assert bool(dead[0, :, t - 1].all())


@pytest.mark.parametrize("shape", [(12, 191, 191, 4, 64, "dynamic"), (3, 21, 21, 2, 16, "chunk")])
def test_relpos_attention_bf16_autograd_launches_each_kernel_once(card, shape):
    """bf16 autograd through `relpos_attention`: one launch of #2 (which
    saves out and the log-sum-exp) and one of #3, and the plain backward's
    gradients to q, k, p, v and both biases within 2**-6 of each leaf's
    max."""
    args, do = _attention_inputs(card, torch.bfloat16, *shape)
    leaves = [x.detach().clone().requires_grad_() for x in args[:6]]
    before = (LAUNCHES["relpos_attention"], LAUNCHES["relpos_attention_bwd"])
    relpos_attention(*leaves, *args[6:]).backward(do)
    torch.cuda.synchronize()
    assert (LAUNCHES["relpos_attention"], LAUNCHES["relpos_attention_bwd"]) == (before[0] + 1,
                                                                              before[1] + 1)
    dq, dk, dv, dp, du, dvb = relpos_attention_bwd_plain(*args[:7], do, *args[7:])
    for name, x, y in zip(("q", "k", "p", "v", "u", "v_bias"), leaves, (dq, dk, dp, dv, du, dvb)):
        assert x.grad.dtype == y.dtype, name
        err = float((x.grad.float() - y.float()).abs().max())
        assert err <= 2.0 ** -6 * float(y.float().abs().max()) + 1e-6, (name, err)


def test_relpos_attention_gradients_match_plain_backward(card):
    """Autograd through the wrapper runs kernel #3 and returns the plain
    backward's gradients to q, k, p, v and both biases."""
    args, do = _attention_inputs(card, torch.float32, 2, 40, 40, 4, 64, "chunk")
    leaves = [x.detach().clone().requires_grad_() for x in args[:6]]
    before = LAUNCHES["relpos_attention_bwd"]
    out = relpos_attention(*leaves, *args[6:])
    saved = out.grad_fn.saved_tensors  # fp32: the inputs only
    assert saved[7] is None and saved[8] is None
    out.backward(do)
    torch.cuda.synchronize()
    assert LAUNCHES["relpos_attention_bwd"] == before + 1
    with pytest.raises(ValueError, match="saves no statistics"):
        _relpos_fwd(*args, saved=True)
    dq, dk, dv, dp, du, dvb = relpos_attention_bwd_plain(*args[:7], do, *args[7:])
    for x, y in zip(leaves, (dq, dk, dp, dv, du, dvb)):
        assert float((x.grad - y).abs().max()) <= 1e-4 * float(y.abs().max()) + 1e-6


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
    (12, 191, 32, 256, 412),  # bench.py's training shape
    (2, 11, 128, 256, 412),   # U+1 129: past the old kernel's shared-memory limit (120)
    (4, 37, 5, 256, 412),     # t-chunks of 10: a ragged last one of 7
    (2, 7, 3, 72, 30),        # D 72 (padded to 96), V 30 (no 16-byte rows)
    (2, 70, 0, 256, 412),     # U+1 1: tiles of 31 frames (a tile's rows copied at once)
    (12, 63, 16, 256, 412),   # the trainer's shapes (data.batch_size 12, U+1 17)
    (12, 127, 16, 256, 412),
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


@pytest.mark.parametrize("b,t,u,d,v", [
    (12, 191, 32, 256, 412), (2, 7, 3, 72, 30), (2, 70, 0, 256, 412), (3, 37, 16, 256, 97),
    (2, 5, 4, 32, 7),  # V 7: most lanes of a row hold no column below V
])
def test_rnnt_fused_lp_takes_out_of_range_labels(card, b, t, u, d, v):
    """#4 against plain with label ids outside [0, V): logit 0, as the TPU
    kernel's one-hot gives (one id past V lands in the last W tile's
    padding)."""
    blank = 5
    enc, pred, w, bias, lab = _joint_inputs(card, b, t, u, d, v, blank, 7 * t + u)
    if u:
        lab[0, 0], lab[-1, -1] = v, -1
    got = rnnt_fused_lp(enc, pred, w, bias, lab, blank)
    ref = rnnt_fused_lp_plain(enc, pred, w, bias, lab, blank)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, rtol=0, atol=5e-4)


def test_rnnt_fused_lp_repeats_bit_for_bit(card):
    """Two calls of #4 at bench.py's training shape give the same bits: each
    block owns its rows and folds the vocabulary tiles in order, no atomics."""
    b, t, u, d, v, blank = 12, 191, 32, 256, 412, 5
    args = _joint_inputs(card, b, t, u, d, v, blank, 4)
    first, again = (rnnt_fused_lp(*args, blank) for _ in range(2))
    torch.cuda.synchronize()
    for name, x, y in zip(("blank_lp", "label_lp", "lse"), first, again):
        assert torch.equal(x, y), name


def test_rnnt_fused_refuses_a_join_dim_past_its_tiles(card):
    enc, pred, w, bias, lab = _joint_inputs(card, 2, 9, 3, 320, 412, 5, 0)
    with pytest.raises(ValueError, match="join dim 320"):
        rnnt_fused_lp(enc, pred, w, bias, lab, 5)
    lse = torch.zeros(2, 9, 4, device=card)
    with pytest.raises(ValueError, match="join dim 320"):
        rnnt_fused_grads(enc, pred, w, bias, lab, lse, lse, lse, 5)


def test_rnnt_fused_grads_repeat_bit_for_bit(card):
    """Two calls of #5 at bench.py's training shape give the same bits: its
    sums across blocks go through partial buffers summed in a fixed order,
    with no atomics."""
    b, t, u, d, v, blank = 12, 191, 32, 256, 412, 5
    enc, pred, w, bias, lab = _joint_inputs(card, b, t, u, d, v, blank, 3)
    lse = rnnt_fused_lp(enc, pred, w, bias, lab, blank)[2]
    g = torch.Generator().manual_seed(2)
    gb = (-torch.rand(b, t, u + 1, generator=g) / b).to(card)
    gl = F.pad(-torch.rand(b, t, u, generator=g) / b, (0, 1)).to(card)
    first, again = (rnnt_fused_grads(enc, pred, w, bias, lab, lse, gb, gl, blank)
                    for _ in range(2))
    torch.cuda.synchronize()
    for name, x, y in zip(("d_enc", "d_pred", "dW", "db"), first, again):
        assert torch.equal(x, y), name


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


# the CTC lattice (#6/#7) by each route, forced through the plan: the
# earlier shapes, and S 1, 31, 33, 63, 65 and 255 (U 0 to 127: the S that
# bound each K, K 1 to 8, of the warp route), S 257 (U 128: the block route by
# shape); a t_len = 0 row, a t_len = 1 row and an infeasible row where B
# allows, or a batch whose rows all end before T
CTC_SHAPES = [(1, 30, 6, 412), (4, 50, 12, 64), (3, 8, 0, 20)] + [
    (4, 40, u, 412) for u in (0, 15, 16, 31, 32, 127)]
CTC_CASES = ([(route, *shape, False) for route in ("warp", "block") for shape in CTC_SHAPES]
             + [(route, 3, 30, 16, 412, True) for route in ("warp", "block")]
             + [("block", 4, 40, 128, 412, False)])


@pytest.mark.parametrize("route,b,t,u,v,all_short", CTC_CASES)
def test_ctc_kernels_match_plain(card, monkeypatch, route, b, t, u, v, all_short):
    from tpuasr_torch.ops import ctc as ctc_mod

    real = ctc_mod._ctc_plan
    monkeypatch.setattr(ctc_mod, "_ctc_plan", lambda s: real(s, route=route))
    blank = 5
    g = torch.Generator().manual_seed(b * t + u)
    lp = torch.log_softmax(torch.randn(b, t, v, generator=g), -1).to(card)
    lab = torch.randint(0, v, (b, u), generator=g).to(card)
    u_lens = torch.full((b,), u, dtype=torch.int32, device=card)
    t_lens = torch.full((b,), t, dtype=torch.int32, device=card)
    if all_short:
        t_lens = torch.tensor([t - 10, t // 3, t - 1], dtype=torch.int32, device=card)
    if b > 1 and not all_short:
        t_lens[1] = 0  # no frames
    if b > 2 and u >= 3 and not all_short:
        lab[2, :3] = 7  # 7 7 7 needs 5 frames: infeasible in 3
        u_lens[2], t_lens[2] = 3, 3
    if b > 3:
        t_lens[3] = 1  # one frame
    lp_states, skip, final = lattice_inputs(lp, lab, u_lens, blank)
    lp_states = lp_states.contiguous()
    before = dict(LAUNCHES)
    ga, gll = ctc_alpha(lp_states, skip, t_lens, final)
    ga2, gll2 = ctc_alpha(lp_states, skip, t_lens, final)
    ra, rll = ctc_alpha_plain(lp_states, skip, t_lens, final)
    live = ra > -1e29
    assert torch.equal(live, ga > -1e29)
    assert bool(((ga - ra).abs() <= 1e-3 + 1e-5 * ra.abs())[live].all())
    assert bool(((gll - rll).abs() <= 1e-3 + 1e-5 * rll.abs()).all())
    gvec = torch.rand(b, generator=g).to(card)
    args = (lp_states, skip, t_lens, final, ra.contiguous(), rll.contiguous(), gvec)
    got, again, ref = ctc_beta_grad(*args), ctc_beta_grad(*args), ctc_beta_grad_plain(*args)
    torch.cuda.synchronize()
    assert bool(((got - ref).abs() <= 2e-3 * ref.abs() + 1e-5).all())
    if b > 1 and not all_short:
        assert bool((got[1] == 0).all())
    for row in range(b):  # no gradient from a row's t_len on
        assert bool((got[row, max(int(t_lens[row]), 0):] == 0).all())
    # no atomics: two calls give the same bits
    assert torch.equal(ga, ga2) and torch.equal(gll, gll2) and torch.equal(got, again)
    other = "block" if route == "warp" else "warp"
    for name in ("ctc_alpha", "ctc_beta_grad"):
        assert LAUNCHES[f"{name}_{route}"] - before[f"{name}_{route}"] == 2
        assert LAUNCHES[f"{name}_{other}"] == before[f"{name}_{other}"]


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


def _lattice_inputs(card, b, t, u1, seed):
    """Masked blank/label log-probs as the losses hand them over: a t_len = 0
    row (free blanks, no labels) and a u_len = 0 row."""
    g = torch.Generator().manual_seed(seed)
    lp = torch.log_softmax(torch.randn(b, t, u1, 7, generator=g), -1)
    t_lens = torch.full((b,), t, dtype=torch.int32)
    u_lens = torch.full((b,), u1 - 1, dtype=torch.int32)
    t_lens[1 % b] = 0
    u_lens[2 % b] = 0
    bm, lm, _, _ = mask_lattice_inputs(lp[..., 0], lp[:, :, :-1, 1], t_lens, u_lens)
    return bm.to(card), lm.contiguous().to(card), u_lens.to(card)


# the RNN-T lattice (#8/#9) by the route its plan takes: the warp route at
# U+1 1 (K 1), 33 (K 2, the bench's), 65 (K 3) and 256 (K 8, ring chunks of
# 4), the block route at 257; the warp route forced at 17 and the block route
# forced at 33 and 256, each with a t_len = 0 row and a u_len = 0 row
RNNT_CASES = [(None, 3, 9, 1), (None, 4, 30, 33), (None, 3, 21, 65), (None, 3, 12, 256),
              (None, 3, 20, 257), ("warp", 4, 25, 17), ("block", 4, 30, 33),
              ("block", 3, 12, 256)]


@pytest.mark.parametrize("route,b,t,u1", RNNT_CASES)
def test_rnnt_lattice_kernels_match_plain(card, monkeypatch, route, b, t, u1):
    # (`tpuasr_torch.ops.rnnt_lattice` the attribute is the autograd wrapper)
    rnnt_mod = importlib.import_module("tpuasr_torch.ops.rnnt_lattice")
    real = rnnt_mod._rnnt_plan
    monkeypatch.setattr(rnnt_mod, "_rnnt_plan", lambda u, entry: real(u, entry, route=route))
    taken = {name: real(u1, name.removeprefix("rnnt_"), route=route)["route"]
             for name in ("rnnt_alpha", "rnnt_beta_grad")}
    assert set(taken.values()) == {route or ("warp" if u1 <= 256 else "block")}
    blank, label, u_lens = _lattice_inputs(card, b, t, u1, seed=t * u1)
    before = dict(LAUNCHES)
    ga, gll = rnnt_alpha(blank, label, u_lens)
    ga2, gll2 = rnnt_alpha(blank, label, u_lens)
    ra, rll = rnnt_alpha_plain(blank, label, u_lens)
    live = ra > -1e29
    assert torch.equal(live, ga > -1e29)
    assert bool(((ga - ra).abs() <= 1e-3 + 1e-5 * ra.abs())[live].all())
    assert bool(((gll - rll).abs() <= 1e-3 + 1e-5 * rll.abs()).all())
    gvec = torch.rand(b, generator=torch.Generator().manual_seed(1)).to(card)
    args = (blank, label, u_lens, ra.contiguous(), rll.contiguous(), gvec)
    got, again = rnnt_beta_grad(*args), rnnt_beta_grad(*args)
    ref = rnnt_beta_grad_plain(*args)
    torch.cuda.synchronize()
    for x, y in zip(got, ref):
        assert x.shape == y.shape
        assert bool(((x - y).abs() <= 2e-3 * y.abs() + 1e-5).all())
    # no atomics: two calls give the same bits
    assert torch.equal(ga, ga2) and torch.equal(gll, gll2)
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    for name, r in taken.items():
        other = "block" if r == "warp" else "warp"
        assert LAUNCHES[name] - before[name] == 2
        assert LAUNCHES[f"{name}_{r}"] - before[f"{name}_{r}"] == 2
        assert LAUNCHES[f"{name}_{other}"] == before[f"{name}_{other}"]


def test_rnnt_lattice_wrappers_refuse(card):
    blank, label, u_lens = _lattice_inputs(card, 2, 5, 3, seed=0)
    with pytest.raises(ValueError, match="int32"):
        rnnt_alpha(blank, label, u_lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        rnnt_alpha(blank.transpose(1, 2).contiguous().transpose(1, 2), label, u_lens)
    wide = torch.zeros(2, 5, 1025, device=card)
    with pytest.raises(ValueError, match="1024"):
        rnnt_alpha(wide, wide[:, :, 1:].contiguous(), u_lens)


def test_materialized_rnnt_loss_card_matches_cpu(card):
    b, t, u, v, blank = 4, 30, 9, 412, 5
    g = torch.Generator().manual_seed(5)
    logits = torch.randn(b, t, u + 1, v, generator=g)
    lab = torch.randint(6, v, (b, u), generator=g)
    t_lens = torch.tensor([t, 0, 17, 25], dtype=torch.int32)
    u_lens = torch.tensor([u, 3, 0, 6], dtype=torch.int32)  # row 1: infeasible
    outs = {}
    for dev in (card, torch.device("cpu")):
        z = logits.to(dev).requires_grad_()
        before = LAUNCHES["rnnt_alpha"]
        loss = rnnt_loss_from_logits(z, lab.to(dev), t_lens.to(dev), u_lens.to(dev), blank,
                                     "none")
        loss.sum().backward()
        assert (LAUNCHES["rnnt_alpha"] > before) == (dev.type == "cuda")
        outs[dev.type] = (loss.detach().cpu(), z.grad.cpu())
    torch.testing.assert_close(outs["cuda"][0], outs["cpu"][0], rtol=1e-5, atol=1e-3)
    torch.testing.assert_close(outs["cuda"][1], outs["cpu"][1], rtol=0, atol=1e-4)
    assert float(outs["cuda"][0][1]) == 0.0 and bool((outs["cuda"][1][1] == 0).all())


def _ffn_inputs(card, r, d, h, dtype, masks, seed):
    g = torch.Generator().manual_seed(seed)
    rn = lambda *s: torch.randn(*s, generator=g)
    args = [rn(r, d).to(card, dtype), (1.0 + 0.1 * rn(d)).to(card), (0.1 * rn(d)).to(card),
            (rn(h, d) / d ** 0.5).to(card, dtype), (0.1 * rn(h)).to(card),
            (rn(d, h) / h ** 0.5).to(card, dtype), (0.1 * rn(d)).to(card), None, None]
    if masks:
        args[7] = (torch.rand(r, h, generator=g) >= 0.1).to(torch.uint8).to(card)
        args[8] = (torch.rand(r, d, generator=g) >= 0.1).to(torch.uint8).to(card)
    return args, rn(r, d).to(card, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masks", [False, True])
@pytest.mark.parametrize("r,d,h", [(1, 64, 128), (70, 64, 128), (70, 256, 1024),
                                   (2292, 256, 1024), (128, 256, 1024), (748, 256, 1024),
                                   (756, 256, 1024), (1524, 256, 1024), (70, 64, 160),
                                   (130, 256, 160)])
def test_ffn_kernels_match_plain(card, r, d, h, masks, dtype):
    args, do = _ffn_inputs(card, r, d, h, dtype, masks, r + d)
    before = (LAUNCHES["ffn_fwd"], LAUNCHES["ffn_bwd"])
    got = ffn_fwd(*args, 0.1, 0.5)
    torch.cuda.synchronize()
    ref = ffn_fwd_plain(*args, 0.1, 0.5)
    fp32 = dtype == torch.float32
    assert got.dtype == dtype
    out_tol, grad_tol = (1e-5, 1e-4) if fp32 else (2.0 ** -7, 2.0 ** -6)
    top = float(ref.float().abs().max())
    assert float((got.float() - ref.float()).abs().max()) <= out_tol * top
    got_b = ffn_bwd(*args, do, 0.1, 0.5)
    torch.cuda.synchronize()
    assert (LAUNCHES["ffn_fwd"], LAUNCHES["ffn_bwd"]) == (before[0] + 1, before[1] + 1)
    ref_b = ffn_bwd_plain(*args, do, 0.1, 0.5)
    for name, x, y in zip(("dx", "dg", "db", "dw1", "db1", "dw2", "db2"), got_b, ref_b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        err = float((x.float() - y.float()).abs().max())
        assert err <= grad_tol * float(y.float().abs().max()) + 1e-7, (name, err)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ffn_kernels_repeat_bit_for_bit(card, dtype):
    """Two calls of #10 and of #11 on the same inputs give the same bits: at
    the training shape (2,292 rows, masks at 0.1) every sum across blocks is
    taken in a fixed order, with no atomics."""
    args, do = _ffn_inputs(card, 2292, 256, 1024, dtype, True, 11)
    outs = [(ffn_fwd(*args, 0.1, 0.5), *ffn_bwd(*args, do, 0.1, 0.5)) for _ in range(2)]
    torch.cuda.synchronize()
    names = ("out", "dx", "dg", "db", "dw1", "db1", "dw2", "db2")
    for name, a, b in zip(names, *outs):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("masks", [False, True])
def test_fused_ffn_gradients_match_plain_autograd(card, masks):
    """Autograd through `fused_ffn` runs #10/#11 and returns plain
    autograd's gradients of `ffn_fwd_plain` (fp32)."""
    args, do = _ffn_inputs(card, 300, 256, 1024, torch.float32, masks, 9)
    leaves = [x.detach().clone().requires_grad_() for x in args[:7]]
    before = LAUNCHES["ffn_bwd"]
    fused_ffn(*leaves, *args[7:], 0.1, 0.5).backward(do)
    torch.cuda.synchronize()
    assert LAUNCHES["ffn_bwd"] == before + 1
    plain = [x.detach().clone().requires_grad_() for x in args[:7]]
    ffn_fwd_plain(*plain, *args[7:], 0.1, 0.5).backward(do)
    for a, b in zip(leaves, plain):
        assert float((a.grad - b.grad).abs().max()) <= 1e-4 * float(b.grad.abs().max())


def test_fused_ffn_route_equals_module_route_on_card(card):
    import dataclasses

    from tpuasr_torch.config import ModelConfig
    from tpuasr_torch.models import Transducer, init_weights

    res = {}
    for fused in (True, False):
        mc = ModelConfig(vocab_size=64)
        mc.encoder = dataclasses.replace(mc.encoder, num_blocks=2, causal=True,
                                         static_chunk_size=8, fused_ffn=fused)
        model = init_weights(Transducer(mc, device=card), seed=3)
        model.train()
        g = torch.Generator().manual_seed(1)
        feats = torch.randn(2, 97, 80, generator=g).to(card)
        texts = torch.randint(6, 64, (2, 6), generator=g).to(card)
        before = LAUNCHES["ffn_bwd"]
        out = model(feats, torch.tensor([97, 70], device=card), texts,
                    torch.tensor([6, 4], device=card),
                    dropout_gen=torch.Generator(device=card).manual_seed(5))
        out["loss"].backward()
        torch.cuda.synchronize()
        assert (LAUNCHES["ffn_bwd"] - before) == (4 if fused else 0)
        res[fused] = (float(out["loss"].detach()),
                      {n: p.grad.clone() for n, p in model.named_parameters()})
    (loss_f, gf), (loss_m, gm) = res[True], res[False]
    assert abs(loss_f - loss_m) <= 1e-5 * abs(loss_m)
    top = max(float(x.abs().max()) for x in gm.values())
    for name, x in gm.items():
        assert float((gf[name] - x).abs().max()) <= 1e-4 * top, name


def test_ffn_wrappers_reject_what_the_kernels_do_not_take(card):
    args, do = _ffn_inputs(card, 8, 64, 128, torch.float32, True, 0)
    for d in (96, 128):
        odd, _ = _ffn_inputs(card, 8, d, 128, torch.float32, False, 0)
        with pytest.raises(ValueError, match="must be 64 or 256"):
            ffn_fwd(*odd, 0.1, 0.5)
    narrow, _ = _ffn_inputs(card, 8, 64, 100, torch.float32, False, 0)
    with pytest.raises(ValueError, match="multiple of 32"):
        ffn_fwd(*narrow, 0.1, 0.5)
    with pytest.raises(ValueError, match="both keep-masks"):
        ffn_fwd(*args[:8], None, 0.1, 0.5)
    with pytest.raises(ValueError, match="dtype"):
        ffn_fwd(args[0].half(), *args[1:], 0.1, 0.5)
    with pytest.raises(ValueError, match="w1"):
        ffn_bwd(args[0], args[1], args[2], args[3].bfloat16(), *args[4:], do, 0.1, 0.5)


# --------------------------------------------------------------- decoders
# plain PyTorch on the card, held against the same search on the CPU


@pytest.mark.parametrize("shape,k", [((16, 4, 412), 4), ((16, 20), 4), ((64, 110), 10),
                                     ((3, 5000), 8)])
def test_top_k_puts_the_lower_index_first_among_ties_on_card(card, shape, k):
    """The beam searches' top-k on the card: descending, and among equal
    values (a few distinct values, runs of -1e30, a row of -1e30) the lower
    index first, as jax.lax.top_k orders them."""
    from tpuasr_torch.decode import top_k

    g = torch.Generator().manual_seed(sum(shape))
    levels = torch.tensor([-1.5, -0.25, -3.0, -1e30])
    x = levels[torch.randint(0, 4, shape, generator=g)]
    x.view(-1, shape[-1])[0] = -1e30
    vals, idx = top_k(x.to(card), k)
    rows = x.view(-1, shape[-1]).tolist()
    ref = [sorted(range(len(r)), key=lambda i: (-r[i], i))[:k] for r in rows]
    assert idx.view(-1, k).cpu().tolist() == ref
    assert torch.equal(vals.cpu(), torch.gather(x, -1, idx.cpu()))


def _tiny_transducer(device):
    """A tiny flagship (2 causal blocks, d32, vocab 64, blank 5) with seeded
    weights and a blank logit that makes hypotheses both emit and take blanks."""
    from tpuasr_torch.config import Config
    from tpuasr_torch.models import Transducer, init_weights

    m = Config().model
    m.vocab_size, m.blank_id = 64, 5
    e = m.encoder
    e.output_size, e.attention_heads, e.linear_units, e.num_blocks = 32, 2, 64, 2
    e.cnn_module_kernel, e.dropout_rate, e.positional_dropout_rate = 7, 0.0, 0.0
    e.causal, e.use_dynamic_chunk, e.static_chunk_size = True, True, 4
    m.predictor.embed_size, m.predictor.hidden_size, m.predictor.output_size = 16, 16, 32
    model = init_weights(Transducer(m, device=device), 0)
    with torch.no_grad():
        model.joint.ffn_out_bias[5] = 1.5
    return model


@pytest.mark.parametrize("n_steps,ctc_weight", [(1, 0.0), (3, 0.3)])
def test_beam_searches_on_card_match_cpu(card, n_steps, ctc_weight):
    """rnnt_beam_decode and ctc_prefix_beam_search (with a context graph)
    on the card against the CPU on the same encoder output: every n-best
    slot's tokens and lengths identical, scores within 1e-4 (fp32 sums in
    another order)."""
    from tpuasr_torch.decode import (
        build_context_graph, ctc_prefix_beam_search, rnnt_beam_decode,
    )

    cpu_m, card_m = _tiny_transducer("cpu"), _tiny_transducer(card)
    g = torch.Generator().manual_seed(3)
    feats = torch.randn(3, 131, 80, generator=g) * 0.5
    enc, enc_lens = cpu_m.encode(feats, torch.tensor([131, 99, 60]))
    outs = {}
    for side, model in (("cpu", cpu_m), ("card", card_m)):
        e, el = enc.to(model.device), enc_lens.to(model.device)
        beam = rnnt_beam_decode(model, e, el, 5, 4, 40, n_steps=n_steps, ctc_weight=ctc_weight)
        lp = torch.log_softmax(cpu_m.ctc_logits(enc), -1).to(model.device)
        graph = build_context_graph([[7, 9], [12, 3, 7]], 64, 1.5)
        prefix = ctc_prefix_beam_search(lp, el, 5, 4, 40, context_graph=graph)[2]
        outs[side] = (beam[2:], prefix)
    for got, ref in zip(outs["card"], outs["cpu"]):
        assert torch.equal(got[0].cpu(), ref[0]) and torch.equal(got[1].cpu(), ref[1])
        assert float((got[2].cpu() - ref[2]).abs().max()) <= 1e-4
    assert int(outs["cpu"][0][1].max()) > 0


@pytest.mark.parametrize("subsampling", ["conv2d8", "conv2d6"])
def test_ctc_model_card_matches_cpu(card, subsampling):
    """A tiny CTCModel (d32, 2 heads, 2 blocks, vocab 40; a row shorter
    after subsampling than its labels) on the card against the CPU, same
    weights and features: out_lens exact, log-probs atol 1e-4, loss rtol
    1e-5, every gradient within 1e-3 of its leaf's max (fp32 sums in another
    order, cuDNN's convs), and the loss through kernels #6/#7."""
    from tpuasr_torch.config import CTCModelConfig
    from tpuasr_torch.models import CTCModel, init_weights

    c = CTCModelConfig(hidden_dim=32, attention_heads=2, num_blocks=2, kernel_size=7,
                       subsampling=subsampling)
    g = torch.Generator().manual_seed(4)
    feats = torch.randn(3, 101, 80, generator=g)
    batch = (feats, torch.tensor([101, 40, 77]), torch.randint(6, 40, (3, 6), generator=g),
             torch.tensor([6, 6, 3]))
    res = {}
    for side, dev in (("card", card), ("cpu", torch.device("cpu"))):
        model = init_weights(CTCModel(c, 40, 5, dev), 0)
        before = (LAUNCHES["ctc_alpha"], LAUNCHES["ctc_beta_grad"])
        lp, lens, loss = model(*(x.to(dev) for x in batch))
        loss.backward()
        if side == "card":
            torch.cuda.synchronize()
            assert (LAUNCHES["ctc_alpha"] - before[0], LAUNCHES["ctc_beta_grad"] - before[1]) \
                == (1, 1)
        res[side] = (lp.detach().cpu(), lens.cpu(), float(loss.detach()),
                     {n: p.grad.cpu() for n, p in model.named_parameters()})
    (lp_c, n_c, l_c, g_c), (lp_h, n_h, l_h, g_h) = res["card"], res["cpu"]
    assert torch.equal(n_c, n_h) and int(n_h[1]) < 6
    valid = torch.arange(lp_h.shape[1])[None, :] < n_h[:, None]
    assert float((lp_c - lp_h).abs()[valid].max()) <= 1e-4
    assert abs(l_c - l_h) <= 1e-5 * abs(l_h)
    for name, x in g_h.items():
        if name.endswith("linear_k.bias"):  # no gradient in exact arithmetic
            continue
        assert float((g_c[name] - x).abs().max()) <= 1e-3 * float(x.abs().max()), name


@pytest.mark.parametrize("ties", [False, True])
def test_forced_align_and_greedy_on_card_match_cpu(card, ties):
    """`ctc_forced_align` and `ctc_greedy_decode` on the card against the
    CPU on the same log-probs (with integer logits, many tied candidates):
    alignments and tokens identical, scores within 1e-6 relative."""
    from tpuasr_torch.decode import ctc_forced_align, ctc_greedy_decode

    g = torch.Generator().manual_seed(2)
    logits = torch.randn(4, 60, 12, generator=g) * 2
    if ties:
        logits = logits.round()
    lp = torch.log_softmax(logits, -1)
    labels = torch.randint(1, 12, (4, 9), generator=g)
    il, ll = torch.tensor([60, 41, 5, 33]), torch.tensor([9, 7, 9, 0])
    out = {}
    for side, dev in (("card", card), ("cpu", torch.device("cpu"))):
        a, s = ctc_forced_align(lp.to(dev), labels.to(dev), il.to(dev), ll.to(dev), 0)
        t, n = ctc_greedy_decode(lp.to(dev), il.to(dev), 0)
        out[side] = (a.cpu(), s.cpu(), t.cpu(), n.cpu())
    (ac, sc, tc, nc), (ah, sh, th, nh) = out["card"], out["cpu"]
    assert torch.equal(ac, ah) and torch.equal(tc, th) and torch.equal(nc, nh)
    assert float(((sc - sh).abs() / sh.abs()).max()) <= 1e-6


def test_gradient_checkpointing_on_card(card):
    """A tiny transducer with the attention and FFN kernels (#2/#3,
    #10/#11), dropout 0.1 and dynamic chunks: gradient checkpointing on the
    card gives the flag-off loss and gradients (1e-4 of the largest: the
    attention backward's atomics) from the same generators, and launches
    #2 and #10 twice as often (the recompute)."""
    import dataclasses

    from tpuasr_torch.config import ModelConfig
    from tpuasr_torch.models import Transducer, init_weights
    from tpuasr_torch.train.step import step_generators

    res = {}
    for remat in (False, True):
        mc = ModelConfig(vocab_size=64)
        mc.encoder = dataclasses.replace(
            mc.encoder, num_blocks=2, causal=True, use_dynamic_chunk=True, static_chunk_size=8,
            fused_attention=True, fused_ffn=True, gradient_checkpointing=remat)
        model = init_weights(Transducer(mc, device=card), seed=3)
        model.train()
        g = torch.Generator().manual_seed(1)
        feats = torch.randn(2, 97, 80, generator=g).to(card)
        texts = torch.randint(6, 64, (2, 6), generator=g).to(card)
        chunk_gen, drop_gen = step_generators(7, 0, card)
        before = {k: LAUNCHES[k] for k in ("relpos_attention", "ffn_fwd")}
        out = model(feats, torch.tensor([97, 70], device=card), texts,
                    torch.tensor([6, 4], device=card), chunk_gen=chunk_gen,
                    dropout_gen=drop_gen)
        out["loss"].backward()
        torch.cuda.synchronize()
        res[remat] = (float(out["loss"].detach()),
                      {n: p.grad.clone() for n, p in model.named_parameters()},
                      {k: LAUNCHES[k] - v for k, v in before.items()})
    (l0, g0, n0), (l1, g1, n1) = res[False], res[True]
    assert n1 == {k: 2 * v for k, v in n0.items()} and n0["ffn_fwd"] == 4
    assert abs(l0 - l1) <= 1e-6 * abs(l0)
    top = max(float(x.abs().max()) for x in g0.values())
    for name, x in g0.items():
        assert float((g1[name] - x).abs().max()) <= 1e-4 * top, name


def test_paraformer_cif_and_greedy_on_card(card):
    """The CIF fire by its weight matrix and one batched product (no
    atomics): two identical calls on the card give the same bits, within 8
    ulps of the largest cumsum times the largest |hidden| of the CPU's (the
    card's cumsum adds in another order, and a frame's shares move with it);
    a tiny Paraformer of each stack (the CIF bias at -1,
    so counts stay under max_tokens) decodes greedily on the card to the
    CPU's counts, tokens and fire frames (fp32; rows whose CIF sums lie
    within rounding of an integer would be exempt, and none does here)."""
    from tpuasr_torch.config import EncoderConfig
    from tpuasr_torch.models import Paraformer, ParaformerConfig, init_weights
    from tpuasr_torch.nn.cif import cif_fire

    g = torch.Generator().manual_seed(3)
    hidden = torch.randn(4, 190, 256, generator=g)
    alpha = torch.rand(4, 190, generator=g) * 0.5
    alpha[1, 120:] = 0.0
    on_card = [cif_fire(hidden.to(card), alpha.to(card), 64) for _ in range(2)]
    assert torch.equal(*on_card)
    c_max = float(alpha.sum(1).max())
    tol = 8 * torch.finfo(torch.float32).eps * c_max * float(hidden.abs().max())
    assert float((on_card[0].cpu() - cif_fire(hidden, alpha, 64)).abs().max()) <= tol
    enc = EncoderConfig(output_size=64, attention_heads=2, linear_units=128, num_blocks=2,
                        cnn_module_kernel=7, fused_attention=True)
    feats = torch.randn(3, 301, 80, generator=g)
    lens = torch.tensor([301, 250, 120])
    for stack in ("conformer", "sanm"):
        cfg = ParaformerConfig(vocab_size=64, encoder=enc, decoder_blocks=2, decoder_heads=2,
                               decoder_ffn=128, max_tokens=24, encoder_type=stack)
        got = {}
        for dev in (card, torch.device("cpu")):
            model = init_weights(Paraformer(cfg, device=dev), 5)
            with torch.no_grad():
                model.predictor.cif_output.bias.fill_(-1.0)
            got[dev.type] = [x.cpu() for x in model.greedy_decode_with_times(
                feats.to(dev), lens.to(dev))]
        assert all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"])), stack
        assert 0 < int(got["cpu"][1].min()) and int(got["cpu"][1].max()) < 24


def test_whisper_greedy_on_card_matches_cpu(card):
    """A tiny Whisper (2 + 2 blocks at d64, the attention and FFN kernels
    on) decodes greedily on the card to the CPU's tokens and lengths, for
    a batch of mixed tasks and languages (the eot logit raised so that
    hypotheses end at different lengths)."""
    from tpuasr_torch.config import EncoderConfig
    from tpuasr_torch.models import (
        WhisperConfig, WhisperModel, init_weights, whisper_greedy_decode,
    )

    enc = EncoderConfig(output_size=64, attention_heads=2, linear_units=128, num_blocks=2,
                        cnn_module_kernel=7, fused_attention=True, fused_ffn=True)
    cfg = WhisperConfig(vocab_size=64, decoder_blocks=2, decoder_heads=2, decoder_ffn=128,
                        encoder=enc)
    g = torch.Generator().manual_seed(4)
    feats = torch.randn(4, 201, 80, generator=g)
    lens = torch.tensor([201, 180, 150, 97])
    langs, tasks = torch.tensor([0, 1, 0, 1]), torch.tensor([0, 1, 2, 0])
    got = {}
    for dev in (card, torch.device("cpu")):
        model = init_weights(WhisperModel(cfg, device=dev), 6)
        with torch.no_grad():
            model.decoder.output_layer.bias[cfg.special.eot] = 2.0
        enc_out, enc_lens = model.encode(feats.to(dev), lens.to(dev))
        got[dev.type] = [x.cpu() for x in whisper_greedy_decode(
            model, enc_out, enc_lens, langs, tasks, max_tokens=16)]
    assert all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"]))
    n = got["cpu"][1]
    assert int(n.max()) > 0 and int(n.min()) < 16  # emits, and stops early


def test_export_artifacts_on_card_launch_kernel_10(card, tmp_path):
    """The serving export traced on the card (a tiny causal transducer at
    d64 with `fused_ffn`): the loaded encoder_chunk gives the eager
    `encode_chunk`'s outputs chunk after chunk (1e-6: the same kernels), and
    the loaded process_chunk the eager `streaming_greedy_decode`'s tokens,
    with #10 launched by the artifact, 2 FFNs x 2 blocks a chunk."""
    from tpuasr_torch.config import Config
    from tpuasr_torch.decode import streaming_greedy_decode
    from tpuasr_torch.decode.rnnt_streaming import init_streaming_state
    from tpuasr_torch.export import export_streaming, load_exported
    from tpuasr_torch.models import Transducer, init_weights, stream_output_len
    from tpuasr_torch.streaming import chunk_windows, num_chunks

    cfg = Config()
    m, e = cfg.model, cfg.model.encoder
    m.vocab_size, m.blank_id = 64, 5
    e.output_size, e.attention_heads, e.linear_units, e.num_blocks = 64, 2, 128, 2
    e.cnn_module_kernel, e.causal, e.use_dynamic_chunk, e.static_chunk_size = 7, True, True, 4
    e.fused_ffn = True
    m.predictor.embed_size, m.predictor.hidden_size, m.predictor.output_size = 16, 16, 64
    cfg.streaming.chunk_size, cfg.streaming.num_left_chunks, cfg.streaming.n_steps = 4, 2, 3
    model = init_weights(Transducer(m, device=card), 0)
    with torch.no_grad():
        model.joint.ffn_out_bias[5] = 1.5
    manifest = export_streaming(model, cfg, str(tmp_path), batch=2, max_tokens=30)
    assert all(v["platforms"] == ["cuda"] for v in manifest["functions"].values())
    fns = load_exported(str(tmp_path))
    g = torch.Generator().manual_seed(7)
    feats = torch.randn(2, 150, 80, generator=g).to(card)
    lens = torch.tensor([150, 117], device=card)
    n = num_chunks(150, 4, 4, 6)
    windows = chunk_windows(feats, 4, 4, 6, n)
    st_a, st_e = model.init_encoder_state(2, 4, 2), model.init_encoder_state(2, 4, 2)
    for w in windows:
        got, st_a = fns["encoder_chunk"](w, st_a)
        want, st_e = model.encode_chunk(w, st_e)
        assert float((got - want).abs().max()) <= 1e-6
    state = init_streaming_state(model, 2, 4, 2, 5, 30, stream_output_len(e, lens))
    before = LAUNCHES["ffn_fwd"]
    for w in windows:
        state = fns["process_chunk"](w, state)
    torch.cuda.synchronize()
    assert LAUNCHES["ffn_fwd"] - before == 4 * n
    ref_t, ref_l, _ = streaming_greedy_decode(model, feats, lens, 4, 2, 5, 3, 30)
    assert torch.equal(state.dec.hyp[:, :30], ref_t) and torch.equal(state.dec.hyp_len, ref_l)
    assert int(ref_l.min()) > 0
