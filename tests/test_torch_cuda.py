"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: each test skips without an NVIDIA card. Edge shapes the
flagship path does not reach: rows not a multiple of the fbank tile, T and
S not multiples of the attention tiles, T != S, dk 16, 32 and 64, a broadcast
[B, 1, S] padding mask, a fully masked query row. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

TF32 is off for every fp32 comparison. Tolerances: fp32 sums in another
order (fbank: rtol 1e-4, atol 1e-3 dB; attention: 1e-5); bf16-operand
fbank: one bf16 ulp of a power bin (0.034 dB); bf16 attention: 1e-2 +
1e-2*|ref|, the output and probability roundings to bf16 (2**-8 relative
each) happen at different points in the kernel and the plain version.
"""

from dataclasses import astuple

import pytest
import torch

from tpuasr_torch.audio.fbank import _operands
from tpuasr_torch.config import FeatureConfig
from tpuasr_torch.ops import (
    LAUNCHES, fbank_frames, fbank_frames_plain, relpos_attention, relpos_attention_plain,
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
