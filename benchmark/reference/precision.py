"""The arithmetic of the plain reference: float32 products, or the same
products with their operands rounded to a lower precision (the control of
"How correct is decided": TF32 for a float32 configuration, FP8 E4M3 for a
bfloat16 one).

Every product of the reference goes through one `Precision`. Rounding is
explicit (operands rounded, then an fp32 product with TF32 off), so the
control computes the same numbers on the CPU and on the card. The rounding
is a straight-through estimator: the backward sees the identity, so a
training control differs in its forward's precision and not by a gradient
cut to zero. The reference computes under `exact()`, which turns TF32 off
for its own products and convolutions and gives the flags back after, so
the program runs with the backend flags it sets itself.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

MODES = ("fp32", "tf32", "fp8")
FP8_MAX = 448.0  # the largest finite float8_e4m3fn


@contextlib.contextmanager
def exact():
    """TF32 off for cuBLAS and cuDNN while the reference computes; the
    flags as they were after."""
    mm, dnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, dnn


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value (10 mantissa bits, ties to even), as fp32."""
    i = x.float().contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = (i + 0xFFF + lsb) & ~0x1FFF
    return r.view(torch.float32)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> float8_e4m3fn with one scale for the tensor (its absolute max
    mapped to 448, as FP8 training scales a tensor), back to fp32."""
    x = x.float()
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, FP8_MAX / amax, torch.ones_like(amax))
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """`mode`: fp32 (the reference), tf32 or fp8 (the controls)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in MODES:
            raise ValueError(f"precision {mode!r} not in {MODES}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32":
            return x
        r = round_tf32(x) if self.mode == "tf32" else round_fp8(x)
        return x + (r - x).detach()

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))

    def einsum(self, eq: str, *ops):
        return torch.einsum(eq, *(self.q(o) for o in ops))

    def linear(self, x, w, b=None):
        """x [..., in] . w [out, in]^T + b."""
        return F.linear(self.q(x), self.q(w), b)

    def conv2d(self, x, w, b, stride):
        return F.conv2d(self.q(x), self.q(w), b, stride=stride)

    def conv1d(self, x, w, b, groups):
        return F.conv1d(self.q(x), self.q(w), b, groups=groups)
