"""FLOP counts and kernel work against values worked by hand."""

import json
import math
import os

import pytest

from benchmark.harness import PEAKS, load_module
from benchmark.tests.tiny import REPO


@pytest.fixture(scope="module")
def cfg():
    with open(os.path.join(REPO, "benchmark", "configs", "online_rnnt.json")) as f:
        return json.load(f)


def test_online_rnnt_flops(cfg):
    f = load_module("flops", "online_rnnt")
    x = f._dims(cfg)
    # 768 frames: conv1 383 x 39 outputs, conv2 191 x 19, out 4,864 -> 256
    assert f.subsample(x, 768) == (18 * 383 * 39 * 256 + 18 * 191 * 19 * 256 * 256
                                   + 2 * 191 * 19 * 256 * 256) == 4_825_432_576
    # a block over 191 frames of one row, full context: FFNs 400,556,032;
    # projections and conv pointwise 175,243,264; depthwise 3,031,552;
    # scores and a.v 56,034,816; linear_pos 25,034,752
    assert f.blocks(x, 191, 191 * 191, 191) == 12 * 659_900_416
    full = {"b": 128, "frames": 768, "t_enc": 191, "u1": 33, "pairs": 128 * 191 * 191}
    assert f.train_step(cfg, full) == pytest.approx(5.3316e12, rel=1e-4)  # ~5.4 TFLOP a step
    call = {"rows": 1024, "chunk": 32, "window": 131, "keys": 224, "decisions": 32768}
    assert f.stream_call(cfg, call) == pytest.approx(2.2095e12, rel=1e-4)  # ~2.2 TFLOP a call
    # a chunk frame at 224 keys: 12 x (2,097,152 + 917,504 + 15,872 + 344,064)
    # in the blocks; the front end over a 131-frame window, 65 x 39 and 32 x 19
    # conv outputs, 808.6 MFLOP for 32 frames
    assert f.blocks(x, 1, 224, 0) == 12 * 3_374_592
    assert f.subsample(x, 131) == (18 * 65 * 39 * 256 + 18 * 32 * 19 * 256 * 256
                                   + 2 * 32 * 19 * 256 * 256) == 808_599_040


def test_kernel_work():
    k = {n: load_module("kernels", n) for n in ("fbank", "ffn_fwd", "ffn_bwd",
                                                "rnnt_fused_fwd", "rnnt_fused_bwd",
                                                "relpos_attention", "ctc_alpha", "rnnt_alpha")}
    fb = {"frames": 9216, "n_fft": 1024, "n_mels": 80}
    assert k["fbank"].ops(fb) == 9216 * (2.5 * 1024 * 10 + 3 * 513 + 2 * 513 * 80)
    assert k["fbank"].nbytes(fb) == 9216 * 1104 * 4
    ff = {"rows": 24448, "d": 256, "h": 1024, "dtype": "bfloat16", "masks": True}
    assert k["ffn_fwd"].ops(ff) == 4 * 24448 * 256 * 1024
    assert k["ffn_fwd"].bound_s(ff, PEAKS) == pytest.approx(25_635_586_048 / 989e12)
    assert k["ffn_bwd"].ops(ff) == 10 * 24448 * 256 * 1024
    # fp32 products are bound as three TF32 passes at the TF32 peak: the stream
    # cell's chunk call, 32,768 rows, 34.4 GFLOP in 0.208 ms
    f32 = {"rows": 32768, "d": 256, "h": 1024, "dtype": "float32", "masks": False}
    assert k["ffn_fwd"].bound_s(f32, PEAKS) == pytest.approx(3 * 34_359_738_368 / 495e12)
    assert k["ffn_bwd"].bound_s(f32, PEAKS) == pytest.approx(30 * 8_589_934_592 / 495e12)
    # #4 at [12, 191, 33] x 256 x 412: 0.0968 ms at the 3xTF32 floor of 494.7 TFLOP/s
    j = {"b": 12, "t": 191, "u1": 33, "d": 256, "v": 412}
    assert k["rnnt_fused_fwd"].bound_s(j, PEAKS) * 1e3 == pytest.approx(0.0968, abs=2e-4)
    assert k["rnnt_fused_bwd"].bound_s(j, PEAKS) * 1e3 == pytest.approx(0.290, abs=1e-3)
    att = {"b": 12, "t": 191, "d": 256, "pairs": 12 * 191 * 191, "heads": 4,
           "dtype": "bfloat16"}
    assert k["relpos_attention"].ops(att) == 6 * 256 * 12 * 191 * 191
    assert k["ctc_alpha"].ops({"b": 12, "t": 191, "s": 65}) == 13 * 12 * 191 * 65
    assert k["rnnt_alpha"].nbytes({"b": 12, "t": 191, "u1": 33}) == 12 * 12 * 191 * 33
    assert math.isclose(PEAKS["hbm"], 3.35e12)


def test_every_kernel_claims_its_events():
    from tpuasr_torch.ops import KERNELS

    seen = {}
    for name in KERNELS:
        mod = load_module("kernels", name)
        for e in mod.EVENTS:
            assert e not in seen, (e, seen.get(e), name)  # an event belongs to one entry
            seen[e] = name
    src = "".join(open(p).read() for p in
                  __import__("glob").glob(os.path.join(REPO, "tpuasr_torch", "csrc", "*.cu")))
    for e in seen:
        assert e in src, e
