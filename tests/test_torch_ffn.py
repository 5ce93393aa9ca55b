"""The port's fused FFN (kernels #10/#11's plain versions) == JAX on the CPU.

- `fused_ffn` (CPU tensors: `ffn_fwd_plain` forward, `ffn_bwd_plain`
  backward) against `tpuasr.ops.ffn_pallas.fused_ffn` in Pallas interpret
  mode, as tests/test_fused_ffn.py runs it: R = 70 and 300 rows (not
  multiples of the 256-row TPU tile), D 64, H 128, no masks and drawn
  keep-masks at rate 0.5, ff_scale 0.5 and 1.0, the same numpy inputs and a
  numpy cotangent on both sides. fp32: output 2e-5, all seven gradients
  3e-4 (rtol = atol, the tolerances the JAX test holds its own kernel to).
  bf16 (x, W1, W2 and the output in bf16): output within 2**-7 of the
  output's max |.| and every gradient within 2**-6 of its max |.| - the
  products round at the same points on both sides, so what differs is fp32
  summation order, which can move a value across a bf16 rounding edge
  (one bf16 ulp is 2**-8 relative).
- The tiny flagship encoder with `encoder.fused_ffn=True` against JAX's
  with the flag (interpret mode), deterministic, on converted weights:
  full-context and chunk-masked `encode`, and `forward_chunk` window by
  window, atol 1e-4 (two blocks of fp32 sums in another order).
- Route equality: in train mode, with dropout 0.1 and one dropout generator
  seed, the port's fused route and its module route give the same loss and
  the same gradients to fp32 rounding (rtol 1e-5, atol 1e-6 of the
  largest gradient): the masks drawn in the module chain's order make the
  same keep decisions, and the backward applies the forward's masks.
- The wrappers refuse devices other than CPU and CUDA, and never count a
  launch for CPU tensors.
- The kernels' tiling (`_ffn_plan`, plain Python): row tiles x H slices at
  the main paths' row counts on a 132-SM card, no empty slice, and the
  workspace bytes of both kernels.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.config import to_dict
from tpuasr.models import Transducer as JaxTransducer
from tpuasr.ops.ffn_pallas import fused_ffn as jax_fused_ffn
from tpuasr.streaming.chunkwise import chunk_windows as jax_chunk_windows
from tpuasr_torch.config import ModelConfig, from_dict
from tpuasr_torch.convert import load_jax_params
from tpuasr_torch.models import Transducer, init_weights
from tpuasr_torch.ops import LAUNCHES, ffn_bwd, ffn_fwd, fused_ffn
from tpuasr_torch.streaming import chunk_windows, num_chunks

torch.set_num_threads(1)  # six test workers share the cores

D, H, RATE = 64, 128, 0.5
NAMES = ("x", "ln_scale", "ln_bias", "w1", "b1", "w2", "b2")


def _inputs(r, masks, seed=0):
    g = np.random.default_rng(seed)
    f32 = lambda *s: g.standard_normal(s).astype(np.float32)
    x = f32(r, D)
    args = [x, 1.0 + 0.1 * f32(D), 0.1 * f32(D), f32(D, H) / np.sqrt(D), 0.1 * f32(H),
            f32(H, D) / np.sqrt(H), 0.1 * f32(D)]
    m1 = m2 = None
    if masks:
        m1 = (g.random((r, H)) >= RATE).astype(np.uint8)
        m2 = (g.random((r, D)) >= RATE).astype(np.uint8)
    return args, m1, m2, f32(r, D)


def _jax(args, m1, m2, cot, scale, dtype):
    x, gs, gb, w1, b1, w2, b2 = args
    lo = lambda a: jnp.asarray(a, dtype)
    jargs = (lo(x), jnp.asarray(gs), jnp.asarray(gb), lo(w1), jnp.asarray(b1), lo(w2),
             jnp.asarray(b2))
    jm = (None, None) if m1 is None else (jnp.asarray(m1), jnp.asarray(m2))
    out, vjp = jax.vjp(lambda *a: jax_fused_ffn(*a, *jm, RATE, scale, m1 is None), *jargs)
    grads = vjp(jnp.asarray(cot, dtype))
    return [np.asarray(out.astype(jnp.float32))] + [np.asarray(gr.astype(jnp.float32))
                                                     for gr in grads]


def _port(args, m1, m2, cot, scale, dtype):
    x, gs, gb, w1, b1, w2, b2 = (torch.from_numpy(a) for a in args)
    # the JAX kernels are [in, out]; torch's layout is [out, in]
    leaves = [x.to(dtype), gs, gb, w1.t().contiguous().to(dtype), b1,
              w2.t().contiguous().to(dtype), b2]
    leaves = [t.requires_grad_() for t in leaves]
    tm = [None if m is None else torch.from_numpy(m) for m in (m1, m2)]
    out = fused_ffn(*leaves, *tm, RATE, scale)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot).to(dtype))
    assert out.dtype == dtype and all(gr.dtype == t.dtype for gr, t in zip(grads, leaves))
    grads = [gr.float() for gr in grads]
    grads[3], grads[5] = grads[3].t(), grads[5].t()  # back to the JAX layout
    return [out.detach().float().numpy()] + [gr.numpy() for gr in grads]


@pytest.mark.parametrize("r,masks,scale", [(70, False, 1.0), (70, True, 0.5),
                                           (300, False, 0.5), (300, True, 1.0)])
def test_fused_ffn_matches_jax_fp32(r, masks, scale):
    args, m1, m2, cot = _inputs(r, masks)
    ref = _jax(args, m1, m2, cot, scale, jnp.float32)
    got = _port(args, m1, m2, cot, scale, torch.float32)
    np.testing.assert_allclose(got[0], ref[0], rtol=2e-5, atol=2e-5)
    for name, a, b in zip(NAMES, got[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=3e-4, atol=3e-4, err_msg=name)


def test_fused_ffn_matches_jax_bf16():
    args, m1, m2, cot = _inputs(300, True, seed=1)
    ref = _jax(args, m1, m2, cot, 0.5, jnp.bfloat16)
    got = _port(args, m1, m2, cot, 0.5, torch.bfloat16)
    assert np.abs(got[0] - ref[0]).max() <= 2.0 ** -7 * np.abs(ref[0]).max()
    for name, a, b in zip(NAMES, got[1:], ref[1:]):
        assert np.abs(a - b).max() <= 2.0 ** -6 * np.abs(b).max(), name


def _jax_cfg(fused_ffn):
    mc = _flagship_config(tiny=True).model
    mc.encoder = dataclasses.replace(mc.encoder, fused_ffn=fused_ffn)
    return mc


@pytest.fixture(scope="module")
def encoders():
    mc = _jax_cfg(True)
    model = JaxTransducer(mc)
    b, t = 2, 67
    params = jax.jit(model.init)(jax.random.PRNGKey(0), np.zeros((b, t, 80), np.float32),
                                 np.full((b,), t, np.int32), np.zeros((b, 5), np.int32),
                                 np.full((b,), 5, np.int32))
    params = jax.tree.map(np.asarray, params)
    port = load_jax_params(Transducer(from_dict(ModelConfig, to_dict(mc)), device="cpu"),
                           params)
    assert port.cfg.encoder.fused_ffn
    r = np.random.default_rng(0)
    feats = r.standard_normal((b, t, 80)).astype(np.float32)
    return mc, model, params, port, (feats, np.array([67, 51], np.int32))


@pytest.mark.parametrize("chunk", [0, 4])
def test_fused_encoder_matches_jax(encoders, chunk):
    mc, model, params, port, (feats, lens) = encoders
    ref, ref_lens = jax.jit(lambda p, f, n: model.apply(p, f, n, chunk, 2,
                                                        method=JaxTransducer.encode))(
        params, feats, lens)
    before = dict(LAUNCHES)
    got, got_lens = port.encode(torch.from_numpy(feats), torch.from_numpy(lens), chunk, 2)
    assert LAUNCHES == before  # CPU tensors: the plain versions
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_fused_forward_chunk_matches_jax(encoders):
    mc, model, params, port, (feats, _) = encoders
    chunk, left = 4, 2
    n = num_chunks(feats.shape[1], chunk, 4, 6)
    jw = jax_chunk_windows(jnp.asarray(feats), chunk, 4, 6, n)
    tw = chunk_windows(torch.from_numpy(feats), chunk, 4, 6, n)
    jstate = model.apply(params, feats.shape[0], chunk, left,
                         method=JaxTransducer.init_encoder_state)
    tstate = port.init_encoder_state(feats.shape[0], chunk, left)
    step = jax.jit(lambda p, w, s: model.apply(p, w, s, method=JaxTransducer.encode_chunk))
    for i in range(min(n, 4)):  # the cache fills over the first left + 1 chunks
        ref, jstate = step(params, jw[i], jstate)
        got, tstate = port.encode_chunk(tw[i], tstate)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, err_msg=str(i))


def _train_loss_and_grads(fused: bool, seed: int):
    mc = ModelConfig(vocab_size=64)
    mc.encoder = dataclasses.replace(mc.encoder, output_size=64, attention_heads=2,
                                     linear_units=128, num_blocks=2, cnn_module_kernel=7,
                                     causal=True, static_chunk_size=4, fused_ffn=fused,
                                     dropout_rate=0.1, positional_dropout_rate=0.0)
    mc.predictor = dataclasses.replace(mc.predictor, embed_size=16, hidden_size=16,
                                       output_size=32, dropout=0.0)
    mc.ctc_dropout_rate = 0.0
    model = init_weights(Transducer(mc, device="cpu"), seed=3)
    model.train()
    r = np.random.default_rng(1)
    feats = torch.from_numpy(r.standard_normal((2, 47, 80)).astype(np.float32))
    texts = torch.from_numpy(r.integers(6, 64, (2, 4)))
    out = model(feats, torch.tensor([47, 33]), texts, torch.tensor([4, 2]),
                dropout_gen=torch.Generator().manual_seed(seed))
    out["loss"].backward()
    return float(out["loss"].detach()), {n: p.grad.clone() for n, p in model.named_parameters()}


def test_fused_route_equals_module_route_in_training():
    loss_f, grads_f = _train_loss_and_grads(True, seed=5)
    loss_m, grads_m = _train_loss_and_grads(False, seed=5)
    loss_o, _ = _train_loss_and_grads(True, seed=6)
    assert loss_o != loss_f  # the generator's masks are in effect
    assert abs(loss_f - loss_m) <= 1e-5 * abs(loss_m)
    top = max(float(g.abs().max()) for g in grads_m.values())
    for name, g in grads_m.items():
        torch.testing.assert_close(grads_f[name], g, rtol=1e-5, atol=1e-6 * top, msg=name)


def test_ffn_wrappers_refuse_other_devices():
    meta = torch.empty(4, 64, device="meta")
    vec, w1, w2 = torch.empty(64, device="meta"), torch.empty(128, 64, device="meta"), \
        torch.empty(64, 128, device="meta")
    b1 = torch.empty(128, device="meta")
    for fn, extra in ((ffn_fwd, ()), (ffn_bwd, (meta,)), (fused_ffn, ())):
        with pytest.raises(ValueError, match="unsupported device"):
            fn(meta, vec, vec, w1, b1, w2, vec, None, None, *extra, 0.1, 0.5)


# (rows, dtype) -> (row tiles, #10's H slices, #11's) of `_ffn_plan` on a
# 132-SM card at D 256, H 1024: bench.py's training rows, the trainer's
# T' 63 and 127 buckets, serving's 748 rows and a streaming chunk's 128, the
# bf16 serving rows too
PLANS = [(2292, torch.bfloat16, (36, 3, 3)), (756, torch.bfloat16, (12, 11, 11)),
         (1524, torch.bfloat16, (24, 5, 5)), (748, torch.float32, (24, 11, 5)),
         (128, torch.float32, (4, 32, 32)), (748, torch.bfloat16, (12, 11, 11)),
         (128, torch.bfloat16, (2, 32, 32))]


@pytest.mark.parametrize("r,dtype,want", PLANS)
def test_ffn_plan_fills_the_card(r, dtype, want):
    """The kernels' tiling: row tiles x H slices fill the card without a
    second wave (#10: two blocks an SM in fp32, one in bf16; #11's row side
    one) where H allows,
    every slice holds a chunk, and the workspaces are sized from (R, S): the
    forward's partial outputs S R D fp32 (none for one slice), the
    backward's xn, dyc [R, D] and activation, dh [R, H] in the compute type,
    S partial dxn, and per-tile vectors."""
    from tpuasr_torch.ops.ffn import _ffn_plan

    d, h, n_sm = 256, 1024, 132
    plan = _ffn_plan(r, d, h, dtype, n_sm)
    assert (plan["tiles"], plan["fwd_slices"], plan["bwd_slices"]) == want
    rows, tiles = plan["rows"], plan["tiles"]
    assert rows == (64 if dtype == torch.bfloat16 else 32) and tiles == -(-r // rows)
    for kind, per_sm in (("fwd", 2 if dtype == torch.float32 else 1), ("bwd", 1)):
        s, chunks = plan[f"{kind}_slices"], plan[f"{kind}_chunks"]
        assert (s - 1) * chunks < h // 32 <= s * chunks  # no empty slice
        assert tiles * s <= n_sm * per_sm or s == 1  # one wave
        # and no longer slices: one chunk fewer each would take a second wave
        assert chunks == 1 or tiles * -(-(h // 32) // (chunks - 1)) > n_sm * per_sm
    s = plan["bwd_slices"]
    assert plan["fwd_ws"] == plan["fwd_slices"] * r * d * 4
    es = 2 if dtype == torch.bfloat16 else 4
    at_least = 2 * r * (d + h) * es + s * r * d * 4 + tiles * (h + d) * 4
    assert at_least <= plan["bwd_ws"] <= at_least + 9 * 256 + 2 * (-(-r // 8)) * d * 4
    if r == 2292:  # bench.py's shape: the sizes the source note gives
        assert (plan["fwd_ws"], plan["bwd_ws"]) == (7_041_024, 19_548_160)


def test_ffn_plan_small_cards_and_odd_h():
    """One slice when the rows alone fill the card; H 160 (five chunks)
    splits into at most five."""
    from tpuasr_torch.ops.ffn import _ffn_plan

    one = _ffn_plan(2292, 256, 1024, torch.bfloat16, 16)
    assert one["fwd_slices"] == one["bwd_slices"] == 1 and one["fwd_ws"] == 0
    odd = _ffn_plan(70, 64, 160, torch.bfloat16, 132)
    assert (odd["tiles"], odd["fwd_slices"], odd["bwd_slices"]) == (2, 5, 5)
