"""The port's stateless predictors, joint options, pruned loss and their
decoders == JAX on the CPU, on the same weights (the tiny configuration and
the converter's inverted index map of tests/test_torch_zoo.py), fp32.

- The embedding and conv predictors: `forward` over a label sequence and
  `forward_step` token by token with a padding row frozen, outputs and
  history states atol 1e-5; `forward` equals its steps.
- The HAT, post-join and no-pre-join joints and the relu / gelu
  activations: full logits and `step` atol 1e-5; HAT rows sum to 1 in
  probability (1e-5).
- The pruned loss: `band_offsets` identical; `rnnt_loss_pruned`'s loss
  within LOSS_ATOL 1e-4 and every input's gradient by the leaf rule of
  tests/test_torch_train.py (max |diff| <= 1e-4 * max |g| + 1e-6); a band
  wider than U+1 equals the full loss; the Transducer with
  `rnnt_prune_range` takes it, and a HAT joint the materialized route
  whatever the switches, one training step (losses, every gradient) as JAX.
- The decoders with each stateless predictor and HAT: greedy, beam (CTC
  fusion 0.3, two emissions a frame), streaming greedy and transducer
  rescoring of the beam's n-best: tokens and lengths identical, scores
  within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import BLANK, CHUNK, LEFT, V, batch, build, flax_variables, jax_cfg
from tpuasr.decode import rnnt_beam as jax_beam
from tpuasr.decode.rnnt_greedy import rnnt_greedy_decode as jax_greedy
from tpuasr.decode.rnnt_rescoring import transducer_rescoring as jax_rescoring
from tpuasr.decode.rnnt_streaming import streaming_greedy_decode as jax_streaming_greedy
from tpuasr.losses.rnnt_pruned import band_offsets as jax_band_offsets
from tpuasr.losses.rnnt_pruned import rnnt_loss_pruned as jax_rnnt_loss_pruned
from tpuasr.nn.joint import TransducerJoint as JaxJoint
from tpuasr_torch.config import JointConfig
from tpuasr_torch.convert import convert_params
from tpuasr_torch.decode import (
    rnnt_beam_decode, rnnt_greedy_decode, streaming_greedy_decode, transducer_rescoring,
)
from tpuasr_torch.losses import band_offsets, rnnt_loss_from_logits, rnnt_loss_pruned
from tpuasr_torch.models import init_weights
from tpuasr_torch.nn.joint import TransducerJoint

torch.set_num_threads(1)  # six test workers share the cores

ATOL, LOSS_ATOL, GRAD_REL = 1e-5, 1e-4, 1e-4


def _leaf_close(got: np.ndarray, want: np.ndarray, name: str):
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= GRAD_REL * scale + 1e-6, (name, err, scale)


# ---------------------------------------------------------------- predictors

PREDICTORS = {kind: jax_cfg(predictor=dict(predictor_type=kind, embed_size=32,
                                           activation=act))
              for kind, act in (("embedding", "swish"), ("conv", "relu"))}
_BUILT = {}


def predictor_case(kind):
    if kind not in _BUILT:
        _BUILT[kind] = build(PREDICTORS[kind])
    return _BUILT[kind]


@pytest.mark.parametrize("kind", list(PREDICTORS))
def test_predictor_forward_and_steps_match_jax(kind):
    jm, params, port = predictor_case(kind)
    r = np.random.default_rng(1)
    tokens = r.integers(0, V, (2, 6)).astype(np.int32)
    ref = jm.apply(params, tokens, method="predict")
    got = port.predictor(torch.from_numpy(tokens).long())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL)
    assert type(port.predictor).state_batch_axis == 0

    jstate = jm.apply(params, 2, method="init_predictor_state")
    pstate = port.init_predictor_state(2)
    for i in range(tokens.shape[1]):
        pad = np.array([0, int(i == 2)], np.int32)  # row 1 frozen at step 2
        rout, jstate = jm.apply(params, tokens[:, i], jstate, pad, method="predict_step")
        gout, pstate = port.predict_step(torch.from_numpy(tokens[:, i]).long(), pstate,
                                         torch.from_numpy(pad))
        np.testing.assert_allclose(gout.numpy(), np.asarray(rout), rtol=0, atol=ATOL)
        np.testing.assert_allclose(pstate[0].numpy(), np.asarray(jstate[0]), rtol=0, atol=ATOL)
    # without padding, forward == its steps
    pstate, outs = port.init_predictor_state(2), []
    for i in range(tokens.shape[1]):
        out, pstate = port.predict_step(torch.from_numpy(tokens[:, i]).long(), pstate)
        outs.append(out)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), got.detach().numpy(), rtol=0,
                               atol=ATOL)


# ---------------------------------------------------------------- joints

JOINTS = {
    "hat": dict(hat_joint=True),
    "hat_postjoin_gelu": dict(hat_joint=True, postjoin_linear=True, activation="gelu"),
    "postjoin": dict(postjoin_linear=True),
    "no_prejoin_relu": dict(prejoin_linear=False, activation="relu"),
    "gelu": dict(activation="gelu"),
}


@pytest.mark.parametrize("name", list(JOINTS))
def test_joint_matches_jax(name):
    jc = jax_cfg(joint=JOINTS[name]).joint
    port = init_weights(TransducerJoint(JointConfig(**vars(jc)), 32, 32, V, BLANK), 2)
    r = np.random.default_rng(2)
    enc = r.standard_normal((2, 7, 32)).astype(np.float32)
    pred = r.standard_normal((2, 4, 32)).astype(np.float32)
    jmod = JaxJoint(jc, V, blank_id=BLANK)
    variables = flax_variables(jmod, port, enc, pred)
    ref = np.asarray(jmod.apply(variables, enc, pred))
    got = port(torch.from_numpy(enc), torch.from_numpy(pred)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    ref_step = np.asarray(jmod.apply(variables, enc[:, 3], pred[:, 1], method="step"))
    got_step = port.step(torch.from_numpy(enc[:, 3]), torch.from_numpy(pred[:, 1]))
    np.testing.assert_allclose(got_step.detach().numpy(), ref_step, rtol=0, atol=ATOL)
    assert port.plain_head == (name in ("no_prejoin_relu", "gelu"))
    if jc.hat_joint:
        np.testing.assert_allclose(np.exp(got).sum(-1), 1.0, rtol=0, atol=1e-5)


# ---------------------------------------------------------------- pruned loss

def pruned_problem(seed=0, b=3, t=12, u=6, d=8, v=11):
    r = np.random.default_rng(seed)
    enc_p = (r.standard_normal((b, t, d)) * 0.5).astype(np.float32)
    pred_p = (r.standard_normal((b, u + 1, d)) * 0.5).astype(np.float32)
    w = (r.standard_normal((d, v)) * 0.3).astype(np.float32)
    bias = (r.standard_normal(v) * 0.1).astype(np.float32)
    labels = r.integers(1, v, (b, u)).astype(np.int32)
    return enc_p, pred_p, w, bias, labels, np.array([t, t - 2, t - 5], np.int32)[:b], \
        np.array([u, u - 1, u - 3], np.int32)[:b]


def test_band_offsets_match_jax():
    r = np.random.default_rng(4)
    t_lens = r.integers(0, 40, 16).astype(np.int32)
    u_lens = r.integers(0, 15, 16).astype(np.int32)
    for s in (1, 2, 3, 5, 8, 16):
        want = np.asarray(jax_band_offsets(jnp.asarray(t_lens), jnp.asarray(u_lens), 40, s))
        got = band_offsets(torch.from_numpy(t_lens), torch.from_numpy(u_lens), 40, s)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("s_range", [2, 3, 5])
def test_pruned_loss_and_grads_match_jax(s_range):
    args = pruned_problem(seed=s_range)
    want, want_g = jax.value_and_grad(
        lambda *x: jax_rnnt_loss_pruned(*x, *args[4:], blank=0, s_range=s_range),
        argnums=(0, 1, 2, 3))(*map(jnp.asarray, args[:4]))
    xs = [torch.from_numpy(a).requires_grad_() for a in args[:4]]
    got = rnnt_loss_pruned(*xs, *map(torch.from_numpy, args[4:]), 0, s_range)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0, atol=LOSS_ATOL)
    for name, x, g in zip(("enc_p", "pred_p", "w", "bias"), xs, want_g, strict=True):
        _leaf_close(x.grad.numpy(), np.asarray(g), name)
    nll = rnnt_loss_pruned(*xs, *map(torch.from_numpy, args[4:]), 0, s_range, "none")
    assert torch.isfinite(nll).all() and (nll > 0).all()


def test_wide_band_equals_full_loss():
    """A band of U+1 or more positions is the full loss: value and gradients
    against the materialized route on the same joint."""
    args = pruned_problem(seed=9)
    u1 = args[1].shape[1]
    xs = [torch.from_numpy(a).requires_grad_() for a in args[:4]]
    got = rnnt_loss_pruned(*xs, *map(torch.from_numpy, args[4:]), 0, u1 + 2)
    grads = torch.autograd.grad(got, xs)
    logits = torch.tanh(xs[0][:, :, None] + xs[1][:, None]) @ xs[2] + xs[3]
    full = rnnt_loss_from_logits(logits, *map(torch.from_numpy, args[4:]), 0, "mean")
    np.testing.assert_allclose(float(got.detach()), float(full.detach()), rtol=0, atol=1e-5)
    for g, f in zip(grads, torch.autograd.grad(full, xs), strict=True):
        _leaf_close(g.numpy(), f.numpy(), "wide band")


STEPS = {  # (joint, model options): the pruned route; HAT takes the materialized one
    "pruned_embedding": (dict(), dict(rnnt_prune_range=3)),
    "hat_over_pruned_and_fused": (dict(hat_joint=True),
                                  dict(rnnt_prune_range=3, fused_joint_loss=True)),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_training_step_matches_jax(name):
    joint, model = STEPS[name]
    jc = jax_cfg(predictor=dict(predictor_type="embedding", embed_size=32), joint=joint,
                 **model)
    jm, params, port = build(jc)
    feats, lens, texts, tlens = batch()

    def loss_fn(p, *xs):
        out = jm.apply({"params": p}, *xs)
        return out["loss"], out

    # the batch as arguments, as the JAX train step takes it: XLA folds
    # band_offsets' division differently when the lengths are constants
    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params["params"], feats, lens, texts, tlens)
    port.train()
    got = port(*(torch.from_numpy(x) for x in (feats, lens, texts, tlens)))
    for k in ("loss", "loss_rnnt", "loss_ctc"):
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=0, atol=LOSS_ATOL,
                                   err_msg=k)
    got["loss"].backward()
    want = convert_params(jax.tree.map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert want.keys() == named.keys()
    for k, p in named.items():
        _leaf_close(p.grad.numpy(), want[k].numpy(), k)
    port.eval()


# ---------------------------------------------------------------- decoders

DECODERS = {  # (predictor, joint): each stateless predictor, and HAT
    "embedding": ("embedding", dict()),
    "conv_hat": ("conv", dict(hat_joint=True)),
}
_DECODED = {}


def decoder_case(name):
    """(JAX model, variables, port, feats, lens, encoder output, lens): the
    blank's logit set so that hypotheses both emit and take blanks."""
    if name not in _DECODED:
        kind, joint = DECODERS[name]
        jc = jax_cfg(predictor=dict(predictor_type=kind, embed_size=32, activation="swish"),
                     joint=joint)
        jm, params, port = build(jc, blank_bias=1.0)
        if "blank_pred" in params["params"]["joint"]:
            params["params"]["joint"]["blank_pred"]["bias"][:] = -2.0
            with torch.no_grad():
                port.joint.blank_pred.bias[:] = -2.0
        r = np.random.default_rng(5)
        x = (r.standard_normal((2, 99, 80)) * 0.5).astype(np.float32)
        lens = np.array([99, 75], np.int32)
        enc, enc_lens = jm.apply(params, x, lens, method="encode")
        _DECODED[name] = (jm, params, port, x, lens, np.array(enc), np.array(enc_lens))
    return _DECODED[name]


@pytest.mark.parametrize("name", list(DECODERS))
def test_greedy_and_streaming_match_jax(name):
    jm, params, port, x, lens, enc, enc_lens = decoder_case(name)
    ref_t, ref_l = jax_greedy(jm, params, jnp.asarray(enc), jnp.asarray(enc_lens), BLANK,
                              n_steps=3, max_tokens=40)
    got_t, got_l = rnnt_greedy_decode(port, torch.from_numpy(enc), torch.from_numpy(enc_lens),
                                      BLANK, n_steps=3, max_tokens=40)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))
    assert (got_l > 0).all() and (got_l < 3 * torch.from_numpy(enc_lens)).all()
    ref_t, ref_l, _ = jax_streaming_greedy(jm, params, x, lens, CHUNK, LEFT, BLANK, 3, 40)
    got_t, got_l, _ = streaming_greedy_decode(port, torch.from_numpy(x), torch.from_numpy(lens),
                                              CHUNK, LEFT, BLANK, 3, 40)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(ref_t))


@pytest.mark.parametrize("name", list(DECODERS))
def test_beam_and_rescoring_match_jax(name):
    jm, params, port, _, _, enc, enc_lens = decoder_case(name)
    e, el = jnp.asarray(enc), jnp.asarray(enc_lens)
    ref = jax_beam.rnnt_beam_decode(jm, params, e, el, BLANK, 4, 40, n_steps=2,
                                    ctc_weight=0.3)
    pe, pel = torch.from_numpy(enc), torch.from_numpy(enc_lens)
    got = rnnt_beam_decode(port, pe, pel, BLANK, 4, 40, n_steps=2, ctc_weight=0.3)
    for g, r in zip(got[:4], ref[:4], strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), rtol=0, atol=1e-4)
    assert (got[1] > 0).all() and (got[1] < 40).all()
    rt, rl, rs = jax_rescoring(jm, params, e, el, *ref[2:5], BLANK)
    gt, gl, gs = transducer_rescoring(port, pe, pel, *got[2:5], BLANK)
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(rl))
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=0, atol=1e-4)
