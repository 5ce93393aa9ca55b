"""Port RNN-T losses == JAX on the CPU: values and gradients.

- plain `rnnt_loss` (the anti-diagonal lattice with its closed-form
  occupancy backward) against JAX `rnnt_loss` (associative scans), w.r.t. the
  log-probs, and `rnnt_loss_from_logits` w.r.t. the logits;
- the fused loss, `rnnt_loss_fused_mean` on the plain versions of kernels
  #4/#5, against JAX `rnnt_loss_fused_mean(interpret=True)`: the value and
  the gradients w.r.t. enc_p, pred_p, W and b.

Cases: full lengths; t_len < T and u_len < U; u_len = 0; t_len = 0 with
labels (infeasible: loss 0, gradient 0). V = 20 is not a multiple of the
TPU kernel's 128-lane padding. Tolerance: fp32, the two lattices log-add in
another order (scan vs sequential); values ~10-40: atol 1e-4; gradients are
occupancies and their products with tanh' and W, at most ~1: atol 1e-5
(fused: 2e-5, three fp32 products deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.losses import rnnt_loss as jax_rnnt_loss
from tpuasr.losses import rnnt_loss_from_logits as jax_rnnt_from_logits
from tpuasr.ops.rnnt_fused_pallas import rnnt_loss_fused_mean as jax_fused_mean
from tpuasr_torch.losses.rnnt import rnnt_loss, rnnt_loss_from_logits
from tpuasr_torch.ops import LAUNCHES, rnnt_loss_fused_mean

B, T, U, D, V, BLANK = 3, 7, 4, 16, 20, 3
VALUE_ATOL, GRAD_ATOL, FUSED_GRAD_ATOL = 1e-4, 1e-5, 2e-5
CASES = ["full", "short", "empty_label", "no_frames"]


def _lens(kind):
    t_lens, u_lens = np.array([T, T - 2, T - 3], np.int32), np.array([U, U - 1, U - 2], np.int32)
    if kind == "full":
        t_lens[:], u_lens[:] = T, U
    elif kind == "empty_label":
        u_lens[1] = 0
    elif kind == "no_frames":
        t_lens[2] = 0
    return t_lens, u_lens


def _labels(r):
    return r.integers(0, V, size=(B, U)).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind", CASES)
def test_plain_rnnt_matches_jax(kind):
    r = np.random.default_rng(sum(map(ord, kind)))
    logits = r.standard_normal((B, T, U + 1, V)).astype(np.float32)
    lp = jax.nn.log_softmax(jnp.asarray(logits), axis=-1)
    labels, (t_lens, u_lens) = _labels(r), _lens(kind)
    w = r.uniform(0.5, 2.0, B).astype(np.float32)
    fn = lambda x: jax_rnnt_loss(x, labels, t_lens, u_lens, BLANK)
    ref = fn(lp)
    ref_g = jax.grad(lambda x: jnp.sum(fn(x) * w))(lp)
    x = _t(lp).requires_grad_()
    nll = rnnt_loss(x, _t(labels), _t(t_lens), _t(u_lens), BLANK)
    (nll * _t(w)).sum().backward()
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(ref), rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_g), rtol=0, atol=GRAD_ATOL)
    if kind == "no_frames":
        assert nll[2] == 0.0 and torch.all(x.grad[2] == 0.0)


def test_rnnt_from_logits_matches_jax():
    r = np.random.default_rng(5)
    logits = r.standard_normal((B, T, U + 1, V)).astype(np.float32)
    labels, (t_lens, u_lens) = _labels(r), _lens("short")
    ref, ref_g = jax.value_and_grad(
        lambda z: jax_rnnt_from_logits(z, labels, t_lens, u_lens, BLANK, "mean",
                                       use_pallas=False))(jnp.asarray(logits))
    z = _t(logits).requires_grad_()
    loss = rnnt_loss_from_logits(z, _t(labels), _t(t_lens), _t(u_lens), BLANK, "mean")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=0, atol=GRAD_ATOL)


@pytest.mark.parametrize("kind", CASES)
def test_fused_loss_matches_pallas_interpret(kind):
    r = np.random.default_rng(100 + sum(map(ord, kind)))
    enc_p = r.standard_normal((B, T, D)).astype(np.float32)
    pred_p = r.standard_normal((B, U + 1, D)).astype(np.float32)
    w = (r.standard_normal((D, V)) / np.sqrt(D)).astype(np.float32)
    bias = (r.standard_normal(V) * 0.1).astype(np.float32)
    labels, (t_lens, u_lens) = _labels(r), _lens(kind)
    args = tuple(jnp.asarray(a) for a in (enc_p, pred_p, w, bias))
    fn = lambda e, p, ww, bb: jax_fused_mean(e, p, ww, bb, labels, t_lens, u_lens, BLANK,
                                            interpret=True)
    ref, ref_g = jax.value_and_grad(fn, argnums=(0, 1, 2, 3))(*args)
    got_in = [_t(a).requires_grad_() for a in (enc_p, pred_p, w, bias)]
    before = dict(LAUNCHES)
    loss = rnnt_loss_fused_mean(*got_in, _t(labels), _t(t_lens), _t(u_lens), BLANK)
    loss.backward()
    assert LAUNCHES == before  # CPU tensors: the plain versions only
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=0, atol=VALUE_ATOL)
    for name, got, want in zip(("d_enc_p", "d_pred_p", "dW", "db"), got_in, ref_g):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=0,
                                   atol=FUSED_GRAD_ATOL, err_msg=name)
