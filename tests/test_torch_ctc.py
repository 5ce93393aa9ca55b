"""Port CTC == JAX on the CPU: values and gradients w.r.t. the log-probs.

- the plain `ctc_loss` (autograd through torch ops) against JAX `ctc_loss`;
- the lattice's `autograd.Function` (`ctc_lattice`: the plain versions of
  kernels #6/#7 on the CPU) against `ctc_loss_pallas(interpret=True)`;
- `ctc_loss_from_logits` against JAX's (log-softmax, sum over batch).

Cases: blank 0; blank 5 (inside the label range); t_len < T; label_len 0;
an infeasible row (repeats that T cannot hold: loss 0, gradient 0). Each row
of the upstream gradient is weighted differently, so a row's gradient
cannot hide behind another's. Tolerance: fp32 log-adds in the same order
over 12 frames, the values ~10-30: atol 1e-4 on values, 1e-5 on gradients
(each entry an exp of a log-domain sum, at most 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.losses import ctc_loss as jax_ctc_loss
from tpuasr.losses import ctc_loss_from_logits as jax_ctc_from_logits
from tpuasr.ops.ctc_pallas import ctc_loss_pallas
from tpuasr_torch.losses.ctc import ctc_loss, ctc_loss_from_logits, lattice_inputs
from tpuasr_torch.losses.rnnt import zero_infeasible
from tpuasr_torch.ops import LAUNCHES, ctc_lattice

B, T, V, U = 3, 12, 9, 4
VALUE_ATOL, GRAD_ATOL = 1e-4, 1e-5


def _case(kind: str):
    r = np.random.default_rng(sum(map(ord, kind)))
    blank = 5 if kind == "blank5" else 0
    logits = r.standard_normal((B, T, V)).astype(np.float32)
    labels = r.integers(1, V, size=(B, U)).astype(np.int32)
    if blank:
        labels[labels == blank] = 1
        labels[0, 1] = labels[0, 0]  # a repeat: no skip between them
    t_lens = np.full(B, T, np.int32)
    l_lens = np.array([U, U - 1, U - 2], np.int32)
    if kind == "short_t":
        t_lens[:] = [T, 7, 3]
    elif kind == "empty_label":
        l_lens[1] = 0
    elif kind == "infeasible":
        labels[1] = 3  # 3 3 3 (label_len 3) needs 5 frames
        t_lens[1] = 4
    w = r.uniform(0.5, 2.0, B).astype(np.float32)
    return logits, labels, t_lens, l_lens, blank, w


CASES = ["blank0", "blank5", "short_t", "empty_label", "infeasible"]


def _jax_lp(logits):
    return jax.nn.log_softmax(jnp.asarray(logits), axis=-1)


def _check(got_nll, got_grad, ref_nll, ref_grad, kind):
    np.testing.assert_allclose(got_nll, np.asarray(ref_nll), rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(got_grad, np.asarray(ref_grad), rtol=0, atol=GRAD_ATOL)
    if kind == "infeasible":
        assert got_nll[1] == 0.0 and np.all(got_grad[1] == 0.0)


@pytest.mark.parametrize("kind", CASES)
def test_plain_ctc_matches_jax(kind):
    logits, labels, t_lens, l_lens, blank, w = _case(kind)
    lp = _jax_lp(logits)
    ref = jax_ctc_loss(lp, t_lens, labels, l_lens, blank)
    ref_g = jax.grad(lambda x: jnp.sum(jax_ctc_loss(x, t_lens, labels, l_lens, blank) * w))(lp)
    x = torch.from_numpy(np.array(lp)).requires_grad_()
    nll = ctc_loss(x, torch.from_numpy(t_lens), torch.from_numpy(labels),
                   torch.from_numpy(l_lens), blank)
    (nll * torch.from_numpy(w)).sum().backward()
    _check(nll.detach().numpy(), x.grad.numpy(), ref, ref_g, kind)


@pytest.mark.parametrize("kind", CASES)
def test_lattice_function_matches_pallas_interpret(kind):
    logits, labels, t_lens, l_lens, blank, w = _case(kind)
    lp = _jax_lp(logits)

    def pallas(x):
        return ctc_loss_pallas(x, t_lens, labels, l_lens, blank, interpret=True)

    ref = pallas(lp)
    ref_g = jax.grad(lambda x: jnp.sum(pallas(x) * w))(lp)
    x = torch.from_numpy(np.array(lp)).requires_grad_()
    lp_states, skip, final = lattice_inputs(x, torch.from_numpy(labels),
                                            torch.from_numpy(l_lens), blank)
    before = dict(LAUNCHES)
    nll = zero_infeasible(ctc_lattice(lp_states, skip, torch.from_numpy(t_lens), final))
    (nll * torch.from_numpy(w)).sum().backward()
    assert LAUNCHES == before  # CPU tensors: the plain versions only
    _check(nll.detach().numpy(), x.grad.numpy(), ref, ref_g, kind)


@pytest.mark.parametrize("kind", ["blank5", "infeasible"])
def test_ctc_from_logits_matches_jax(kind):
    logits, labels, t_lens, l_lens, blank, _ = _case(kind)
    fn = lambda z: jax_ctc_from_logits(z, t_lens, labels, l_lens, blank, "sum_over_batch")
    ref, ref_g = jax.value_and_grad(fn)(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss_from_logits(z, torch.from_numpy(t_lens), torch.from_numpy(labels),
                                torch.from_numpy(l_lens), blank, "sum_over_batch")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=0, atol=VALUE_ATOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=0, atol=GRAD_ATOL)
