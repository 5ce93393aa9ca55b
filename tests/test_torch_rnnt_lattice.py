"""The RNN-T lattice (plain versions of kernels #8/#9) == JAX on the CPU.

The port's plain alpha tape, log-likelihood and the blank/label occupancy
gradients against `_rnnt_forward` / `_rnnt_bwd` of `tpuasr/ops/rnnt_pallas.py`
in interpret mode, on masked lattice inputs with a t_len = 0 row and a
u_len = 0 row; B 10 spans two of the TPU kernel's batch tiles. And the
materialized loss, the port's `rnnt_loss_from_logits` against the JAX one
with `use_pallas=True`. Tolerances as tests/test_rnnt_pallas.py:25, 34:
values rtol 1e-4, atol 1e-4 (the Pallas kernel's doubling scan adds in
another order than the anti-diagonal sweep); gradients rtol 1e-3, atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.losses.rnnt import rnnt_loss_from_logits as jax_rnnt_from_logits
from tpuasr.ops.rnnt_pallas import _rnnt_bwd, _rnnt_forward
from tpuasr_torch.losses import rnnt_loss_from_logits
from tpuasr_torch.ops import LAUNCHES, rnnt_alpha, rnnt_beta_grad, rnnt_lattice

torch.set_num_threads(1)  # six test workers share the cores

VALUE_TOL, GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-3, 1e-4
NEG = -1.0e30


def _lattice_inputs(b, t, u, seed):
    """Masked blank [B, T, U+1] / label [B, T, U] log-probs, t_lens, u_lens;
    row 1 has labels and no frames, row 2 no labels."""
    r = np.random.default_rng(seed)
    v = 9
    logits = r.standard_normal((b, t, u + 1, v)).astype(np.float32)
    lp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = r.integers(1, v, size=(b, u))
    t_lens = r.integers(t // 2, t + 1, size=b).astype(np.int32)
    u_lens = r.integers(0, u + 1, size=b).astype(np.int32)
    t_lens[0], u_lens[0] = t, u
    t_lens[1], u_lens[1], u_lens[2] = 0, u, 0
    blank = lp[..., 0]
    label = np.take_along_axis(lp[:, :, :u], labels[:, None, :, None], axis=3)[..., 0]
    pad_t = np.arange(t)[None, :, None] >= t_lens[:, None, None]
    blank = np.where(pad_t, 0.0, blank).astype(np.float32)
    valid = (np.arange(u)[None, None, :] < u_lens[:, None, None]) & ~pad_t
    label = np.where(valid, label, NEG).astype(np.float32)
    return blank, label, t_lens, u_lens


@pytest.mark.parametrize("b,t,u", [(10, 9, 5), (3, 13, 1)])
def test_plain_lattice_matches_pallas_interpret(b, t, u):
    blank, label, _, u_lens = _lattice_inputs(b, t, u, seed=b * t + u)
    ll_ref, res = _rnnt_forward(jnp.asarray(blank), jnp.asarray(label), jnp.asarray(u_lens),
                                True)
    alpha_ref = np.asarray(res[3])[:b, :, :u + 1]
    g = np.random.default_rng(1).uniform(0.5, 2.0, b).astype(np.float32)
    gb_ref, gl_ref, _ = _rnnt_bwd(True, res, jnp.asarray(g))

    args = tuple(torch.from_numpy(x) for x in (blank, label, u_lens))
    before = dict(LAUNCHES)
    alpha, ll = rnnt_alpha(*args)
    gb, gl = rnnt_beta_grad(*args, alpha, ll, torch.from_numpy(g))
    assert LAUNCHES == before  # CPU tensors: the plain versions only
    live = alpha_ref > NEG / 2  # reachable cells; the rest sit at about -1e30 on both sides
    np.testing.assert_array_equal(alpha.numpy() > NEG / 2, live)
    np.testing.assert_allclose(alpha.numpy()[live], alpha_ref[live], rtol=VALUE_TOL,
                               atol=VALUE_TOL)
    np.testing.assert_allclose(ll.numpy(), np.asarray(ll_ref), rtol=VALUE_TOL, atol=VALUE_TOL)
    np.testing.assert_allclose(gb.numpy(), np.asarray(gb_ref), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(gl.numpy(), np.asarray(gl_ref), rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert float(ll[1]) < NEG / 2  # no frames, some labels: infeasible


def test_lattice_function_backward_is_beta_grad():
    blank, label, _, u_lens = _lattice_inputs(4, 7, 3, seed=2)
    b_t, l_t = (torch.from_numpy(x).requires_grad_() for x in (blank, label))
    ul = torch.from_numpy(u_lens)
    g = torch.tensor([1.0, 0.0, 0.5, 2.0])
    rnnt_lattice(b_t, l_t, ul).backward(g)
    alpha, ll = rnnt_alpha(b_t.detach(), l_t.detach(), ul)
    gb, gl = rnnt_beta_grad(b_t.detach(), l_t.detach(), ul, alpha, ll, g)
    assert torch.equal(b_t.grad, gb) and torch.equal(l_t.grad, gl)


def test_materialized_loss_matches_jax_pallas():
    b, t, u, v, blank = 4, 11, 5, 13, 3
    r = np.random.default_rng(7)
    logits = r.standard_normal((b, t, u + 1, v)).astype(np.float32)
    labels = r.integers(0, v, size=(b, u)).astype(np.int32)
    t_lens = np.array([t, 0, 8, 10], np.int32)
    u_lens = np.array([u, 2, 0, 4], np.int32)
    ref, ref_g = jax.value_and_grad(
        lambda z: jax_rnnt_from_logits(z, labels, t_lens, u_lens, blank, "mean",
                                       use_pallas=True))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_()
    loss = rnnt_loss_from_logits(z, *(torch.from_numpy(x) for x in (labels, t_lens, u_lens)),
                                 blank, "mean")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=VALUE_TOL, atol=VALUE_TOL)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    assert bool((z.grad[1] == 0).all())  # t_len = 0 with labels: infeasible, no gradient
