"""The encoder families' training forward and every gradient == JAX on the
CPU, on the same weights.

The tiny families of tests/test_torch_families.py (4 blocks, d32, 2 heads,
FFN 64, conv 7; squeezeformer with its reduce/recover pair at 1/3,
efficient conformer with its stride at 1 and groups of 2), causal, static
chunk 4, no dropout, through each RNN-T loss route: the fused joint loss
(JAX: the Pallas kernel in interpret mode; the port: its autograd Function
on the plain versions) and the materialized one (full logits and the
lattice). Losses atol 1e-4; every gradient leaf within 1e-4 of its max
|g| + 1e-6, as tests/test_torch_train_routes.py holds the flagship.

With dropout, the squeezeformer drops attention probabilities at the
encoder's rate (its attention is built with `dropout_rate`, tpuasr/nn/
squeezeformer.py:169-171), drawn from the dropout generator; and
`gradient_checkpointing` recomputes each family block with its draws
replayed, so the loss and every gradient are those without it.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import batch, build, jax_cfg, port_cfg
from tpuasr_torch.convert import convert_params
from tpuasr_torch.models import Transducer, init_weights
from tpuasr_torch.ops import LAUNCHES

torch.set_num_threads(1)  # six test workers share the cores

LOSS_ATOL, GRAD_REL = 1e-4, 1e-4

FAMILIES = {
    "squeezeformer": dict(encoder_type="squeezeformer", attention_heads=2, num_blocks=4,
                          static_chunk_size=4, reduce_idx=(1,), recover_idx=(3,),
                          time_reduction_type="stream"),
    "efficient_conformer": dict(encoder_type="efficient_conformer", attention_heads=2,
                                num_blocks=4, static_chunk_size=4, stride_layer_idx=(1,),
                                group_size=2),
}


@pytest.mark.parametrize("fused_joint_loss", [True, False])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_training_forward_and_gradients_match_jax(name, fused_joint_loss):
    jm, variables, port = build(jax_cfg(FAMILIES[name], fused_joint_loss=fused_joint_loss))
    feats, lens, texts, tlens = batch()
    loss_fn = lambda p: jm.apply({"params": p}, feats, lens, texts, tlens)
    (_, ref), grads = jax.jit(jax.value_and_grad(lambda p: (loss_fn(p)["loss"], loss_fn(p)),
                                                 has_aux=True))(variables["params"])
    assert port.cfg.fused_joint_loss == fused_joint_loss
    port.train()  # no dropout rate is set: train() needs no generator
    before = dict(LAUNCHES)
    got = port(*(torch.from_numpy(x) for x in (feats, lens, texts, tlens)))
    got["loss"].backward()
    port.eval()
    assert LAUNCHES == before  # CPU tensors: the plain versions only
    assert set(got) == {"loss", "loss_rnnt", "loss_ctc"}
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)
    want = convert_params(jax.tree.map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert want.keys() == named.keys()
    for key, p in named.items():
        g, w = p.grad.numpy(), want[key].numpy()
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()) + 1e-6, (key, err)


def _dropout_model(name: str, remat: bool) -> Transducer:
    mc = port_cfg(jax_cfg(FAMILIES[name]))
    mc.encoder = dataclasses.replace(mc.encoder, dropout_rate=0.1, use_dynamic_chunk=True,
                                     static_chunk_size=0, gradient_checkpointing=remat)
    return init_weights(Transducer(mc, device="cpu"), 7).train()


def _step(model: Transducer):
    feats, lens, texts, tlens = (torch.from_numpy(x) for x in batch())
    out = model(feats, lens, texts, tlens, chunk_gen=torch.Generator().manual_seed(1),
                dropout_gen=torch.Generator().manual_seed(2))
    out["loss"].backward()
    return float(out["loss"].detach()), {k: p.grad.clone() for k, p in model.named_parameters()}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_dropout_and_gradient_checkpointing(name):
    """Training draws dropout (and the squeezeformer's attention dropout) from
    the generator: the loss moves off the eval loss, two runs from the same
    seeds agree, and the recomputing run gives the same loss and gradients."""
    model = _dropout_model(name, remat=False)
    blocks = model.encoder.blocks
    if name == "squeezeformer":
        assert all(b.self_attn.dropout_rate == 0.1 for b in blocks)
    loss, grads = _step(model)
    again = _step(_dropout_model(name, remat=False))
    assert again[0] == loss
    remat_loss, remat_grads = _step(_dropout_model(name, remat=True))
    assert abs(remat_loss - loss) <= 1e-6 * abs(loss)
    for k, g in grads.items():
        assert torch.allclose(remat_grads[k], g, rtol=0, atol=1e-6 * float(g.abs().max()) + 1e-9), k
    model.eval()
    feats, lens, texts, tlens = (torch.from_numpy(x) for x in batch())
    with torch.no_grad():
        assert float(model(feats, lens, texts, tlens)["loss"]) != loss
