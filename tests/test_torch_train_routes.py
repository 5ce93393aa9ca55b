"""The training forward and every gradient == JAX on the CPU, with the
rel-pos attention kernels' route (`fused_attention=True`: in JAX the Pallas
kernels in interpret mode, in the port the autograd Function with its plain
forward and backward) and each RNN-T loss route: fused joint
(`fused_joint_loss=True`, bench.py's configuration) and materialized
(`fused_joint_loss=False`, the JAX default: full logits and the lattice).

The tiny flagship of tests/test_torch_train.py (2 causal conformer blocks,
d32, scanned JAX layout), no dropout, static chunk 4. Tolerances as there:
losses atol 1e-4; every gradient leaf within 1e-4 of its max |g| + 1e-6
(fp32 sums in another order through two blocks and the lattice).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.config import to_dict
from tpuasr.models import Transducer as JaxTransducer
from tpuasr_torch.config import ModelConfig, from_dict
from tpuasr_torch.convert import convert_params, load_jax_params
from tpuasr_torch.models import Transducer
from tpuasr_torch.ops import LAUNCHES

torch.set_num_threads(1)  # six test workers share the cores

LOSS_ATOL, GRAD_REL = 1e-4, 1e-4


@pytest.mark.parametrize("fused_joint_loss", [True, False])
def test_training_route_matches_jax(fused_joint_loss):
    mc = _flagship_config(tiny=True).model
    mc.fused_joint_loss = fused_joint_loss
    mc.ctc_dropout_rate = 0.0
    mc.encoder = dataclasses.replace(mc.encoder, use_dynamic_chunk=False, static_chunk_size=4,
                                     fused_attention=True)
    r = np.random.default_rng(0)
    feats = r.standard_normal((2, 67, 80)).astype(np.float32)
    feat_lens = np.array([67, 51], np.int32)
    texts = r.integers(6, mc.vocab_size, size=(2, 5)).astype(np.int32)
    text_lens = np.array([5, 3], np.int32)
    model = JaxTransducer(mc)
    params = model.init(jax.random.PRNGKey(0), feats, feat_lens, texts, text_lens)
    loss_fn = lambda p: model.apply({"params": p}, feats, feat_lens, texts, text_lens)
    (_, ref), grads = jax.jit(jax.value_and_grad(lambda p: (loss_fn(p)["loss"], loss_fn(p)),
                                                 has_aux=True))(params["params"])

    port = load_jax_params(Transducer(from_dict(ModelConfig, to_dict(mc)), device="cpu"),
                           jax.tree.map(np.asarray, params))
    assert port.cfg.encoder.fused_attention and port.cfg.fused_joint_loss == fused_joint_loss
    port.train()  # no dropout rate is set: train() needs no generator
    before = dict(LAUNCHES)
    got = port(*(torch.from_numpy(x) for x in (feats, feat_lens, texts, text_lens)))
    got["loss"].backward()
    assert LAUNCHES == before  # CPU tensors: the plain versions only
    assert set(got) == {"loss", "loss_rnnt", "loss_ctc"}
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=0,
                                   atol=LOSS_ATOL, err_msg=k)
    want = convert_params(jax.tree.map(np.asarray, grads))
    named = dict(port.named_parameters())
    assert want.keys() == named.keys()
    for name, p in named.items():
        g, w = p.grad.numpy(), want[name].numpy()
        err = float(np.abs(g - w).max())
        assert err <= GRAD_REL * float(np.abs(w).max()) + 1e-6, (name, err)
