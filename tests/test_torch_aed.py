"""The AED workload's model == JAX on the CPU, on converted weights.

The tiny hybrid CTC/attention model of tests/test_asr_model.py (d32, 2
heads, 2 conformer blocks, 2 decoder blocks, FFN 64, vocab 24, no dropout),
with seeded port weights written into the flax layout by the converter's
own index map (so no JAX init is compiled):

- the flax tree of an `ASRModel` with an R2L decoder converts leaf for leaf:
  every flax leaf lands on one port parameter and every port parameter is
  hit once, with unrolled and with scanned encoder blocks (exact);
- the teacher-forced decoder (L2R and R2L) against JAX, and with
  `inputs_embeds` and `causal=False` (the Paraformer entry); the chained
  `forward_one_step` against the teacher-forced log-probs: atol 1e-5 (fp32
  sums in another order);
- `label_smoothing_loss` against JAX and torch's `KLDivLoss`, normalized by
  the batch and by the token count: rtol 1e-6;
- `filter_blank_embedding` (with planted equal maxima), `_reverse_padded`
  and `th_accuracy` against JAX: exact;
- the `ASRModel` loss dict (loss, loss_ctc, loss_att, th_accuracy) and
  every gradient against `jax.grad`, without the R2L decoder, with it, and
  with it and the blank filter: losses atol 1e-5 (th_accuracy exact), every
  gradient leaf within 1e-4 of its max |g| + 1e-7. The key projections'
  biases get no gradient in exact arithmetic (softmax is shift-invariant),
  so theirs is rounding noise on both sides: held within 1e-6 of the
  largest gradient entry instead.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_zoo import flax_variables
from tpuasr.config import EncoderConfig as JaxEncoderConfig
from tpuasr.config import to_dict as jax_to_dict
from tpuasr.models import asr_model as jax_asr
from tpuasr.nn import decoder as jax_decoder
from tpuasr.nn.conformer import stack_layer_params
from tpuasr_torch.config import EncoderConfig, from_dict
from tpuasr_torch.convert import _convert_leaf, convert_params
from tpuasr_torch.models import AEDConfig, ASRModel, init_weights
from tpuasr_torch.models import asr_model as port_asr
from tpuasr_torch.nn.decoder import TransformerDecoder, label_smoothing_loss

torch.set_num_threads(1)  # six test workers share the cores

V = 24
ENC = dict(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
           cnn_module_kernel=7, dropout_rate=0.0, positional_dropout_rate=0.0)


def jax_cfg(**kw) -> jax_asr.AEDConfig:
    return jax_asr.AEDConfig(vocab_size=V, encoder=JaxEncoderConfig(**ENC), decoder_blocks=2,
                             decoder_heads=2, decoder_ffn=64, **kw)


def port_cfg(jc: jax_asr.AEDConfig) -> AEDConfig:
    kw = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name != "encoder"}
    return AEDConfig(**kw, encoder=from_dict(EncoderConfig, jax_to_dict(jc.encoder)))


def batch():
    """2 utterances (67 and 50 frames, the short one zero-padded), 5 and 3
    labels."""
    r = np.random.default_rng(7)
    feats = r.standard_normal((2, 67, 80)).astype(np.float32)
    feats[1, 50:] = 0.0
    texts = r.integers(6, V, (2, 5)).astype(np.int32)
    return feats, np.array([67, 50], np.int32), texts, np.array([5, 3], np.int32)


def flax_template(jm):
    """The flax parameter tree's shapes (traced, not compiled)."""
    return jax.eval_shape(jm.init, jax.random.PRNGKey(0), *batch())["params"]


def flax_params(jm, port) -> dict:
    """The port's weights in `jm`'s flax layout: each leaf through the
    converter's own index map, inverted."""
    return flax_variables(jm, port, *batch())


def port_model(jc, seed: int = 3) -> ASRModel:
    return init_weights(ASRModel(port_cfg(jc), device="cpu"), seed)


@pytest.fixture(scope="module")
def aed():
    """(JAX config, JAX model, flax params, port model) with an R2L decoder."""
    jc = jax_cfg(r_decoder_blocks=2, reverse_weight=0.3)
    jm = jax_asr.ASRModel(jc)
    port = port_model(jc)
    return jc, jm, flax_params(jm, port), port


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("layout", ["unrolled", "scanned"])
def test_every_flax_leaf_converts_once(aed, layout):
    jc, jm, params, port = aed
    tree = params["params"]
    if layout == "scanned":
        scanned = jax_asr.ASRModel(dataclasses.replace(
            jc, encoder=dataclasses.replace(jc.encoder, scan_layers=True)))
        want = jax.tree.map(lambda s: s.shape, flax_template(scanned))
        tree = dict(tree, encoder=jax.tree.map(np.asarray, stack_layer_params(
            tree["encoder"], jc.encoder.num_blocks)))
        assert jax.tree.map(np.shape, tree) == want
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    n_blocks = jc.encoder.num_blocks
    keys = []
    for path, x in leaves:
        names = tuple(p.key for p in path)
        if names[:3] == ("encoder", "layers", "block"):
            keys += [_convert_leaf(("encoder", f"block{i}") + names[3:], x[i])[0]
                     for i in range(n_blocks)]
        else:
            keys.append(_convert_leaf(names, x)[0])
    sd = port.state_dict()
    assert len(keys) == len(set(keys)) and set(keys) == set(sd)
    got = convert_params({"params": tree})
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    assert any(k.startswith("r_decoder.layers.1.src_attn") for k in sd)


@pytest.mark.parametrize("which", ["decoder", "r_decoder", "inputs_embeds"])
def test_decoder_matches_jax_and_one_step(aed, which):
    jc, jm, params, port = aed
    r = np.random.default_rng(11)
    memory = r.standard_normal((2, 15, 32)).astype(np.float32)
    mem_lens = np.array([15, 9], np.int32)
    ys_in = r.integers(0, V, (2, 6)).astype(np.int32)
    ys_lens = np.array([6, 4], np.int32)
    dec = getattr(port, "decoder" if which == "inputs_embeds" else which)
    jdec = jax_decoder.TransformerDecoder(V, 32, 2, 64, 2, 0.0)
    jp = {"params": params["params"]["decoder" if which == "inputs_embeds" else which]}
    valid = np.arange(6)[None, :] < ys_lens[:, None]
    if which == "inputs_embeds":
        emb = r.standard_normal((2, 6, 32)).astype(np.float32)
        want = jdec.apply(jp, memory, mem_lens, None, ys_lens, inputs_embeds=emb, causal=False)
        with torch.no_grad():
            got = dec(*_t(memory, mem_lens), None, *_t(ys_lens), inputs_embeds=_t(emb)[0],
                      causal=False)
        np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=0,
                                   atol=1e-5)
        return
    want = jdec.apply(jp, memory, mem_lens, ys_in, ys_lens)
    with torch.no_grad():
        got = dec(*_t(memory, mem_lens, ys_in, ys_lens))
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], rtol=0, atol=1e-5)

    # the one-step surface, chained, against the teacher-forced log-probs
    full_lp = torch.log_softmax(got, dim=-1)
    mem = _t(memory)[0]
    with torch.no_grad():
        mem_k, mem_v = dec.project_memory(mem)
        kc, vc = dec.init_ar_cache(2, 8)
        mask = (torch.arange(15)[None, :] < torch.from_numpy(mem_lens)[:, None])[:, None, :]
        for pos in range(6):
            lp, kc, vc = dec.forward_one_step(torch.from_numpy(ys_in[:, pos]), pos, kc, vc,
                                              mem_k, mem_v, mask)
            rows = valid[:, pos]  # a padded query row attends to fewer keys
            np.testing.assert_allclose(lp.numpy()[rows], full_lp[:, pos].numpy()[rows], rtol=0,
                                       atol=1e-5)
    assert int((kc[:, :, 6:] != 0).sum()) == 0  # positions past the steps stay untouched


@pytest.mark.parametrize("normalize_length", [False, True])
def test_label_smoothing_loss_matches_jax_and_kldiv(normalize_length):
    r = np.random.default_rng(5)
    b, l, v = 3, 6, 10
    logits = r.standard_normal((b, l, v)).astype(np.float32)
    targets = r.integers(0, v, (b, l)).astype(np.int32)
    lengths = np.array([6, 4, 1], np.int32)
    want = float(jax_decoder.label_smoothing_loss(jnp.asarray(logits), targets, lengths, 0.1,
                                                  normalize_length))
    got = float(label_smoothing_loss(*_t(logits, targets, lengths), 0.1, normalize_length))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    lp = torch.log_softmax(torch.from_numpy(logits), dim=-1)
    true = torch.full((b, l, v), 0.1 / (v - 1))
    true.scatter_(2, torch.from_numpy(targets)[..., None].long(), 0.9)
    kl = torch.nn.KLDivLoss(reduction="none")(lp, true).sum(-1)
    mask = torch.arange(l)[None, :] < torch.from_numpy(lengths)[:, None]
    ref = float((kl * mask).sum() / (lengths.sum() if normalize_length else b))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("fn", ["filter_blank_embedding", "reverse_padded", "th_accuracy"])
def test_helpers_match_jax(fn):
    r = np.random.default_rng(9)
    if fn == "filter_blank_embedding":
        b, t, d, blank = 3, 11, 4, 5
        scores = r.standard_normal((b, t, 7)).astype(np.float32)
        scores[0, 2, [1, blank]] = 9.0  # equal maxima: the first (non-blank) wins
        scores[1, 3, [blank, 6]] = 9.0  # the blank first: dropped
        args = (scores, r.standard_normal((b, t, d)).astype(np.float32),
                np.array([11, 8, 5], np.int32), blank)
        want = jax_asr.filter_blank_embedding(*(jnp.asarray(a) for a in args[:3]), blank)
        got = port_asr.filter_blank_embedding(*_t(*args[:3]), blank)
        assert 0 < int(got[1].min()) and int(got[1].max()) < 11
    elif fn == "reverse_padded":
        tokens = r.integers(1, 20, (3, 6)).astype(np.int32)
        lens = np.array([3, 6, 0], np.int32)
        want = jax_asr._reverse_padded(jnp.asarray(tokens), jnp.asarray(lens))
        got = port_asr._reverse_padded(*_t(tokens, lens))
        assert got[0].tolist() == tokens[0, [2, 1, 0, 3, 4, 5]].tolist()
    else:
        logits = r.standard_normal((3, 5, 4)).astype(np.float32)
        targets = logits.argmax(-1).astype(np.int32)
        targets[:, ::2] = r.integers(0, 4, (3, 3))
        lens = np.array([5, 2, 0], np.int32)
        want = jax_asr.th_accuracy(jnp.asarray(logits), targets, lens)
        got = port_asr.th_accuracy(*_t(logits, targets, lens))
    for x, y in zip(*((w,) if not isinstance(w, tuple) else w for w in (got, want))):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("variant", ["no_r2l", "r2l", "r2l_blank_filter"])
def test_loss_dict_and_every_gradient_match_jax(aed, variant):
    jc, _, params, full = aed
    tree = params["params"]
    if variant == "no_r2l":
        jc = dataclasses.replace(jc, r_decoder_blocks=0)
        tree = {k: v for k, v in tree.items() if k != "r_decoder"}
    jc = dataclasses.replace(jc, apply_non_blank_embedding=variant == "r2l_blank_filter")
    jm = jax_asr.ASRModel(jc)
    port = port_model(jc)
    port.load_state_dict({k: v for k, v in full.state_dict().items()
                          if k in port.state_dict()})
    data = batch()

    def loss_fn(p):
        out = jm.apply({"params": p}, *data)
        return out["loss"], out

    (_, ref), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(tree)
    out = port(*_t(*data))
    out["loss"].backward()
    assert set(out) == set(ref) == {"loss", "loss_ctc", "loss_att", "th_accuracy"}
    for k in ("loss", "loss_ctc", "loss_att"):
        np.testing.assert_allclose(float(out[k].detach()), float(ref[k]), rtol=0, atol=1e-5,
                                   err_msg=k)
    assert float(out["th_accuracy"]) == float(ref["th_accuracy"])
    want = convert_params(jax.tree.map(np.asarray, grads))
    got = dict(port.named_parameters())
    assert want.keys() == got.keys()
    scale = max(float(w.abs().max()) for w in want.values())
    for name, p in got.items():
        g, w = p.grad.numpy(), want[name].numpy()
        err = float(np.abs(g - w).max())
        if name.endswith("linear_k.bias"):  # shift-free: rounding noise
            assert err <= 1e-6 * scale, (name, err, scale)
        else:
            assert err <= 1e-4 * float(np.abs(w).max()) + 1e-7, (name, err)
    if variant == "r2l_blank_filter":  # the filter kept some frames and dropped others
        with torch.no_grad():
            enc, lens = port.encode(*_t(*data[:2]))
            _, kept = port_asr.filter_blank_embedding(port.ctc_logits(enc), enc, lens,
                                                      jc.blank_id)
        assert 0 < int(kept.min()) and bool((kept < lens).any())
