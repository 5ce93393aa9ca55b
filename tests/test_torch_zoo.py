"""The port's encoder options == JAX on the CPU, on the same weights.

At the JAX zoo tests' size (tests/test_attention_zoo.py: 2 causal blocks,
d32, 4 heads, FFN 64, conv 7, vocab 20, blank 5), the port's seeded weights
written into the flax layout through the converter's own index map (so no
JAX init is compiled), fp32:

- `encode` (chunk-masked, chunk 4 and 2 left chunks; FireRed full context)
  for each attention x positional encoding of the JAX zoo tests, FireRed,
  and the whisper and learnable absolute tables: outputs atol 1e-5,
  lengths identical. Two blocks of fp32 sums in another order: the largest
  difference seen is 2.5e-6.
- `forward_chunk`, chunk by chunk, for the streamable ones: outputs and the
  att_k / att_v / cnn caches atol 1e-5; GQA caches K/V at `n_kv_head` heads;
  FireRed's `forward_chunk` raises.
- The block's options: the gated and MoE FFNs, relu and gelu, the block
  without its macaron FFN or its conv module, the conv module's rms and
  batch norms (batch norm in evaluation from converted `batch_stats`,
  drawn from a seed, not 0/1); a training forward with batch norm raises,
  as the JAX package cannot train it. The MoE router's ties go to the lower
  expert, as `jax.lax.top_k`.
- The front ends (linear, conv1d2, stack2, conv2d_firered): output,
  `output_len` and `subsampled_mask` against the JAX modules.
- `check_supported` raises for what stays unported, with its reason, and
  passes the encoder families, which build their own encoders.
- The converter lands every flax leaf once, `batch_stats` included, the
  encoder families' too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuasr.config import EncoderConfig as JaxEncoderConfig
from tpuasr.config import JointConfig as JaxJointConfig
from tpuasr.config import ModelConfig as JaxModelConfig
from tpuasr.config import PredictorConfig as JaxPredictorConfig
from tpuasr.config import to_dict
from tpuasr.models import Transducer as JaxTransducer
from tpuasr.nn import conformer as jax_conformer
from tpuasr.nn import subsampling as jax_sub
from tpuasr.streaming.chunkwise import chunk_windows as jax_chunk_windows
from tpuasr_torch.config import ModelConfig, from_dict
from tpuasr_torch.convert import _convert_leaf, convert_params, load_jax_params
from tpuasr_torch.models import Transducer, init_weights
from tpuasr_torch.nn import subsampling as port_sub
from tpuasr_torch.models.transducer import build_encoder
from tpuasr_torch.nn.conformer import MoEFFNLayer, check_supported
from tpuasr_torch.nn.efficient_conformer import EfficientConformerEncoder
from tpuasr_torch.nn.squeezeformer import SqueezeformerEncoder
from tpuasr_torch.streaming import chunk_windows, num_chunks

torch.set_num_threads(1)  # six test workers share the cores

V, BLANK, CHUNK, LEFT = 20, 5, 4, 2
ATOL = 1e-5


def jax_cfg(encoder=None, predictor=None, joint=None, **model) -> JaxModelConfig:
    enc = dict(output_size=32, attention_heads=4, linear_units=64, num_blocks=2,
               cnn_module_kernel=7, dropout_rate=0.0, positional_dropout_rate=0.0,
               causal=True)
    enc.update(encoder or {})
    pred = dict(embed_size=16, hidden_size=16, output_size=32)
    pred.update(predictor or {})
    return JaxModelConfig(vocab_size=V, blank_id=BLANK, ctc_dropout_rate=0.0,
                          encoder=JaxEncoderConfig(**enc),
                          predictor=JaxPredictorConfig(**pred),
                          joint=JaxJointConfig(**dict(dict(join_dim=32), **(joint or {}))),
                          **model)


def batch():
    """2 utterances (67 and 51 frames), 5 and 3 labels."""
    r = np.random.default_rng(0)
    feats = r.standard_normal((2, 67, 80)).astype(np.float32)
    texts = r.integers(6, V, (2, 5)).astype(np.int32)
    return feats, np.array([67, 51], np.int32), texts, np.array([5, 3], np.int32)


def flax_variables(module, port: torch.nn.Module, *args) -> dict:
    """The port module's weights (and buffers) in the flax layout of
    `module.init(key, *args)`, every collection: each leaf through the
    converter's own index map, inverted."""
    sd = port.state_dict()
    template = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            key, idx = _convert_leaf(path + (k,), np.arange(np.prod(v.shape)).reshape(v.shape))
            y = np.empty(int(np.prod(v.shape)), np.float32)
            y[np.asarray(idx).ravel()] = sd[key].numpy().ravel()
            out[k] = y.reshape(v.shape)
        return out

    return {col: walk(tree, ()) for col, tree in template.items()}


def port_cfg(jc: JaxModelConfig) -> ModelConfig:
    return from_dict(ModelConfig, to_dict(jc))


def build(jc: JaxModelConfig, seed: int = 3, blank_bias: float = 0.0):
    """(JAX model, flax variables, port model): the port's seeded weights
    (batch norms' running statistics drawn from the seed too; the plain
    joint's blank logit at `blank_bias`) in both."""
    port = init_weights(Transducer(port_cfg(jc), device="cpu"), seed)
    r = np.random.default_rng(seed)
    with torch.no_grad():
        for name, buf in port.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(torch.from_numpy(r.normal(0.0, 0.3, buf.shape).astype(np.float32)))
            elif name.endswith(".var"):
                buf.copy_(torch.from_numpy(r.uniform(0.5, 2.0, buf.shape).astype(np.float32)))
        if hasattr(port.joint, "ffn_out_bias"):
            port.joint.ffn_out_bias[BLANK] = blank_bias
    jm = JaxTransducer(jc)
    feats, lens, texts, tlens = batch()
    return jm, flax_variables(jm, port, feats[:, :32], np.full((2,), 32, np.int32),
                              texts[:, :2], np.full((2,), 2, np.int32)), port


ENCODERS = {  # tests/test_attention_zoo.py:58-64, FireRed, the absolute tables
    "rope": dict(attention_type="rope", pos_enc_layer_type="no_pos"),
    "rope_gqa": dict(attention_type="rope", n_kv_head=2, pos_enc_layer_type="no_pos"),
    "shaw": dict(attention_type="shaw_rel_pos", pos_enc_layer_type="no_pos"),
    "mqa": dict(attention_type="mha", n_kv_head=1, pos_enc_layer_type="abs_pos"),
    "gqa": dict(attention_type="mha", n_kv_head=2, pos_enc_layer_type="abs_pos"),
    "whisper": dict(attention_type="mha", pos_enc_layer_type="abs_pos_whisper"),
    "learnable": dict(attention_type="mha", pos_enc_layer_type="abs_pos_learnable"),
    "firered": dict(encoder_type="firered", causal=False),
}
BLOCKS = {  # the block's options, on the rel-pos flagship block
    "gated": dict(mlp_type="gated"),
    "moe": dict(mlp_type="moe", n_expert=4, n_expert_activated=2),
    "relu": dict(activation_type="relu"),
    "gelu": dict(activation_type="gelu"),
    "no_macaron": dict(macaron_style=False),
    "no_cnn": dict(use_cnn_module=False),
    "rms_norm": dict(cnn_module_norm="rms_norm"),
    "batch_norm": dict(cnn_module_norm="batch_norm"),
}
CASES = dict(ENCODERS, **BLOCKS)
_BUILT = {}


def case(name):
    if name not in _BUILT:
        _BUILT[name] = build(jax_cfg(CASES[name]))
    return _BUILT[name]


@pytest.mark.parametrize("name", list(CASES))
def test_encode_matches_jax(name):
    jm, params, port = case(name)
    feats, lens, _, _ = batch()
    chunk = -1 if name == "firered" else CHUNK
    ref, ref_lens = jm.apply(params, feats, lens, decoding_chunk_size=chunk,
                             num_decoding_left_chunks=LEFT, method="encode")
    got, got_lens = port.encode(torch.from_numpy(feats), torch.from_numpy(lens), chunk, LEFT)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=ATOL)


# each attention's cache, one absolute table, and the block options with a
# state of their own (MoE's routing, batch norm's statistics)
STREAMED = ["rope", "rope_gqa", "shaw", "mqa", "learnable", "moe", "batch_norm"]


@pytest.mark.parametrize("name", STREAMED)
def test_forward_chunk_matches_jax(name):
    """Three chunks of one stream: outputs and caches, the offset."""
    jm, params, port = case(name)
    x = batch()[0][:1, :51]
    n = num_chunks(x.shape[1], CHUNK, 4, 6)
    jw = np.asarray(jax_chunk_windows(x, CHUNK, 4, 6, n))
    pw = chunk_windows(torch.from_numpy(x), CHUNK, 4, 6, n)
    jstate = jm.apply(params, 1, CHUNK, LEFT, method="init_encoder_state")
    pstate = port.init_encoder_state(1, CHUNK, LEFT)
    assert n == 3 and pstate.att_k.shape == jstate.att_k.shape
    for i in range(n):
        ry, jstate = jm.apply(params, jw[i], jstate, method="encode_chunk")
        gy, pstate = port.encode_chunk(pw[i], pstate)
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry), rtol=0, atol=ATOL)
        for leaf in ("att_k", "att_v", "cnn"):
            np.testing.assert_allclose(getattr(pstate, leaf).numpy(),
                                       np.asarray(getattr(jstate, leaf)), rtol=0, atol=ATOL)
        assert pstate.offset == int(jstate.offset)


@pytest.mark.parametrize("name,heads", [("rope_gqa", 2), ("mqa", 1), ("shaw", 4)])
def test_stream_state_keeps_kv_heads(name, heads):
    _, _, port = case(name)
    assert port.init_encoder_state(3, CHUNK, LEFT).att_k.shape == (2, 3, CHUNK * LEFT, heads, 8)
    assert port.encoder.blocks[0].self_attn.linear_k.weight.shape == (heads * 8, 32)


def test_firered_forward_chunk_raises():
    _, _, port = case("firered")
    state = port.init_encoder_state(1, CHUNK, LEFT)
    with pytest.raises(NotImplementedError, match="full-context only"):
        port.encode_chunk(torch.zeros((1, 19, 80)), state)


def test_batch_norm_trains_nowhere():
    """A training forward with batch norm raises (the JAX package cannot
    train it: its batch_stats are immutable in every apply); evaluation
    reads the converted running statistics."""
    jm, params, port = case("batch_norm")
    assert set(params) == {"params", "batch_stats"}
    norm = port.encoder.blocks[1].conv_module.norm
    assert float(norm.var.min()) >= 0.5 and float(norm.mean.abs().max()) > 0.1
    feats, lens, texts, tlens = (torch.from_numpy(x) for x in batch())
    port.train()
    try:
        with pytest.raises(NotImplementedError, match="JAX package cannot train"):
            port(feats, lens, texts, tlens)
    finally:
        port.eval()
    with pytest.raises(Exception, match="batch_stats"):  # the JAX package's own refusal
        jm.apply(params, *batch(), deterministic=False, rngs={"dropout": jax.random.PRNGKey(0)})


def test_moe_ties_go_to_the_lower_expert():
    """Router logits with exact ties (experts 1 and 3 share a gate row, 0
    and 2 are zero): the port's top-k picks as jax.lax.top_k does."""
    mod = MoEFFNLayer(8, 16, n_expert=4, n_expert_activated=2)
    init_weights(mod, 5)
    with torch.no_grad():
        mod.gate.weight[0] = 0.0
        mod.gate.weight[2] = 0.0
        mod.gate.weight[3] = mod.gate.weight[1]
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 5, 8)).astype(np.float32))
    jmod = jax_conformer.MoEFFNLayer(16, 8, 0.0, n_expert=4, n_expert_activated=2)
    variables = flax_variables(jmod, mod, x.numpy())
    ref = jmod.apply(variables, x.numpy())
    np.testing.assert_allclose(mod(x).detach().numpy(), np.asarray(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("layer", ["linear", "conv1d2", "stack2", "conv2d_firered"])
def test_front_end_matches_jax(layer):
    """Output, output_len and the subsampled mask of each front end."""
    mod = init_weights(port_sub.SUBSAMPLE_CLASSES[layer](80, 32), 4)
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 45, 80)).astype(np.float32)
    jmod = jax_sub.SUBSAMPLE_CLASSES[layer](32)
    ref = np.asarray(jmod.apply(flax_variables(jmod, mod, x), x))
    got = mod(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)
    cls = port_sub.SUBSAMPLE_CLASSES[layer]
    assert (cls.subsampling_rate, cls.right_context) == (jmod.subsampling_rate,
                                                         jmod.right_context)
    t = np.arange(30, 47)
    np.testing.assert_array_equal(port_sub.subsampled_len(layer, torch.from_numpy(t)).numpy(),
                                  np.asarray(jax_sub.subsampled_len(layer, jnp.asarray(t))))
    assert ref.shape[1] == jax_sub.subsampled_len(layer, 45)
    mask = np.arange(45)[None, None, :] < np.array([45, 30])[:, None, None]
    np.testing.assert_array_equal(
        port_sub.subsampled_mask(torch.from_numpy(mask), layer).numpy(),
        np.asarray(jax_sub.subsampled_mask(jnp.asarray(mask), layer)))


@pytest.mark.parametrize("field,value,reason", [
    ("encoder_type", "squeezeformer", "encoder families"),
    ("encoder_type", "efficient_conformer", "encoder families"),
    ("normalize_before", False, "ignores the field"),
])
def test_check_supported_names_why(field, value, reason):
    """What stays unported raises with its reason; the encoder families,
    refused until they were ported, pass the check and build their own
    encoder."""
    enc = dataclasses.replace(port_cfg(jax_cfg()).encoder, **{field: value})
    if reason == "encoder families":
        check_supported(enc)
        built = build_encoder(enc, torch.float32, "cpu")
        assert type(built) is {"squeezeformer": SqueezeformerEncoder,
                               "efficient_conformer": EfficientConformerEncoder}[value]
        return
    with pytest.raises(NotImplementedError, match=reason):
        check_supported(enc)


SINKS = {  # every leaf kind of the converter
    "shaw_learnable_moe_batchnorm_conv_hat": jax_cfg(
        dict(attention_type="shaw_rel_pos", pos_enc_layer_type="abs_pos_learnable",
             mlp_type="moe", n_expert=4, cnn_module_norm="batch_norm"),
        dict(predictor_type="conv", embed_size=32), dict(hat_joint=True, postjoin_linear=True)),
    "firered_gated_rms_embedding_noprejoin": jax_cfg(
        dict(encoder_type="firered", causal=False, mlp_type="gated", cnn_module_norm="rms_norm",
             input_layer="conv2d"),
        dict(predictor_type="embedding", embed_size=32), dict(prejoin_linear=False)),
    # the encoder families: squeezeformer's depthwise front end, adaptive
    # scales (flax `scale` -> `weight`), time reduction and recovery; the
    # efficient conformer's grouped [H, g*dk] u/v biases and strided conv
    "squeezeformer": jax_cfg(dict(encoder_type="squeezeformer", num_blocks=4, reduce_idx=(1,),
                                  recover_idx=(3,), time_reduction_type="stream")),
    "efficient_conformer": jax_cfg(dict(encoder_type="efficient_conformer", num_blocks=4,
                                        stride_layer_idx=(1,), group_size=2)),
}
# the JAX families never scan their layers (tpuasr/config.py:116-119)
LAYOUTS = [(sink, layout) for sink in SINKS for layout in ("unrolled", "scanned")
           if layout == "unrolled" or SINKS[sink].encoder.encoder_type in ("conformer", "firered")]


@pytest.mark.parametrize("sink,layout", LAYOUTS, ids=[f"{s}-{l}" for s, l in LAYOUTS])
def test_every_flax_leaf_converts_once(sink, layout):
    """Each leaf of every collection (params and batch_stats, unrolled or
    scanned) lands on one port parameter or buffer, and every one is
    landed; strict loading takes them."""
    jc = SINKS[sink]
    jm, variables, port = build(jc)
    if layout == "scanned":
        variables = {col: dict(tree, encoder=jax.tree.map(np.asarray, jax_conformer.
                                                          stack_layer_params(tree["encoder"], 2)))
                     for col, tree in variables.items()}
    keys = []
    for col, tree in variables.items():
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            names = tuple(p.key for p in path)
            if names[:3] == ("encoder", "layers", "block"):
                keys += [_convert_leaf(("encoder", f"block{i}") + names[3:], x[i])[0]
                         for i in range(2)]
            else:
                keys.append(_convert_leaf(names, x)[0])
    sd = port.state_dict()
    assert len(keys) == len(set(keys)) and set(keys) == set(sd)
    got = convert_params(variables)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    load_jax_params(Transducer(port_cfg(jc), device="cpu"), variables)
