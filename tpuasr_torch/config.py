"""Configuration tree for the PyTorch port.

An own copy of the parts of ``tpuasr/config.py``'s dataclasses that the
serving path reads or checks (features, model, streaming), with the same
field names and defaults, so a ``train.yaml`` written by the JAX package
loads here unchanged: `from_dict` drops every key this copy does not hold
(training and loss settings, dropouts, TPU kernel switches, the scanned
parameter layout, which `tpuasr_torch.convert` detects by itself, and the
options of encoder and predictor families the port does not build, which
their `*_type` fields already refuse).

The JAX package's ``adapt_to_backend`` is not copied: it strips TPU-only
settings off the TPU, while the port runs its kernels whenever a tensor lies
on the card and their plain versions whenever it lies on the CPU.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any


@dataclass
class FeatureConfig:
    """Log-mel fbank settings (reference: data/dataloader.py:15-41)."""

    sample_rate: int = 48000
    n_fft: int = 1024
    hop_length: int = 512
    win_length: int = 1024
    n_mels: int = 80
    window: str = "hamming"  # periodic hamming, torch.hamming_window parity
    power: float = 2.0
    center: bool = True  # reflect-pad n_fft//2 on both sides
    amin: float = 1e-10  # AmplitudeToDB clamp
    # product precision of the DFT/mel products: "highest" = exact fp32;
    # "default" = operands rounded to bf16, fp32 accumulation (what the TPU's
    # single bf16 pass computes). The JAX package's TPU training config sets
    # "default" and persists it in train.yaml, so eval uses the same features
    # as training.
    fbank_precision: str = "highest"


@dataclass
class EncoderConfig:
    """Conformer encoder (reference: model/rnnt_model.py:90-109,
    model/online_rnnt_model.py:85-107, wenet/transformer/encoder.py:437-551).

    The port builds the conformer/rel_pos/conv2d/layer_norm/swish subset and
    raises NotImplementedError for the rest (`check_supported`)."""

    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 1024
    num_blocks: int = 12
    attention_dropout_rate: float = 0.0  # must be 0: a training feature
    input_layer: str = "conv2d"  # linear | conv2d | conv2d6 | conv2d8
    pos_enc_layer_type: str = "rel_pos"
    attention_type: str = ""  # "" derives from pos_enc_layer_type
    n_kv_head: int = 0  # 0 or attention_heads: no grouped K/V heads yet
    normalize_before: bool = True
    macaron_style: bool = True
    use_cnn_module: bool = True
    cnn_module_kernel: int = 31
    cnn_module_norm: str = "layer_norm"
    causal: bool = False
    activation_type: str = "swish"
    static_chunk_size: int = 0
    use_dynamic_chunk: bool = False
    max_len: int = 5000  # positional-encoding table length
    mlp_type: str = "position_wise_feed_forward"
    encoder_type: str = "conformer"


@dataclass
class PredictorConfig:
    """Label predictor (reference: model/component/predictor.py:11-98)."""

    predictor_type: str = "rnn"  # rnn | embedding | conv
    embed_size: int = 256
    hidden_size: int = 256
    output_size: int = 256
    num_layers: int = 1


@dataclass
class JointConfig:
    """Additive joint network (reference: model/component/joint.py:7-69)."""

    join_dim: int = 256
    prejoin_linear: bool = True
    postjoin_linear: bool = False
    joint_mode: str = "add"
    activation: str = "tanh"
    hat_joint: bool = False


@dataclass
class ModelConfig:
    vocab_size: int = 412  # 406 pinyin syllables + 6 specials
    blank_id: int = 5
    # computation dtype of matmuls/activations (parameters stay float32;
    # layer norms and softmaxes compute their statistics in float32)
    compute_dtype: str = "float32"
    ctc_weight: float = 0.3  # > 0 builds the CTC head
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    joint: JointConfig = field(default_factory=JointConfig)


@dataclass
class StreamingConfig:
    """Chunk streaming (reference: rnnt_common.py:16-18,
    model/online_rnnt_model.py:274-344)."""

    chunk_size: int = 32  # encoder frames per chunk
    num_left_chunks: int = 6
    n_steps: int = 10  # max non-blank emissions per frame


@dataclass
class Config:
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    streaming: StreamingConfig = field(default_factory=StreamingConfig)


# ---------------------------------------------------------------------------
# dict / yaml / override plumbing
# ---------------------------------------------------------------------------

def to_dict(cfg: Any) -> Any:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


def from_dict(cls, d: dict):
    """Build a dataclass tree from a (possibly partial) nested dict; keys
    that `cls` has no field for are ignored."""
    kwargs = {}
    for f in fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = _resolve_type(cls, f.name)
        if dataclasses.is_dataclass(sub):
            kwargs[f.name] = from_dict(sub, v)
        else:
            kwargs[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kwargs)


def _resolve_type(cls, name):
    for f in fields(cls):
        if f.name == name:
            default = (f.default_factory() if f.default_factory is not dataclasses.MISSING
                       else f.default)
            return type(default)
    raise KeyError(name)


def override(cfg: Config, overrides: dict[str, Any]) -> Config:
    """Apply dotted-path overrides, e.g. {"model.encoder.num_blocks": 6}."""
    d = to_dict(cfg)
    for path, value in overrides.items():
        node = d
        *parents, leaf = path.split(".")
        for p in parents:
            node = node[p]
        if leaf not in node:
            raise KeyError(f"unknown config key: {path}")
        node[leaf] = value
    return from_dict(Config, d)


def flatten(d: dict, prefix: str = "") -> dict[str, Any]:
    """Nested dict -> dotted-path leaves, the `override()` input format."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return from_dict(Config, d)


def save_yaml(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
