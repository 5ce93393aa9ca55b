"""Configuration tree for the PyTorch port.

An own copy of the parts of ``tpuasr/config.py``'s dataclasses that the
serving and training paths read or check (features, the transducer, the
CTC workload's model and the AED and Paraformer workloads' decoder, SpecAugment,
optimizer, the data pipeline, streaming, the training loop), with the same
field names and defaults, so a ``train.yaml`` written by the JAX package
loads here unchanged: `from_dict` drops every key this copy does not hold
(the JAX-only loop switches such as donation, the RNG implementation and
the host-RSS watchdog, and the scanned parameter layout, which
`tpuasr_torch.convert` detects by itself). The mesh block (`MeshConfig`)
and `model.shard_joint` are held: the parallel layer
(`tpuasr_torch.parallel`) reads them. Values the port does not build
raise NotImplementedError where they are read (`check_supported` in the
encoder, batch-norm training in the conv module).

The JAX package's ``adapt_to_backend`` is not copied: it strips TPU-only
settings off the TPU, while the port runs its kernels whenever a tensor lies
on the card and their plain versions whenever it lies on the CPU. Its one
numeric effect, fp32 compute for a checkpoint's auto-loaded train.yaml off
the TPU, the evaluation CLIs apply on the CPU
(`tpuasr_torch.tools.common.eval_config`).
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

    The port builds every encoder family of the JAX package: the conformer
    and firered with every attention, positional encoding, FFN, conv norm,
    activation and front end, squeezeformer and efficient_conformer with
    their own fields below (the stride of the efficient conformer's strided
    layers is 2, as `tpuasr/models/transducer.py:116` reads it; there is no
    field). It raises NotImplementedError for the rest (`check_supported`)."""

    input_size: int = 80
    output_size: int = 256
    attention_heads: int = 4
    linear_units: int = 1024
    num_blocks: int = 12
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    # dropout on the attention probabilities (the plain route: a rate above
    # 0 takes it even with fused_attention, as the JAX gate does)
    attention_dropout_rate: float = 0.0
    # linear | conv1d2 | stack2 | conv2d | conv2d6 | conv2d8 | conv2d_firered
    input_layer: str = "conv2d"
    # rel_pos | abs_pos | no_pos | abs_pos_whisper | abs_pos_learnable
    pos_enc_layer_type: str = "rel_pos"
    # mha | rel_pos | shaw_rel_pos | rope | firered_rel_pos; "" derives from
    # pos_enc_layer_type (rel_pos -> rel_pos, else mha)
    attention_type: str = ""
    n_kv_head: int = 0  # K/V heads of mha and rope (GQA; 1 = MQA); 0 = attention_heads
    # the full-context (serving and training) attention path: True = the
    # rel-pos attention kernels (`tpuasr_torch.ops.relpos_attention`:
    # forward #2, backward #3), False = the plain formula in torch ops
    # (`relpos_attention_plain`, with autograd); the cached streaming path is
    # plain either way
    fused_attention: bool = False
    # the conformer FFNs: True = the fused FFN kernels
    # (`tpuasr_torch.ops.fused_ffn`: forward #10, backward #11; LN, both
    # products, swish, the dropout keep-masks drawn by the caller and saved
    # for the backward, and the scaled residual), False = the module chain
    fused_ffn: bool = False
    normalize_before: bool = True
    macaron_style: bool = True
    use_cnn_module: bool = True
    cnn_module_kernel: int = 31
    cnn_module_norm: str = "layer_norm"  # layer_norm | rms_norm | batch_norm (eval only)
    causal: bool = False
    activation_type: str = "swish"  # swish | relu | gelu
    static_chunk_size: int = 0
    use_dynamic_chunk: bool = False
    use_dynamic_left_chunk: bool = False
    max_chunk_size: int = 25  # dynamic-chunk cap: 100 frames / subsampling 4
    max_len: int = 5000  # positional-encoding table length
    # recompute each block in the backward (the JAX package's remat), the
    # block's dropout draws and the step's chunk masks replayed
    gradient_checkpointing: bool = False
    # position_wise_feed_forward | gated (gelu-gated) | moe (top-k of n_expert)
    mlp_type: str = "position_wise_feed_forward"
    n_expert: int = 8
    n_expert_activated: int = 2
    # conformer | firered | squeezeformer | efficient_conformer | sanm (the
    # Paraformer's LFR + SANM stack: `tpuasr_torch.models.Paraformer` builds
    # it; a transducer's `build_encoder` refuses it, as the JAX one does)
    encoder_type: str = "conformer"
    # squeezeformer time reduction / recovery layer indices
    reduce_idx: tuple = (5,)
    recover_idx: tuple = (11,)
    # squeezeformer reduction layer: conv (k 5, looks ahead: full context) |
    # stream (k 1, chunk-local: required for cached streaming)
    time_reduction_type: str = "conv"
    # efficient-conformer strided layers + attention group size
    stride_layer_idx: tuple = (3,)
    group_size: int = 3


@dataclass
class PredictorConfig:
    """Label predictor (reference: model/component/predictor.py:11-98 for the
    LSTM; wenet/transducer/predictor.py:213-499 for the stateless embedding
    and causal-conv variants)."""

    predictor_type: str = "rnn"  # rnn | embedding | conv
    embed_size: int = 256
    hidden_size: int = 256
    output_size: int = 256
    num_layers: int = 1
    embed_dropout: float = 0.0
    dropout: float = 0.1  # between LSTM layers
    # embedding/conv predictors
    history_size: int = 2
    n_head: int = 4  # embedding predictor attention heads
    activation: str = "swish"  # swish | relu


@dataclass
class JointConfig:
    """Additive joint network (reference: model/component/joint.py:7-69)."""

    join_dim: int = 256
    prejoin_linear: bool = True
    postjoin_linear: bool = False
    joint_mode: str = "add"
    activation: str = "tanh"  # tanh | relu | gelu
    # HAT factorization (wenet/transducer/joint.py:51-106): a log-sigmoid
    # blank head; the output is a normalized log-distribution
    hat_joint: bool = False


@dataclass
class CTCModelConfig:
    """The CTC workload's conformer (reference: model/model.py:262-305);
    `tpuasr_torch.models.CTCModel` builds it in fp32."""

    input_size: int = 80
    hidden_dim: int = 256
    attention_heads: int = 8
    num_blocks: int = 3
    ffn_factor: int = 4
    dropout_rate: float = 0.1
    subsampling: str = "conv2d8"
    kernel_size: int = 31


@dataclass
class AttDecoderConfig:
    """The attention decoder of the `aed` workload (the hybrid CTC/attention
    `ASRModel`) and the NAR decoder of the `paraformer` workload; the
    encoder comes from `model.encoder`."""

    blocks: int = 6
    heads: int = 4
    ffn: int = 1024
    lsm_weight: float = 0.1
    # a right-to-left second decoder with r_blocks > 0 (BiTransformerDecoder)
    r_blocks: int = 0
    reverse_weight: float = 0.3
    # feed the decoder only the frames whose CTC argmax is not blank
    apply_non_blank_embedding: bool = False
    # paraformer only: the glancing sampler and the share of its wrong
    # positions it replaces by the target tokens' embeddings
    sampler: bool = True
    sampling_ratio: float = 0.75


@dataclass
class ModelConfig:
    vocab_size: int = 412  # 406 pinyin syllables + 6 specials
    blank_id: int = 5
    # computation dtype of matmuls/activations (parameters stay float32;
    # layer norms and softmaxes compute their statistics in float32)
    compute_dtype: str = "float32"
    # split the materialized route's [B, T, U+1, V] joint logits over the
    # vocabulary on the mesh's model axis (mesh.model_parallel_size > 1;
    # `tpuasr_torch.losses.rnnt_loss_sharded_joint`, any joint head). The
    # fused and pruned routes never form the logits, so there the model
    # axis only repeats work
    shard_joint: bool = False
    # True: fused joint + log-softmax + lattice inputs (kernels in
    # tpuasr_torch/csrc/rnnt_fused.cu), [B, T, U+1, V] never exists; False:
    # the joint's full logits and `rnnt_loss_from_logits`. Both routes run
    # the lattice kernels of tpuasr_torch/csrc/rnnt_lattice.cu on the card
    fused_joint_loss: bool = False
    # > 0: the pruned RNN-T loss over a band of this many label positions a
    # frame (`tpuasr_torch.losses.rnnt_loss_pruned`; the plain head only)
    rnnt_prune_range: int = 0
    ctc_weight: float = 0.3  # > 0 builds the CTC head
    transducer_weight: float = 0.7
    ctc_dropout_rate: float = 0.1
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    predictor: PredictorConfig = field(default_factory=PredictorConfig)
    joint: JointConfig = field(default_factory=JointConfig)
    att_decoder: AttDecoderConfig = field(default_factory=AttDecoderConfig)


@dataclass
class SpecAugConfig:
    """SpecAugment time/frequency masking inside the train step
    (`tpuasr_torch.audio.spec_augment`), drawn from its own generator."""

    enabled: bool = False
    num_t_masks: int = 2
    num_f_masks: int = 2
    max_t: int = 50
    max_f: int = 10


@dataclass
class OptimConfig:
    """Adam + linear warmup + plateau decay (reference: run.py:29-45,
    rnnt_train.py:44-56, rnnt_common.py:7-21)."""

    lr: float = 1e-4
    betas: tuple = (0.9, 0.98)
    eps: float = 1e-8
    weight_decay: float = 1e-4
    amsgrad: bool = True
    warmup_steps: int = 4000
    grad_clip: float = 1.0
    # micro-steps a parameter update averages (optax.MultiSteps' mean)
    accum_steps: int = 1
    plateau_factor: float = 0.5
    plateau_patience: int = 2
    min_lr: float = 1e-6


@dataclass
class DataConfig:
    """The BZNSYP corpus' split files and vocabulary (paths relative to the
    working directory; wav.scp entries relative to the CLIs' --data_root),
    length-bucketed batches (`tpuasr_torch.data.LengthBucketPipeline`) and
    the synthetic stand-in corpus (`--synthetic N`)."""

    train_wav_scp: str = "dataset/split/train/wav.scp"
    train_text: str = "dataset/split/train/pinyin"
    dev_wav_scp: str = "dataset/split/dev/wav.scp"
    dev_text: str = "dataset/split/dev/pinyin"
    test_wav_scp: str = "dataset/split/test/wav.scp"
    test_text: str = "dataset/split/test/pinyin"
    vocab_file: str = "tokenizer/vocab.txt"
    batch_size: int = 12
    # static-shape length bucketing: (max_frames, max_tokens) buckets
    frame_buckets: tuple = (256, 512, 768, 1024, 1536)
    token_buckets: tuple = (16, 32, 48, 64)
    shuffle_seed: int = 0
    # batches in flight on the prefetch thread (0: built on the loop's own
    # thread, `tpuasr_torch.data.prefetch_to_device`)
    num_prefetch: int = 0
    # wave format of the host-to-device copy: "float32" | "int16" (half the
    # bytes; exact for 16-bit PCM corpora, decoded on the device by fbank)
    wire_dtype: str = "float32"
    # nonzero: a bucket padded to F frames gets batch_audio_frames // F
    # utterances (rounded down to batch_multiple) instead of batch_size
    batch_audio_frames: int = 0
    batch_multiple: int = 1
    # the synthetic corpus: token counts, feature frames per token, the
    # two-tone chord encoding, and the hard corpus (mel-grid chords, mel
    # jitter, SNR noise, gain jitter, a Markov token chain)
    synth_min_tokens: int = 4
    synth_max_tokens: int = 12
    synth_frames_per_token: int = 24
    synth_chord: bool = True
    synth_hard: bool = False
    synth_snr_db: float = 10.0
    synth_jitter_mel: float = 12.0
    synth_gain_jitter_db: float = 6.0
    synth_markov: bool = True


@dataclass
class TrainConfig:
    epochs: int = 50
    seed: int = 2026
    log_every: int = 50
    save_every_epochs: int = 5
    save_latest_every: int = 1  # epochs between "latest" checkpoints
    # steps between a dev pass + checkpoint inside the epoch; 0 = per epoch only
    save_interval: int = 0
    save_dir: str = "exp"
    log_dir: str = "exp/tb"
    # compute dtype for the train step; "" inherits model.compute_dtype. A
    # non-empty value overrides model.compute_dtype via `resolve()` so yamls
    # can set the training precision in one place (params stay float32).
    dtype: str = ""


@dataclass
class StreamingConfig:
    """Chunk streaming (reference: rnnt_common.py:16-18,
    model/online_rnnt_model.py:274-344)."""

    chunk_size: int = 32  # encoder frames per chunk
    num_left_chunks: int = 6
    n_steps: int = 10  # max non-blank emissions per frame
    beam_size: int = 4


MESH_STAGES = ("none", "zero1", "zero3")


@dataclass
class MeshConfig:
    """The ranks' (data x model) grid (tpuasr/config.py:372-383). data:
    batch rows (data parallelism); model: the joint's vocabulary when
    model.shard_joint is set. zero_stage shards state over the data axis:
    none | zero1 (the optimizer's moments) | zero3 (the parameters too);
    `tpuasr_torch.parallel.zero`."""

    data_axis: str = "data"
    model_axis: str = "model"
    model_parallel_size: int = 1
    zero_stage: str = "none"

    def __post_init__(self):
        if self.zero_stage not in MESH_STAGES:
            raise ValueError(f"mesh.zero_stage {self.zero_stage!r} not in {MESH_STAGES}")
        if int(self.model_parallel_size) < 1:
            raise ValueError(f"mesh.model_parallel_size {self.model_parallel_size} < 1")


@dataclass
class Config:
    feature: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    ctc_model: CTCModelConfig = field(default_factory=CTCModelConfig)
    specaug: SpecAugConfig = field(default_factory=SpecAugConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    data: DataConfig = field(default_factory=DataConfig)
    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


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


def resolve(cfg: Config) -> Config:
    """Cross-section wiring applied once by the trainer after all overrides:
    a non-empty train.dtype sets model.compute_dtype (the single precision
    knob of a yaml, as the JAX package's `resolve`)."""
    if cfg.train.dtype:
        cfg.model.compute_dtype = cfg.train.dtype
    return cfg


def load_yaml(path: str) -> Config:
    import yaml

    with open(path) as f:
        d = yaml.safe_load(f) or {}
    return from_dict(Config, d)


def layer_yaml(cfg: Config, path: str) -> Config:
    """Apply a (possibly partial) yaml file on top of `cfg`: keys absent
    from the file keep `cfg`'s values, keys this copy does not hold are
    dropped (a JAX ``train.yaml`` layers unchanged)."""
    import yaml

    with open(path) as f:
        layer = yaml.safe_load(f) or {}

    def merge(node: dict, upd: dict) -> None:
        for k, v in upd.items():
            if k not in node:
                continue
            if isinstance(node[k], dict) and isinstance(v, dict):
                merge(node[k], v)
            else:
                node[k] = v

    d = to_dict(cfg)
    merge(d, layer)
    return from_dict(Config, d)


def save_yaml(cfg: Config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(to_dict(cfg), f, sort_keys=False)
