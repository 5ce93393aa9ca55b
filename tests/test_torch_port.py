"""The port's boundaries: imports, devices, configs, weights, unported options.

- No module of `tpuasr_torch/` (nor chip_smoke.py) imports jax, flax or
  tpuasr, checked on the source with `ast`.
- Entry points default to the card and raise without one unless
  device="cpu"; the kernel wrappers take their plain versions only for CPU
  tensors; the RTF measurement refuses a model that is not on the card.
- A JAX config loads into the port's config tree: every field the port
  holds keeps the JAX value, and the keys it does not hold are dropped;
  the trainer resolves a non-empty train.dtype into model.compute_dtype,
  as the JAX trainer does.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import tpuasr.config as jax_config
from tpuasr_torch.audio import fbank_batch
from tpuasr_torch.config import Config, ModelConfig, from_dict, load_yaml, to_dict
from tpuasr_torch.device import resolve_device
from tpuasr_torch.eval import measure_rtf
from tpuasr_torch.models import Transducer, init_weights
from tpuasr_torch.ops import LAUNCHES, fbank_frames, relpos_attention
from tpuasr_torch.tools.train import effective_config

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "tpuasr"}


def _tiny_cfg(**enc) -> ModelConfig:
    mc = ModelConfig(vocab_size=64)
    mc.encoder = dataclasses.replace(mc.encoder, output_size=32, attention_heads=2,
                                     linear_units=64, num_blocks=2, cnn_module_kernel=7,
                                     causal=True, **enc)
    mc.predictor = dataclasses.replace(mc.predictor, embed_size=16, hidden_size=16,
                                       output_size=32)
    return mc


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted((ROOT / "tpuasr_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_nothing_of_jax(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; this checks the no-card behaviour")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        Transducer(_tiny_cfg())
    waves, lens = np.zeros((1, 4000), np.float32), np.array([4000])
    with pytest.raises(RuntimeError):
        fbank_batch(waves, lens, Config().feature)
    feats, _ = fbank_batch(waves, lens, Config().feature, device="cpu")
    assert feats.device.type == "cpu"


def test_wrappers_run_plain_only_on_cpu_tensors():
    before = dict(LAUNCHES)
    x = torch.randn(2, 5, 64)
    mask = torch.ones(2, 1, 5, dtype=torch.bool)
    out = relpos_attention(x, x, x[:1], x, x[0, 0], x[0, 0], mask, 0.125, 2)
    assert out.shape == x.shape and LAUNCHES == before
    meta = torch.empty(2, 5, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        relpos_attention(meta, meta, meta[:1], meta, meta[0, 0], meta[0, 0], mask, 0.1, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        fbank_frames(meta, meta[0, 0], meta, meta, meta, 1e-10)


def test_training_wrappers_run_plain_only_on_cpu_tensors():
    from tpuasr_torch.ops import ctc_alpha, ctc_beta_grad, rnnt_fused_grads, rnnt_fused_lp

    meta = torch.empty(2, 5, 7, device="meta")
    flags = torch.empty(2, 7, dtype=torch.bool, device="meta")
    lens = torch.empty(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_alpha(meta, flags, lens, flags)
    with pytest.raises(ValueError, match="unsupported device"):
        ctc_beta_grad(meta, flags, lens, flags, meta, lens.float(), lens.float())
    enc, pred = torch.empty(2, 5, 8, device="meta"), torch.empty(2, 3, 8, device="meta")
    w, b = torch.empty(8, 11, device="meta"), torch.empty(11, device="meta")
    lab = torch.empty(2, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rnnt_fused_lp(enc, pred, w, b, lab, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        rnnt_fused_grads(enc, pred, w, b, lab, meta, meta, meta, 5)


def test_measure_rtf_refuses_cpu():
    model = Transducer(_tiny_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="card"):
        measure_rtf(model, torch.zeros(1, 200, 80), Config())
    with pytest.raises(RuntimeError, match="card"):
        measure_rtf(model, torch.zeros(1, 200, 80), Config(), mode="beam")


@pytest.mark.parametrize("bad", [
    ({"encoder_type": "squeezeformer", "time_reduction_type": "stream"}, "streams"),
    ({"encoder_type": "efficient_conformer"}, "streams"),
    ({"normalize_before": False}, "build"),
    ({"cnn_module_norm": "batch_norm"}, "train"),
    ({"encoder_type": "firered"}, "stream"),
])
def test_unported_options_raise(bad):
    """What the port does not build raises NotImplementedError where it is
    used: the JAX block's unread normalize_before, batch-norm training (the
    JAX package cannot train it either) and FireRed's streaming (full
    context only). The encoder families, refused at construction until they
    were ported, now build and stream a chunk through their own caches."""
    enc, use = bad
    if use == "streams":
        model = Transducer(_tiny_cfg(**enc), device="cpu")
        state = model.init_encoder_state(1, 6, 2)
        ys, state = model.encode_chunk(torch.zeros(1, 27, 80), state)
        assert ys.shape == (1, 6, 32) and state.offset == 6 and len(state.att) == 2
        return
    with pytest.raises(NotImplementedError):
        model = Transducer(_tiny_cfg(**enc), device="cpu")
        if use == "train":
            model.train()
            model(torch.randn(1, 40, 80), torch.tensor([40]), torch.tensor([[7, 8]]),
                  torch.tensor([2]), dropout_gen=torch.Generator().manual_seed(0))
        elif use == "stream":
            model.encode_chunk(torch.zeros(1, 19, 80), model.init_encoder_state(1, 4, 2))


@pytest.mark.parametrize("remat", [True, False])
def test_jax_gradient_checkpointing_is_read_and_refused(remat):
    """A JAX model dict with `encoder.gradient_checkpointing` keeps the field
    through `from_dict`, and the encoder honours it (it was refused before
    the port recomputed blocks): with True a training forward and backward
    runs each block twice (the recompute), with False once."""
    jm = jax_config.ModelConfig(vocab_size=64)
    jm.encoder = dataclasses.replace(jm.encoder, output_size=32, attention_heads=2,
                                     linear_units=64, num_blocks=1, cnn_module_kernel=7,
                                     gradient_checkpointing=remat)
    mc = from_dict(ModelConfig, jax_config.to_dict(jm))
    assert mc.encoder.gradient_checkpointing is remat
    enc = Transducer(mc, device="cpu").encoder
    calls = []
    fwd = enc.blocks[0].forward
    enc.blocks[0].forward = lambda *a, **k: calls.append(1) or fwd(*a, **k)
    ys, _ = enc(torch.randn(1, 40, 80), torch.tensor([40]))
    ys.sum().backward()
    assert len(calls) == (2 if remat else 1)


@pytest.mark.parametrize("where,key,value", [
    ("model", "rnnt_prune_range", 4), ("predictor", "predictor_type", "embedding"),
    ("encoder", "pos_enc_layer_type", "abs_pos"), ("predictor", "predictor_type", "conv"),
    ("joint", "hat_joint", True), ("encoder", "normalize_before", False),
    ("encoder", "encoder_type", "squeezeformer"),
])
def test_unported_training_options_raise(where, key, value):
    """The trainer's model options: the ones refused before the transducer's
    options and the encoder families were ported (the pruned loss, the
    stateless predictors, abs_pos, HAT, squeezeformer) now take a training
    step with a finite loss and gradient through `make_train_step`; what
    stays unported still raises NotImplementedError."""
    from tpuasr_torch.models import init_weights
    from tpuasr_torch.train import TrainState, make_optimizer, make_train_step

    cfg = Config()
    cfg.model = _tiny_cfg()
    target = {"model": cfg.model, "encoder": cfg.model.encoder, "optim": cfg.optim,
              "predictor": cfg.model.predictor, "joint": cfg.model.joint}[where]
    setattr(target, key, value)
    if where == "predictor":
        cfg.model.predictor.embed_size = cfg.model.predictor.output_size
    if (key, value) == ("normalize_before", False):
        with pytest.raises(NotImplementedError):
            Transducer(cfg.model, device="cpu")
        return
    cfg.feature.sample_rate = 16000
    model = init_weights(Transducer(cfg.model, device="cpu"), 0)
    tx = make_optimizer(cfg.optim)
    r = np.random.default_rng(1)
    batch = {"waves": torch.from_numpy((0.1 * r.standard_normal((2, 40 * 512)))
                                       .astype(np.float32)),
             "wave_lens": torch.tensor([40 * 512, 31 * 512]),
             "texts": torch.from_numpy(r.integers(6, 64, (2, 5))),
             "text_lens": torch.tensor([5, 2])}
    _, metrics = make_train_step(model, tx, cfg)(TrainState.create(model, tx), batch, 0)
    assert bool(metrics["finite"]) and float(metrics["loss"]) > 0


def test_lattice_and_materialized_loss_refuse_other_devices():
    """The materialized RNN-T loss runs on the CPU (plain lattice) and on the
    card (kernels #8/#9); any other device is refused, as are the lattice
    wrappers' and the attention backward's inputs there."""
    from tpuasr_torch.losses import rnnt_loss_from_logits
    from tpuasr_torch.ops import relpos_attention_bwd, rnnt_alpha, rnnt_beta_grad

    meta = torch.empty(1, 3, 2, 5, device="meta")
    lens = torch.ones(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rnnt_loss_from_logits(meta, lens[:, None], lens, lens, 0)
    blank, label = torch.empty(1, 3, 2, device="meta"), torch.empty(1, 3, 1, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        rnnt_alpha(blank, label, lens)
    with pytest.raises(ValueError, match="unsupported device"):
        rnnt_beta_grad(blank, label, lens, blank, lens.float(), lens.float())
    x = torch.empty(2, 5, 64, device="meta")
    mask = torch.ones(2, 1, 5, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        relpos_attention_bwd(x, x, x[:1], x, x[0, 0], x[0, 0], mask, x, 0.1, 2)


def test_config_round_trips_from_jax(tmp_path):
    jcfg = jax_config.Config()
    jcfg.model.encoder.fused_attention = True
    jcfg.feature.fbank_precision = "default"
    path = tmp_path / "train.yaml"
    jax_config.save_yaml(jcfg, str(path))  # what the JAX trainer persists
    cfg = load_yaml(str(path))
    full = jax_config.to_dict(jcfg)

    def held(port, ref):  # every leaf the port holds equals the JAX leaf
        return all(held(v, ref[k]) if isinstance(v, dict) else v == ref[k]
                   for k, v in port.items())

    got = to_dict(cfg)
    assert held(got, full) and got["feature"]["fbank_precision"] == "default"
    assert got["model"]["encoder"]["fused_attention"] is True  # held, the JAX value
    assert from_dict(Config, got) == cfg


def test_trainer_resolves_train_dtype_from_a_yaml(tmp_path):
    """A yaml's train.dtype reaches model.compute_dtype through the trainer's
    layering and `resolve`, over the card's bf16 default, as the JAX
    trainer's resolve (tpuasr/config.py) gives it."""
    path = tmp_path / "train.yaml"
    path.write_text("train:\n  dtype: float32\n")
    cfg = effective_config("cuda", str(path), [])
    assert cfg.train.dtype == "float32" and cfg.model.compute_dtype == "float32"
    jcfg = jax_config.resolve(jax_config.layer_yaml(jax_config.Config(), str(path)))
    assert cfg.model.compute_dtype == jcfg.model.compute_dtype


@pytest.mark.parametrize("device_type,default", [("cuda", "bfloat16"), ("cpu", "float32")])
def test_trainer_keeps_compute_dtype_when_train_dtype_is_empty(tmp_path, device_type, default):
    path = tmp_path / "train.yaml"
    path.write_text("train:\n  dtype: ''\n  epochs: 3\n")
    cfg = effective_config(device_type, str(path), [])
    assert cfg.train.dtype == "" and cfg.train.epochs == 3
    assert cfg.model.compute_dtype == default == effective_config(device_type, None, []) \
        .model.compute_dtype


def test_trainer_resolves_train_dtype_from_set():
    cfg = effective_config("cpu", None, ["train.dtype=bfloat16"])
    assert cfg.model.compute_dtype == "bfloat16"
    # the last word is train.dtype's, whichever key the overrides name
    cfg = effective_config("cuda", None, ["model.compute_dtype=bfloat16", "train.dtype=float32"])
    assert cfg.model.compute_dtype == "float32"


def test_seeded_weights():
    a = init_weights(Transducer(_tiny_cfg(), device="cpu"), seed=7).state_dict()
    b = init_weights(Transducer(_tiny_cfg(), device="cpu"), seed=7).state_dict()
    c = init_weights(Transducer(_tiny_cfg(), device="cpu"), seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["joint.ffn_out_kernel"], c["joint.ffn_out_kernel"])
    assert torch.equal(a["encoder.after_norm.weight"], torch.ones(32))
