"""The port's boundaries: imports, devices, configs, weights, unported options.

- No module of `tpuasr_torch/` (nor chip_smoke.py) imports jax, flax or
  tpuasr, checked on the source with `ast`.
- Entry points default to the card and raise without one unless
  device="cpu"; the kernel wrappers take their plain versions only for CPU
  tensors; the RTF measurement refuses a model that is not on the card.
- A JAX config loads into the port's config tree: every field the port
  holds keeps the JAX value, and the keys it does not hold are dropped.
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


def test_measure_rtf_refuses_cpu():
    model = Transducer(_tiny_cfg(), device="cpu")
    with pytest.raises(RuntimeError, match="card"):
        measure_rtf(model, torch.zeros(1, 200, 80), Config())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        measure_rtf(model, torch.zeros(1, 200, 80), Config(), mode="beam")


@pytest.mark.parametrize("bad", [
    {"encoder_type": "squeezeformer"}, {"attention_type": "rope"},
    {"input_layer": "conv2d8"}, {"cnn_module_norm": "batch_norm"}, {"n_kv_head": 1},
])
def test_unported_options_raise(bad):
    with pytest.raises(NotImplementedError):
        Transducer(_tiny_cfg(**bad), device="cpu")


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
    assert "fused_attention" not in got["model"]["encoder"]  # dropped, not ported
    assert from_dict(Config, got) == cfg


def test_seeded_weights():
    a = init_weights(Transducer(_tiny_cfg(), device="cpu"), seed=7).state_dict()
    b = init_weights(Transducer(_tiny_cfg(), device="cpu"), seed=7).state_dict()
    c = init_weights(Transducer(_tiny_cfg(), device="cpu"), seed=8).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["joint.ffn_out_kernel"], c["joint.ffn_out_kernel"])
    assert torch.equal(a["encoder.after_norm.weight"], torch.ones(32))
