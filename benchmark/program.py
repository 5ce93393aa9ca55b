"""The system under test as the benchmark builds it: the port's configuration
tree from a configuration file, and the model it names with the
benchmark's seeded weights.

A configuration file mirrors the port's configuration sections
(`feature`, `model`, `specaug`, `optim`, `streaming`) with the published
values, and `modes` gives the dotted settings of each use: `train` (the
training precision and front end) and `serve` (the serving ones).
"""

from __future__ import annotations

from benchmark import weights

SECTIONS = ("feature", "model", "specaug", "optim", "streaming")


def port_config(config: dict, mode: str):
    from tpuasr_torch.config import Config, from_dict, override

    cfg = from_dict(Config, {k: config[k] for k in SECTIONS if k in config})
    return override(cfg, config.get("modes", {}).get(mode, {}))


def new_model(config: dict, cfg, device):
    """The configuration's model class, built as the port's trainer builds
    it: `transducer` (`Transducer`) or `aed` (`ASRModel`, the hybrid
    CTC / attention workload)."""
    from tpuasr_torch.models import AEDConfig, ASRModel, Transducer

    m = cfg.model
    if config["model_class"] == "transducer":
        return Transducer(m, device=device)
    if config["model_class"] == "aed":
        d = m.att_decoder
        x = config["model"]
        return ASRModel(AEDConfig(
            vocab_size=m.vocab_size, blank_id=m.blank_id, sos_id=x["sos_id"], eos_id=x["eos_id"],
            ctc_weight=m.ctc_weight, lsm_weight=d.lsm_weight, decoder_blocks=d.blocks,
            decoder_heads=d.heads, decoder_ffn=d.ffn, r_decoder_blocks=d.r_blocks,
            reverse_weight=d.reverse_weight, compute_dtype=m.compute_dtype,
            encoder=m.encoder), device)
    raise ValueError(f"model_class {config['model_class']!r} is not one the benchmark builds")


def build_model(config: dict, mode: str, seed: int, device):
    """-> (port config, model with the seeded weights on `device`)."""
    import torch

    cfg = port_config(config, mode)
    model = new_model(config, cfg, device)
    leaves = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    w = weights.make(seed, leaves, config, device)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(w[n])
    return cfg, model


def leaves(model) -> list:
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def leaves_of(config: dict, mode: str = "serve") -> list:
    """The (name, shape) of every weight of the configuration's model."""
    return leaves(new_model(config, port_config(config, mode), "cpu"))
