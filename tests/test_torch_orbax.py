"""The JAX package's orbax checkpoints in the port, on the CPU.

The JAX package's own `save_checkpoint` writes a `TrainState` of the tiny
flagship (`__graft_entry__._flagship_config(tiny=True)` with a static chunk
of 4 and no dropout or SpecAugment, so both steps are deterministic) in
three layouts: `encoder.scan_layers` True (after one JAX `make_train_step`
step, so its moments come from a step) and False, and with
`cnn_module_norm=batch_norm` (running statistics drawn from a seed; the
JAX package cannot train batch norm), these two with seeded random moments
and counters. Then:

- `read_orbax` gives the saved tree leaf for leaf (values, dtypes, keys);
  the npz route (`tools/orbax_to_npz`, `read_npz`) gives it bit for bit,
  with the info JSON and train.yaml beside the npz;
- restored through `train.restore_checkpoint`, the port's encoder output
  equals the JAX model's within atol 1e-4 (tests/test_torch_encoder.py's:
  two blocks of fp32 sums in another order), its greedy tokens exactly;
- one more JAX step and one port step from the restored states: losses
  within 1e-4 relative, mu, nu and nu_max within 1e-3 of each leaf's max
  (the features come from two fbank implementations, whose last bits flip
  a few first-layer ReLUs) plus 1e-6 of the moment's largest entry over
  all leaves (the key projection's bias has a zero gradient in exact
  arithmetic, softmax ignoring a constant a query, so its moments are
  rounding noise of ~1e-12), count, step and skipped equal;
- `flax_params` (JAX-free, from the module types) equals the inverse of the
  converter taken through a JAX template (`tests/test_torch_zoo.
  flax_variables`) for the transducer (encoder and block options, batch
  norm, the predictors, HAT), CTC, AED, both Paraformer stacks with the CTC
  and timestamp branches, Whisper and the encoder families, and
  `convert_params(flax_params(m))` gives back `m.state_dict()` exactly;
- `evaluate --checkpoint <orbax dir> --device cpu` prints the CER and
  samples of JAX `evaluate_offline` on the same params; `train --resume
  <orbax dir>` continues at the saved epoch and step;
- a missing tensorstore, an unknown layout and a leaf left over or missing
  raise.
"""

import dataclasses
import json
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from __graft_entry__ import _flagship_config
from tpuasr.config import save_yaml
from tpuasr.config import to_dict as jax_to_dict
from tpuasr.models import Transducer as JaxTransducer
from tpuasr.train import TrainState as JaxTrainState
from tpuasr.train import make_optimizer as jax_make_optimizer
from tpuasr.train.checkpoint import save_checkpoint as jax_save_checkpoint
from tpuasr.train.step import make_train_step as jax_make_train_step
from tpuasr_torch.config import Config, from_dict
from tpuasr_torch.convert import (
    convert_params, convert_train_state, flax_params, flax_train_state,
)
from tpuasr_torch.decode import rnnt_greedy_decode
from tpuasr_torch.models import Transducer
from tpuasr_torch.train import TrainState, make_optimizer, make_train_step, restore_checkpoint
from tpuasr_torch.train.optim import unflatten
from tpuasr_torch.train.orbax import flatten_tree, read_npz, read_orbax

torch.set_num_threads(1)  # six test workers share the cores

LAYOUTS = {"unrolled": dict(scan_layers=False), "scanned": dict(scan_layers=True),
           "batch_norm": dict(scan_layers=False, cnn_module_norm="batch_norm")}
ENC_ATOL, LOSS_RTOL, MOMENT_REL, MOMENT_FLOOR = 1e-4, 1e-4, 1e-3, 1e-6
EPOCH = 2


def jax_config(layout: str):
    cfg = _flagship_config(tiny=True)
    enc = dataclasses.replace(cfg.model.encoder, use_dynamic_chunk=False, **LAYOUTS[layout])
    pred = dataclasses.replace(cfg.model.predictor, embed_dropout=0.0, dropout=0.0)
    cfg.model = dataclasses.replace(cfg.model, encoder=enc, predictor=pred, ctc_dropout_rate=0.0)
    cfg.specaug.enabled = False
    cfg.optim = dataclasses.replace(cfg.optim, lr=1e-3, warmup_steps=3)
    return cfg


def wave_batch(vocab: int) -> dict:
    r = np.random.default_rng(0)
    waves = (r.standard_normal((2, 20000)) * 0.1).astype(np.float32)
    waves[1, 15000:] = 0.0
    texts = r.integers(6, vocab, (2, 5)).astype(np.int32)
    return {"waves": waves, "wave_lens": np.array([20000, 15000], np.int32), "texts": texts,
            "text_lens": np.array([5, 3], np.int32)}


def jax_tree(state) -> dict:
    """The JAX TrainState as the nested dict orbax stores."""
    opt = {k: getattr(state.opt_state, k) for k in state.opt_state._fields
           if getattr(state.opt_state, k) is not None}
    return jax.tree.map(np.asarray, {"params": state.params, "opt_state": opt,
                                     "step": state.step, "lr_scale": state.lr_scale,
                                     "skipped": state.skipped})


_SAVED = {}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("jax_checkpoints")


def saved_state(layout: str, root) -> dict:
    """A JAX TrainState of `layout` saved by the JAX package, with its info
    JSON and train.yaml. The weights are the port's seeded ones in the flax
    layout (`flax_params`, held against a JAX template below; JAX compiles
    no init); the scanned layout then takes one jitted JAX step (its
    moments come from a real step, and the next-step test steps on), the
    others carry seeded random moments and counters."""
    if layout in _SAVED:
        return _SAVED[layout]
    from tpuasr.nn.conformer import stack_layer_params
    from tpuasr.train.optim import FusedAdamState as JaxFusedAdamState
    from tpuasr_torch.models import init_weights

    cfg = jax_config(layout)
    jm = JaxTransducer(cfg.model)
    batch = wave_batch(cfg.model.vocab_size)
    port = init_weights(Transducer(from_dict(Config, jax_to_dict(cfg)).model, device="cpu"), 3)
    r = np.random.default_rng(3)
    with torch.no_grad():
        for name, buf in port.named_buffers():  # batch norm's running statistics
            buf.copy_(torch.from_numpy((r.normal(0.0, 0.3, buf.shape) if name.endswith(".mean")
                                        else r.uniform(0.5, 2.0, buf.shape)).astype(np.float32)))
    variables = flax_params(port)
    if cfg.model.encoder.scan_layers:
        variables["params"]["encoder"] = stack_layer_params(variables["params"]["encoder"],
                                                            cfg.model.encoder.num_blocks)
    variables = jax.tree.map(jax.numpy.asarray, variables)
    tx = jax_make_optimizer(cfg.optim)
    step = None
    if layout == "scanned":
        state = JaxTrainState.create(variables, tx)
        step = jax.jit(jax_make_train_step(jm, tx, cfg, donate=False))
        state, _ = step(state, batch, jax.random.PRNGKey(1))
    else:
        moment = lambda scale: jax.tree.map(
            lambda x: jax.numpy.asarray(np.abs(r.normal(0.0, scale, x.shape)).astype(np.float32)),
            variables["params"])
        i32 = lambda n: jax.numpy.asarray(n, jax.numpy.int32)
        state = JaxTrainState(params=variables, opt_state=JaxFusedAdamState(
            count=i32(7), mu=moment(1e-3), nu=moment(1e-6), nu_max=moment(1e-6)),
            step=i32(9), lr_scale=jax.numpy.asarray(0.5, jax.numpy.float32), skipped=i32(2))
    save_dir = root / layout
    save_dir.mkdir()
    ckpt = str(save_dir / "latest")
    jax_save_checkpoint(ckpt, state, {"epoch": EPOCH, "step": int(state.step)})
    save_yaml(cfg, str(save_dir / "train.yaml"))
    _SAVED[layout] = {"layout": layout, "cfg": cfg, "jm": jm, "state": state, "step": step,
                      "batch": batch, "ckpt": ckpt, "dir": save_dir}
    return _SAVED[layout]


def port_restore(saved, path=None):
    pcfg = from_dict(Config, jax_to_dict(saved["cfg"]))
    model = Transducer(pcfg.model, device="cpu")
    tx = make_optimizer(pcfg.optim)
    return pcfg, tx, restore_checkpoint(path or saved["ckpt"], TrainState.create(model, tx))


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_read_orbax_is_the_saved_tree(layout, root):
    saved = saved_state(layout, root)
    got, want = flatten_tree(read_orbax(saved["ckpt"])), flatten_tree(jax_tree(saved["state"]))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert "jax" in sys.modules  # this test file's; the reader itself imports none (test_torch_port)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_npz_route_is_the_orbax_route_bit_for_bit(layout, root, tmp_path):
    saved = saved_state(layout, root)
    from tpuasr_torch.tools import orbax_to_npz

    out = str(tmp_path / "ckpt" / "latest.npz")
    orbax_to_npz.main([saved["ckpt"], out])
    a, b = flatten_tree(read_orbax(saved["ckpt"])), flatten_tree(read_npz(out))
    assert a.keys() == b.keys()
    assert all(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]) for k in a)
    params = flatten_tree(read_npz(out, only="params"))  # what a server reads
    assert params.keys() == {k for k in a if k.startswith("params/")}
    assert params.keys() == flatten_tree(read_orbax(saved["ckpt"], only="params")).keys()
    assert json.load(open(out + ".json")) == {"epoch": EPOCH, "step": int(saved["state"].step)}
    assert (tmp_path / "ckpt" / "train.yaml").read_text() == (saved["dir"] / "train.yaml").read_text()
    _, _, s1 = port_restore(saved)
    _, _, s2 = port_restore(saved, out)
    assert all(torch.equal(x, s2.model.state_dict()[k]) for k, x in s1.model.state_dict().items())
    for k in ("count", "mu", "nu", "nu_max"):
        assert torch.equal(getattr(s1.opt_state, k), getattr(s2.opt_state, k)), k


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_restored_model_encodes_and_decodes_as_jax(layout, root):
    saved = saved_state(layout, root)
    cfg, jm, state = saved["cfg"], saved["jm"], saved["state"]
    _, _, restored = port_restore(saved)
    model = restored.model.eval()
    r = np.random.default_rng(1)
    feats = (r.standard_normal((2, 77, 80)) * 0.5).astype(np.float32)
    lens = np.array([77, 60], np.int32)
    enc, enc_lens = jax.jit(lambda v, f, fl: jm.apply(v, f, fl, method="encode"))(
        state.params, feats, lens)
    got, got_lens = model.encode(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(enc_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(enc), rtol=0, atol=ENC_ATOL)
    from tpuasr.decode.rnnt_greedy import rnnt_greedy_decode as jax_greedy

    blank = cfg.model.blank_id
    ref_t, ref_l = jax_greedy(jm, state.params, enc, enc_lens, blank, 4, 40)
    toks, n = rnnt_greedy_decode(model, torch.from_numpy(np.array(enc)),
                                 torch.from_numpy(np.array(enc_lens)), blank, 4, 40)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_l))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(ref_t))


def test_next_train_step_matches_jax(root):
    saved = saved_state("scanned", root)
    jstate, jmetrics = saved["step"](saved["state"], saved["batch"], jax.random.PRNGKey(2))
    pcfg, tx, state = port_restore(saved)
    assert (state.step, int(state.opt_state.count), int(state.skipped)) == \
           (int(saved["state"].step), int(saved["state"].opt_state.count), 0)
    batch = {k: torch.from_numpy(v) for k, v in saved["batch"].items()}
    state, metrics = make_train_step(state.model, tx, pcfg)(state, batch, 2)
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), rtol=LOSS_RTOL)
    assert (state.step, int(state.opt_state.count), int(state.skipped)) == \
           (int(jstate.step), int(jstate.opt_state.count), int(jstate.skipped))
    params = list(state.model.parameters())
    names = [n for n, _ in state.model.named_parameters()]
    for k in ("mu", "nu", "nu_max"):
        want = convert_params(jax.tree.map(np.asarray, getattr(jstate.opt_state, k)))
        floor = MOMENT_FLOOR * max(float(v.abs().max()) for v in want.values())
        for name, got in zip(names, unflatten(getattr(state.opt_state, k), params)):
            w = want[name].numpy()
            err = float(np.abs(got.numpy() - w).max())
            assert err <= MOMENT_REL * float(np.abs(w).max()) + floor, (k, name, err)


def test_evaluate_cli_prints_jax_evaluate_offline(root, capsys):
    saved = saved_state("scanned", root)
    from tpuasr.data.corpus import synthetic_pipeline as jax_synthetic
    from tpuasr.eval import evaluate_offline as jax_evaluate
    from tpuasr.text import Tokenizer as JaxTokenizer
    from tpuasr_torch.tools import evaluate

    cfg = saved["cfg"]
    res = evaluate.main(["--checkpoint", saved["ckpt"], "--mode", "rnnt_greedy",
                         "--synthetic", "6", "--device", "cpu", "--max_samples", "3"])
    printed = capsys.readouterr().out
    tok = JaxTokenizer(tokens=[f"syl{i}" for i in range(cfg.model.vocab_size - 6)])
    ref = jax_evaluate(saved["jm"], saved["state"].params, jax_synthetic(cfg, 6, seed=1)
                       .batches(0), cfg, tok, mode="rnnt_greedy", max_samples=3)
    c = ref.counts
    assert vars(res.counts) == vars(c) and c.ref_len > 0
    assert f"CER {100 * c.cer:.2f}%  (S={c.substitutions} D={c.deletions} " \
           f"I={c.insertions} N={c.ref_len})" in printed
    assert [tuple(s) for s in res.samples] == [tuple(s) for s in ref.samples]
    for utt, r, h in ref.samples:
        assert f"  [{utt}] REF: {r}\n  [{utt}] HYP: {h}" in printed


def test_trainer_resumes_from_the_orbax_dir(root, tmp_path):
    saved = saved_state("unrolled", root)
    from tpuasr_torch.tools import train
    from tpuasr_torch.train import latest_path, load_info

    res = train.main(["--device", "cpu", "--synthetic", "8", "--epochs", str(EPOCH + 2),
                      "--resume", saved["ckpt"], "--set", f"train.save_dir={tmp_path}",
                      "train.log_dir=", "data.batch_size=4"])
    saved_step = int(saved["state"].step)
    info = load_info(latest_path(str(tmp_path)))
    assert len(res.train_losses) == 1 and info["epoch"] == EPOCH + 1
    assert res.state.step == info["step"] > saved_step
    assert all(np.isfinite(res.train_losses))


@pytest.mark.parametrize("name", ["default", "batch_norm", "moe", "shaw", "learnable",
                                  "firered", "rms_norm"])
def test_flax_params_inverts_the_converter_transducer(name):
    from tests.test_torch_zoo import build, case, jax_cfg

    _, params, port = build(jax_cfg()) if name == "default" else case(name)
    _same_tree(flax_params(port), params, port)


@pytest.mark.parametrize("which", ["conv", "embedding", "hat", "postjoin"])
def test_flax_params_inverts_the_converter_heads(which):
    from tests.test_torch_zoo import build, jax_cfg

    cfg = {"conv": dict(predictor=dict(predictor_type="conv", embed_size=32)),
           "embedding": dict(predictor=dict(predictor_type="embedding", embed_size=32)),
           "hat": dict(joint=dict(hat_joint=True)),
           "postjoin": dict(joint=dict(postjoin_linear=True))}[which]
    _, params, port = build(jax_cfg(**cfg))
    _same_tree(flax_params(port), params, port)


@pytest.mark.parametrize("family", ["ctc", "aed", "paraformer", "paraformer_sanm", "whisper",
                                    "squeezeformer", "efficient_conformer"])
def test_flax_params_inverts_the_converter_families(family):
    from tests.test_torch_zoo import flax_variables

    if family == "ctc":
        from tests.test_torch_ctc_model import BLANK, TINY, V, _batch
        from tpuasr.config import CTCModelConfig as JaxCTCConfig
        from tpuasr.models import CTCModel as JaxCTCModel
        from tpuasr_torch.config import CTCModelConfig
        from tpuasr_torch.models import CTCModel, init_weights

        port = init_weights(CTCModel(CTCModelConfig(**TINY), V, BLANK, device="cpu"), 3)
        params = flax_variables(JaxCTCModel(JaxCTCConfig(**TINY), V, BLANK), port, *_batch())
    elif family == "aed":
        from tests.test_torch_aed import flax_params as template, jax_cfg, port_model
        from tpuasr.models import asr_model as jax_asr

        jc = jax_cfg(r_decoder_blocks=1, reverse_weight=0.3)
        port = port_model(jc)
        params = template(jax_asr.ASRModel(jc), port)
    elif family.startswith("paraformer"):
        from tests.test_torch_paraformer import build, jax_cfg

        jc = jax_cfg("sanm" if family.endswith("sanm") else "conformer", ctc_weight=0.3,
                     timestamp_branch=True)
        _, params, port = build(jc)
    elif family == "whisper":
        from tests.test_torch_whisper import build

        _, _, params, port = build(ctc_weight=0.3)
    else:
        from tests.test_torch_families import family as build_family

        _, params, port = build_family({"squeezeformer": "sq", "efficient_conformer": "ec_g2"}
                                       [family])
    _same_tree(flax_params(port), params, port)


def _same_tree(got: dict, want: dict, port) -> None:
    a, b = flatten_tree(got), flatten_tree(jax.tree.map(np.asarray, want))
    assert a.keys() == b.keys(), (sorted(a.keys() ^ b.keys()))
    for k in b:
        assert a[k].shape == b[k].shape and np.array_equal(a[k], b[k]), k
    back = convert_params(got)
    sd = port.state_dict()
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("layout", ["unrolled", "batch_norm"])
def test_train_state_round_trip_and_strictness(layout, root):
    saved = saved_state(layout, root)
    pcfg, tx, state = port_restore(saved)
    tree = flax_train_state(state)
    target = lambda: TrainState.create(Transducer(pcfg.model, device="cpu"), tx)
    again = convert_train_state(tree, target())
    for k in ("count", "mu", "nu", "nu_max"):
        assert torch.equal(getattr(again.opt_state, k), getattr(state.opt_state, k))
    assert (again.step, again.lr_scale, int(again.skipped)) == \
           (state.step, state.lr_scale, int(state.skipped))
    extra = dict(tree, opt_state=dict(tree["opt_state"], mu=dict(tree["opt_state"]["mu"],
                                                                 stray={"x": np.zeros(2)})))
    with pytest.raises(ValueError, match="left over"):
        convert_train_state(extra, target())
    mu = dict(tree["opt_state"]["mu"])
    mu.pop("ctc")
    with pytest.raises(ValueError, match="missing"):
        convert_train_state(dict(tree, opt_state=dict(tree["opt_state"], mu=mu)), target())
    with pytest.raises(RuntimeError):  # strict load_state_dict: a parameter missing
        params = dict(tree["params"], params=dict(tree["params"]["params"]))
        params["params"].pop("ctc")
        convert_train_state(dict(tree, params=params), target())
    multi = dict(tree, opt_state={"inner_opt_state": {}, "mini_step": np.zeros((), np.int32)})
    with pytest.raises(ValueError, match="GuardedAdam"):
        convert_train_state(multi, target())


def test_reader_refuses_what_it_does_not_know(root, tmp_path, monkeypatch):
    saved = saved_state("unrolled", root)
    from tpuasr_torch.train import orbax

    bad = tmp_path / "bad"
    shutil.copytree(saved["ckpt"], bad)
    meta = json.loads((bad / "_METADATA").read_text())
    key = next(iter(meta["tree_metadata"]))
    meta["tree_metadata"][key]["value_metadata"]["value_type"] = "scalar"
    (bad / "_METADATA").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="does not know"):
        read_orbax(str(bad))
    (bad / "_METADATA").write_text(json.dumps({"use_ocdbt": True}))
    with pytest.raises(ValueError, match="tree_metadata"):
        read_orbax(str(bad))
    (tmp_path / "empty").mkdir()
    with pytest.raises(ValueError, match="without _METADATA"):
        orbax.read_checkpoint(str(tmp_path / "empty"))
    monkeypatch.setitem(sys.modules, "tensorstore", None)  # as on the card's machine
    with pytest.raises(ImportError, match="orbax_to_npz"):
        read_orbax(saved["ckpt"])
