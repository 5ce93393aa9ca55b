"""The parallel layer's pieces that need no second rank, in one process on
the CPU (tests/test_torch_parallel_dist.py runs the collectives across
ranks):

- `MeshConfig` and `model.shard_joint` through yaml, a JAX config's dict
  and `override`; an unknown ZeRO stage, a model size below 1 and a world
  the model size does not divide raise.
- The rank grid against `tpuasr.parallel.make_mesh`'s device layout on the
  virtual 8-device mesh (model sizes 1, 2, 4, 8), and `shard_batch`'s rows
  against the per-device shards of the same array under JAX's
  `batch_sharding`; the vocabulary split covers the vocabulary once.
- The flat ZeRO slices: ceil(N / n) entries a rank, zero-padded, their
  concatenation the vector; zero3's parameters become views of a buffer
  that is released between steps and materialized back bit for bit;
  `assert_sharded` passes a sharded state and refuses a whole one.
- The generator fold: data rank 0 draws the bits of the formula the port
  used before the parallel layer, other data ranks other bits; the chunk
  draw is the same on every rank.
- `allreduce_cer_counts` is the identity at one rank.
- A step without a mesh is bit for bit the pre-parallel step (written out
  here from its parts), and so is a step on a mesh of one rank (dropout,
  SpecAugment and dynamic chunks on).
- shard_joint at one model rank equals the materialized route, for the
  plain head, a post-join linear and the HAT (also where the HAT's
  1 - p_blank clip binds); a HAT head with two model ranks takes the split
  route (it raised before the split heads were written).
- `steps_per_epoch` reads no wave; a disabled `MetricsWriter` writes and
  prints nothing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpuasr.config import Config as JaxConfig
from tpuasr.config import to_dict as jax_to_dict
from tpuasr.parallel import batch_sharding
from tpuasr.parallel import make_mesh as jax_make_mesh
from tpuasr_torch.config import Config, MeshConfig, from_dict, load_yaml, override, save_yaml
from tpuasr_torch.data import LengthBucketPipeline, Utterance
from tpuasr_torch.eval.multihost import allreduce_cer_counts
from tpuasr_torch.losses import rnnt_loss_from_logits, rnnt_loss_sharded, rnnt_loss_sharded_joint
from tpuasr_torch.models import Transducer, init_weights
from tpuasr_torch.parallel import (
    Mesh, VocabShard, ZeroShard, assert_sharded, rank_grid, shard_batch, shard_train_state,
    vocab_range,
)
from tpuasr_torch.text.cer import CerCounts
from tpuasr_torch.train import GuardedAdam, MetricsWriter, TrainState, make_train_step
from tpuasr_torch.train.optim import flatten
from tpuasr_torch.train.step import sampler_generator, specaug_generator, step_generators

torch.set_num_threads(1)  # six test workers share the cores

MASK63 = (1 << 63) - 1


def tiny_cfg(dropout: float = 0.0) -> Config:
    cfg = override(Config(), {
        "model.vocab_size": 32, "model.encoder.num_blocks": 1,
        "model.encoder.output_size": 32, "model.encoder.attention_heads": 2,
        "model.encoder.linear_units": 64, "model.encoder.cnn_module_kernel": 7,
        "model.encoder.causal": True, "model.encoder.use_dynamic_chunk": True,
        "model.encoder.static_chunk_size": 4, "model.encoder.dropout_rate": dropout,
        "model.encoder.positional_dropout_rate": dropout, "model.ctc_dropout_rate": dropout,
        "model.predictor.embed_size": 16, "model.predictor.hidden_size": 16,
        "model.predictor.output_size": 32, "model.joint.join_dim": 32,
        "feature.sample_rate": 16000, "optim.lr": 1e-3, "optim.warmup_steps": 1})
    return cfg


def tiny_batch(vocab: int = 32) -> dict:
    from tpuasr_torch.data import BatchSpec, make_batch, synth_corpus, tensors

    utts = synth_corpus(4, vocab, seed=0, min_tokens=2, max_tokens=3, samples_per_token=4096)
    return tensors(make_batch(utts, BatchSpec(4, 24 * 512, 6)), "cpu")


# ---------------------------------------------------------------- config


def test_mesh_config_round_trips(tmp_path):
    cfg = Config()
    cfg.mesh = MeshConfig(model_parallel_size=2, zero_stage="zero3")
    cfg.model.shard_joint = True
    save_yaml(cfg, tmp_path / "train.yaml")
    back = load_yaml(tmp_path / "train.yaml")
    assert back.mesh == cfg.mesh and back.model.shard_joint
    jc = JaxConfig()
    jc.mesh.model_parallel_size, jc.mesh.zero_stage, jc.model.shard_joint = 4, "zero1", True
    got = from_dict(Config, jax_to_dict(jc))
    assert dataclasses.asdict(got.mesh) == dataclasses.asdict(jc.mesh)
    assert got.model.shard_joint
    assert override(Config(), {"mesh.zero_stage": "zero1"}).mesh.zero_stage == "zero1"


@pytest.mark.parametrize("bad", [{"mesh.zero_stage": "zero2"},
                                 {"mesh.model_parallel_size": 0}])
def test_mesh_config_refuses(bad):
    with pytest.raises(ValueError):
        override(Config(), bad)


def test_model_size_must_divide_the_world():
    with pytest.raises(ValueError, match="does not divide"):
        rank_grid(6, 4)
    with pytest.raises(ValueError, match="does not divide"):
        Mesh(6, 0, 4)


# ---------------------------------------------------------------- layout


@pytest.mark.parametrize("mp", [1, 2, 4, 8])
def test_rank_grid_is_jax_mesh_layout(mp):
    devices = jax.devices("cpu")[:8]
    jm = jax_make_mesh(devices, model_parallel_size=mp)
    position = {d.id: i for i, d in enumerate(devices)}
    want = np.vectorize(lambda d: position[d.id])(jm.devices)
    grid = rank_grid(8, mp)
    np.testing.assert_array_equal(grid, want)
    for r in range(8):
        m = Mesh(8, r, mp)
        assert grid[m.data_rank, m.model_rank] == r
        assert m.data_size == 8 // mp


@pytest.mark.parametrize("mp", [1, 2, 4])
def test_shard_batch_is_jax_batch_sharding(mp):
    devices = jax.devices("cpu")[:8]
    jm = jax_make_mesh(devices, model_parallel_size=mp)
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    arr = jax.device_put(x, batch_sharding(jm))
    where = {d.id: idx for idx, d in np.ndenumerate(jm.devices)}
    ids = [f"u{i}" for i in range(16)]
    for shard in arr.addressable_shards:
        i, j = where[shard.device.id]
        got = shard_batch({"x": torch.from_numpy(x), "ids": ids, "n": np.int32(3)},
                          Mesh(8, i * mp + j, mp))
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(shard.data))
        assert got["ids"] == ids[shard.index[0]] and got["n"] == 3
    with pytest.raises(ValueError, match="not a multiple"):
        shard_batch({"x": torch.zeros(6)}, Mesh(8, 0, 2))


@pytest.mark.parametrize("vocab,parts", [(412, 2), (412, 4), (256, 4), (64, 3), (7, 7)])
def test_vocab_split_covers_the_vocabulary(vocab, parts):
    ranges = [vocab_range(vocab, parts, i) for i in range(parts)]
    assert ranges[0][0] == 0 and ranges[-1][1] == vocab
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(v1 > v0 for v0, v1 in ranges)


def test_vocab_split_refuses_an_empty_rank():
    with pytest.raises(ValueError, match="no column"):
        vocab_range(5, 4, 0)


# ---------------------------------------------------------------- ZeRO


@pytest.mark.parametrize("ranks", [1, 3, 4])
def test_zero_slices_round_trip(ranks):
    params = list(init_weights(Transducer(tiny_cfg().model, device="cpu"), 0).parameters())
    flat = flatten(params)
    n = flat.numel()
    parts = [ZeroShard(Mesh(ranks, r), "zero1", params).take(flat) for r in range(ranks)]
    assert all(p.numel() == -(-n // ranks) for p in parts)
    whole = torch.cat(parts)
    assert torch.equal(whole[:n], flat) and not whole[n:].any()


def test_zero3_parameters_release_and_return():
    model = init_weights(Transducer(tiny_cfg().model, device="cpu"), 0)
    before = flatten(list(model.parameters())).clone()
    state = TrainState.create(model, GuardedAdam(tiny_cfg().optim))
    with pytest.raises(AssertionError):
        assert_sharded(state, Mesh(4, 1), "zero1")  # whole moments
    shards = shard_train_state(state, Mesh(4, 1), "zero3")
    assert_sharded(shards, Mesh(4, 1), "zero3")
    zero = shards.zero
    assert zero.released and all(p.untyped_storage().nbytes() == 0 for p in model.parameters())
    assert torch.equal(zero.shard[:zero.hi - zero.lo], before[zero.lo:zero.hi])
    # at one rank the gather is the shard itself: materialize gives back every bit
    model = init_weights(Transducer(tiny_cfg().model, device="cpu"), 0)
    zero = ZeroShard(Mesh(1, 0), "zero3", list(model.parameters()))
    assert zero.released
    zero.materialize()
    assert torch.equal(flatten(list(model.parameters())), before)
    # a world of one keeps the whole state: no ZeRO layout
    state = TrainState.create(model, GuardedAdam(tiny_cfg().optim))
    assert shard_train_state(state, Mesh(1, 0), "zero1") is state


# ---------------------------------------------------------------- generators


def _pre_parallel(seed: int, step: int, salt: int | None) -> torch.Generator:
    """The seeding the port used before the parallel layer (salt None: the
    chunk generator)."""
    base = (seed * 0x9E3779B97F4A7C15 + step * 0xBF58476D1CE4E5B9) & MASK63
    return torch.Generator().manual_seed(base if salt is None else (base ^ salt) & MASK63)


def test_data_rank_zero_draws_the_old_bits_and_others_other_bits():
    cpu = torch.device("cpu")
    draw = lambda g: torch.rand(64, generator=g)
    for seed, step in ((2026, 0), (7, 13)):
        chunk0, drop0 = step_generators(seed, step, cpu)
        assert torch.equal(draw(chunk0), draw(_pre_parallel(seed, step, None)))
        assert torch.equal(draw(drop0), draw(_pre_parallel(seed, step, 0x94D049BB133111EB)))
        assert torch.equal(draw(specaug_generator(seed, step, cpu)),
                           draw(_pre_parallel(seed, step, 0x2545F4914F6CDD1D)))
        assert torch.equal(draw(sampler_generator(seed, step, cpu)),
                           draw(_pre_parallel(seed, step, 0x3C6EF372FE94F82B)))
        drops = [draw(step_generators(seed, step, cpu, r)[1]) for r in range(4)]
        chunks = [draw(step_generators(seed, step, cpu, r)[0]) for r in range(4)]
        assert all(torch.equal(c, chunks[0]) for c in chunks)  # one chunk draw a step
        for fn in (lambda r: drops[r], lambda r: draw(specaug_generator(seed, step, cpu, r)),
                   lambda r: draw(sampler_generator(seed, step, cpu, r))):
            got = [fn(r) for r in range(4)]
            assert all(not torch.equal(got[a], got[b]) for a in range(4) for b in range(a))


# ---------------------------------------------------------------- one rank


def test_cer_counts_at_one_rank():
    c = CerCounts(1, 2, 3, 40)
    assert allreduce_cer_counts(c) is c
    assert allreduce_cer_counts(c, Mesh(1, 0)) is c


def _reference_step(model, tx, cfg, state, batch, seed):
    """The pre-parallel train step, from its parts."""
    from tpuasr_torch.audio import fbank_batch, spec_augment

    chunk = _pre_parallel(seed, state.step, None)
    drop = _pre_parallel(seed, state.step, 0x94D049BB133111EB)
    sa = cfg.specaug
    with torch.no_grad():
        feats, lens = fbank_batch(batch["waves"], batch["wave_lens"], cfg.feature, device="cpu")
    feats = spec_augment(_pre_parallel(seed, state.step, 0x2545F4914F6CDD1D), feats, lens,
                         sa.num_t_masks, sa.num_f_masks, sa.max_t, sa.max_f)
    model.train()
    out = model(feats, lens, batch["texts"], batch["text_lens"], chunk_gen=chunk,
                dropout_gen=drop)
    params = list(model.parameters())
    out["loss"].backward()
    grads = [p.grad for p in params]
    with torch.no_grad():
        gn = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        finite = torch.isfinite(out["loss"].detach()) & torch.isfinite(gn)
        opt = tx.update_guarded(grads, state.opt_state, params, finite, state.lr_scale, gn)
    for p in params:
        p.grad = None
    return dataclasses.replace(state, opt_state=opt, step=state.step + 1), out["loss"].detach()


def test_step_without_a_mesh_is_the_pre_parallel_step():
    cfg = tiny_cfg(dropout=0.1)
    cfg.specaug.enabled = True
    batch = tiny_batch()
    runs = {}
    for how in ("reference", "no mesh", "one-rank mesh"):
        model = init_weights(Transducer(cfg.model, device="cpu"), 0)
        tx = GuardedAdam(cfg.optim)
        state = TrainState.create(model, tx)
        losses = []
        if how == "reference":
            for _ in range(2):
                state, loss = _reference_step(model, tx, cfg, state, batch, 5)
                losses.append(loss)
        else:
            step = make_train_step(model, tx, cfg, None if how == "no mesh" else Mesh(1, 0))
            for _ in range(2):
                state, m = step(state, batch, 5)
                losses.append(m["loss"])
        runs[how] = (torch.stack(losses), flatten(list(model.parameters())), state.opt_state)
    ref = runs["reference"]
    for how in ("no mesh", "one-rank mesh"):
        got = runs[how]
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), how
        for a, b in zip(got[2], ref[2]):
            assert (a is None and b is None) or torch.equal(a, b), how


# ---------------------------------------------------------------- shard_joint


def test_shard_joint_at_one_model_rank_is_the_materialized_route():
    r = np.random.default_rng(0)
    b, t, u, v, d = 3, 9, 4, 30, 8
    leaves = [torch.tensor(r.normal(0, s, shape), dtype=torch.float32, requires_grad=True)
              for s, shape in ((0.3, (d, v)), (0.1, (v,)), (1.0, (b, t, d)),
                               (1.0, (b, u + 1, d)))]
    labels = torch.tensor(r.integers(6, v, (b, u)))
    t_lens, u_lens = torch.tensor([9, 6, 0]), torch.tensor([4, 2, 3])
    w, bias, enc, pred = leaves
    want = rnnt_loss_from_logits(torch.tanh(enc[:, :, None] + pred[:, None]) @ w + bias,
                                 labels, t_lens, u_lens, 5)
    got = rnnt_loss_sharded(enc, pred, w, bias, labels, t_lens, u_lens, 5,
                            VocabShard(None, 0, 1))
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    for g, h in zip(torch.autograd.grad(got, leaves), torch.autograd.grad(want, leaves)):
        assert float((g - h).abs().max()) <= 1e-5 * float(h.abs().max()) + 1e-7


@pytest.mark.parametrize("head", ["postjoin", "hat", "hat_clipped", "hat_postjoin"])
def test_split_heads_at_one_model_rank_are_the_materialized_route(head):
    from tpuasr_torch.config import JointConfig
    from tpuasr_torch.nn.joint import TransducerJoint

    r = np.random.default_rng(1)
    b, t, u, v, d = 3, 9, 4, 30, 8
    cfg = JointConfig(join_dim=d, prejoin_linear=False, hat_joint=head.startswith("hat"),
                      postjoin_linear=head.endswith("postjoin"))
    joint = init_weights(TransducerJoint(cfg, d, d, v, blank_id=5), 0)
    if head == "hat_clipped":  # p_blank within 1e-6 of 1 on every cell: the clip binds
        with torch.no_grad():
            joint.blank_pred.bias.fill_(20.0)
    enc, pred = (torch.tensor(r.normal(0, 1, shape), dtype=torch.float32, requires_grad=True)
                 for shape in ((b, t, d), (b, u + 1, d)))
    labels = torch.tensor(r.integers(0, v, (b, u)))
    labels[0, 1] = 5  # a blank label reads the blank's column on both routes
    t_lens, u_lens = torch.tensor([9, 6, 0]), torch.tensor([4, 2, 3])
    leaves = [enc, pred, *joint.parameters()]
    want = rnnt_loss_from_logits(joint(enc, pred), labels, t_lens, u_lens, 5)
    got = rnnt_loss_sharded_joint(joint, enc, pred, labels, t_lens, u_lens, 5,
                                  VocabShard(None, 0, 1))
    assert abs(float(got.detach()) - float(want.detach())) <= 1e-5 * abs(float(want.detach()))
    for g, h in zip(torch.autograd.grad(got, leaves), torch.autograd.grad(want, leaves)):
        assert float((g - h).abs().max()) <= 1e-5 * float(h.abs().max()) + 1e-7


def test_shard_joint_refuses_a_hat_head_on_two_model_ranks(monkeypatch):
    """(Named for what the port did before the split heads: it raised.) A
    HAT head on two model ranks now takes the split route, `_hat_log_probs`;
    at one rank the materialized route."""
    import tpuasr_torch.losses.rnnt as rnnt

    calls = []
    split = rnnt._hat_log_probs
    monkeypatch.setattr(rnnt, "_hat_log_probs", lambda *a: calls.append(a) or split(*a))
    cfg = tiny_cfg()
    cfg.model.shard_joint = True
    cfg.model.joint.hat_joint = True
    model = init_weights(Transducer(cfg.model, device="cpu"), 0)
    feats, lens = torch.randn(2, 40, 80), torch.tensor([40, 30])
    texts, tlens = torch.tensor([[6, 7], [8, 9]]), torch.tensor([2, 2])
    model(feats, lens, texts, tlens, vocab_shard=VocabShard(None, 0, 1))  # one rank: no split
    assert not calls
    out = model(feats, lens, texts, tlens, vocab_shard=VocabShard(None, 0, 2))
    assert len(calls) == 1 and torch.isfinite(out["loss"])


# ---------------------------------------------------------------- loop pieces


def test_steps_per_epoch_reads_no_wave():
    utts = [Utterance(f"u{i}", None, np.arange(3 + i % 3, dtype=np.int32), (20 + 9 * i) * 512)
            for i in range(11)]

    def refuse(_):
        raise AssertionError("a wave was read")

    pipe = LengthBucketPipeline(utts, 2, (32, 64, 128), (8,), loader=refuse)
    loaded = LengthBucketPipeline(
        [dataclasses.replace(u, wave=np.zeros(u.wave_len, np.float32)) for u in utts], 2,
        (32, 64, 128), (8,))
    assert pipe.steps_per_epoch(3) == len(list(loaded.batches(3))) > 0
    assert pipe.last_skipped == loaded.last_skipped


def test_disabled_writer_writes_nothing(tmp_path, capsys):
    w = MetricsWriter(str(tmp_path / "tb"), str(tmp_path / "log.txt"), enabled=False)
    w.log("step 1")
    w.scalar("train/loss", 1.0, 1)
    w.close()
    assert capsys.readouterr().out == "" and not any(tmp_path.iterdir())
