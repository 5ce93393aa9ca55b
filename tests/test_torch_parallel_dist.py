"""The port's parallel layer across real ranks: torch.distributed gloo
process groups on the CPU, started as subprocesses by this file (run as a
script, it is the rank worker), against the port at one rank and the JAX
package.

Each launch starts its ranks with a FileStore in the test's tmp_path (no
port is opened, so parallel test workers never collide); every collective
waits at most 120 s (the process group's timeout), the parent waits at most
LAUNCH_S for all ranks and kills every rank as soon as one fails. Each rank
writes its results to tmp_path and the parent, which has JAX, compares them:

- `none` / `zero1` / `zero3` on 4 ranks, three steps on test_zero.py's tiny
  transducer and batch (8 rows, 2 a rank; dynamic chunks, no dropout;
  Adam at lr 1e-4, warmup 1, so a wrong slice moves a weight by ~1e-4,
  five times the tolerance, while an entry whose gradient is rounding noise
  on both sides, such as a key projection's bias, stays inside it: at lr
  1e-3 18 of 103,264 such entries moved 4.2e-5 apart)
  against the port's 1-rank steps on the whole batch: losses 1e-5,
  parameters 2e-5 (test_zero.py's tolerances), each rank holding ceil(N/4)
  of every sharded vector (`assert_sharded`); the first step's reduced
  gradient against the 1-rank one, each leaf 1e-4 of its max + 1e-6.
- The first reduced gradient and global loss at 4 ranks (a static chunk,
  so both packages mask alike) against `jax.grad` of the JAX model's loss
  on the whole batch, on the same features and weights: loss atol 1e-4,
  each leaf 1e-4 of its max + 1e-6 (tests/test_torch_train.py's).
- The recorded static step (`scaling.record_collectives` open) is the
  unrecorded one bit for bit; its collectives are the counts' all-reduce
  and one all-reduce of the flat gradient's bytes plus the metrics
  vector's. `scaling_predict.record_layout` at each layout (dp, zero1,
  zero3, dptp) records the collectives that layout's step issues.
- `model.shard_joint` on a 2 x 2 mesh: `tp_joint_bench.execution_parity`
  (which holds the dp x tp route against the port's unsharded one) against
  the JAX tool's unsharded route on the same inputs: the loss 2e-4
  relative, each gradient 2e-4 of its largest entry (XLA's fp32 route
  itself lies 3.7e-4 from a float64 evaluation at W's blank column, whose
  largest entry is 8.0; the split route 6.5e-5); and a whole train step
  with shard_joint against the 1-rank materialized step, for the plain
  head, the HAT and a post-join linear (the last two also against
  `jax.grad` of the JAX model's loss: loss atol 1e-4, each leaf 1e-4 of
  its max + 1e-6).
- Sharded streaming greedy and beam (beam 3, CTC fusion 0.3) on 4 ranks
  against JAX's `make_sharded_streaming_decode` on test_sharded_decode.py's
  inputs and weights: tokens and lengths identical, on every rank.
- At 2 ranks: CER counts summed as tests/multiproc_worker.py expects; two
  ranks whose shards bucket into 3 and 4 batches both run 3 steps; a zero3
  checkpoint written by `train_loop` at 2 ranks, restored at 1 rank,
  gives the 2-rank run's next step (loss 1e-5, parameters 2e-5).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
LAUNCH_S = 420
PG_TIMEOUT_S = 120
LOSS_TOL, PARAM_TOL, GRAD_REL = 1e-5, 2e-5, 1e-4
STAGES = ("none", "zero1", "zero3")
HEADS = ("hat", "postjoin")
# the scaling tool's rank side at a tiny width: 2 rows of 48 frames a rank
TOOL_SETS = ("model.encoder.num_blocks=1", "model.encoder.output_size=32",
             "model.encoder.attention_heads=2", "model.encoder.linear_units=64",
             "model.encoder.cnn_module_kernel=7", "model.vocab_size=64",
             "model.predictor.output_size=32", "model.predictor.embed_size=16",
             "model.predictor.hidden_size=16", "model.joint.join_dim=32",
             "model.compute_dtype=float32")
CHUNK, LEFT, BLANK = 4, 2, 5  # tests/test_streaming.py's


# ---------------------------------------------------------------------------
# what both sides build (no JAX here: the rank workers import this module)
# ---------------------------------------------------------------------------


def tiny_cfg(dynamic: bool = True, shard_joint: bool = False, head: str = "plain"):
    """test_zero.py's tiny transducer in the port's config: vocab 64, d32,
    2 causal blocks, no dropout; dynamic chunks (static 4) or the static
    chunk 4; the joint's head plain, "hat" or "postjoin"; Adam at lr 1e-4
    with warmup 1."""
    from tpuasr_torch.config import (
        Config, EncoderConfig, JointConfig, ModelConfig, PredictorConfig,
    )

    cfg = Config()
    cfg.model = ModelConfig(
        vocab_size=64, blank_id=5, ctc_dropout_rate=0.0, shard_joint=shard_joint,
        encoder=EncoderConfig(output_size=32, attention_heads=2, linear_units=64, num_blocks=2,
                              cnn_module_kernel=7, dropout_rate=0.0,
                              positional_dropout_rate=0.0, causal=True,
                              use_dynamic_chunk=dynamic, static_chunk_size=4),
        predictor=PredictorConfig(embed_size=16, hidden_size=16, output_size=32),
        joint=JointConfig(hat_joint=head == "hat", postjoin_linear=head == "postjoin"))
    cfg.feature.sample_rate = 16000
    cfg.optim.lr, cfg.optim.warmup_steps = 1e-4, 1
    return cfg


def tiny_batch(vocab: int = 64) -> dict:
    """test_zero.py's batch: 8 synthetic utterances, 24 x 512 samples, 6
    tokens, as CPU tensors."""
    from tpuasr_torch.data import BatchSpec, make_batch, synth_corpus, tensors

    utts = synth_corpus(8, vocab, seed=0, min_tokens=2, max_tokens=3, samples_per_token=4096)
    return tensors(make_batch(utts, BatchSpec(8, 24 * 512, 6)), "cpu")


def tiny_model(cfg):
    from tpuasr_torch.models import Transducer, init_weights

    return init_weights(Transducer(cfg.model, device="cpu"), 0)


def keeping_optimizer(cfg):
    """GuardedAdam that keeps the (reduced) flat gradient of its last step."""
    from tpuasr_torch.train import GuardedAdam
    from tpuasr_torch.train.optim import flatten

    class Keep(GuardedAdam):
        def update_guarded(self, grads, state, params, finite, lr_scale=1.0, grad_norm=None,
                           zero=None):
            self.kept = flatten(grads).clone()
            return super().update_guarded(grads, state, params, finite, lr_scale, grad_norm,
                                          zero)

    return Keep(cfg.optim)


def run_steps(cfg, batch, mesh=None, stage="none", n_steps=3, state=None):
    """`n_steps` train steps (seed 1) -> (losses, the first step's gradient,
    the whole flat parameters after, the state)."""
    from tpuasr_torch.parallel import shard_batch, shard_train_state, whole_state
    from tpuasr_torch.train import TrainState, make_train_step
    from tpuasr_torch.train.optim import flatten

    tx = keeping_optimizer(cfg)
    if state is None:
        state = TrainState.create(tiny_model(cfg), tx)
    if mesh is not None:
        if state.zero is None:
            state = shard_train_state(state, mesh, stage)
        batch = shard_batch(batch, mesh)
    step = make_train_step(state.model, tx, cfg, mesh)
    losses, first = [], None
    for _ in range(n_steps):
        state, m = step(state, batch, 1)
        losses.append(float(m["loss"]))
        first = tx.kept if first is None else first
    with whole_state(state) as whole:
        params = flatten(list(whole.model.parameters())).detach().clone()
    return losses, first, params, state


def unequal_pipeline(rank: int):
    """A rank's shard that buckets into 3 batches (rank 0: six short
    utterances) or 4 (rank 1: three short, three long), batch size 2."""
    from tpuasr_torch.data import LengthBucketPipeline, Utterance

    r = np.random.default_rng(rank)
    lens = [20 * 512] * 6 if rank == 0 else [20 * 512] * 3 + [40 * 512] * 3
    utts = [Utterance(f"r{rank}u{i}", (0.1 * r.standard_normal(n)).astype(np.float32),
                      np.array([6, 7, 8], np.int32), n) for i, n in enumerate(lens)]
    return LengthBucketPipeline(utts, 2, (32, 64), (6,), hop_length=512)


# ---------------------------------------------------------------------------
# the rank worker
# ---------------------------------------------------------------------------


def _worker(job: str, rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(1)
    from tpuasr_torch.parallel import init_distributed, make_mesh

    init_distributed("cpu", store_path=os.path.join(tmp, f"store_{job}"), rank=rank,
                     world_size=world, timeout_s=PG_TIMEOUT_S)
    out = {"main4": _job_main4, "two": _job_two}[job](rank, make_mesh, tmp)
    torch.save(out, os.path.join(tmp, f"{job}_{rank}.pt"))
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    print(f"rank {rank} DONE", flush=True)


def _job_main4(rank: int, make_mesh, tmp: str) -> dict:
    from tpuasr_torch.models import Transducer
    from tpuasr_torch.parallel import (
        assert_sharded, make_sharded_streaming_decode, record_collectives,
    )
    from tpuasr_torch.tools.scaling_predict import LAYOUTS, base_config, record_layout
    from tpuasr_torch.tools.tp_joint_bench import execution_parity

    mesh, mesh22 = make_mesh(1), make_mesh(2)
    batch = tiny_batch()
    out = {"stages": {}}
    for stage in STAGES:
        losses, first, params, state = run_steps(tiny_cfg(), batch, mesh, stage)
        assert_sharded(state, mesh, stage)
        out["stages"][stage] = {"losses": losses, "grad": first, "params": params}
    out["static"] = run_steps(tiny_cfg(dynamic=False), batch, mesh, n_steps=1)[:2]
    with record_collectives() as got:
        out["static_recorded"] = run_steps(tiny_cfg(dynamic=False), batch, mesh, n_steps=1)[:2]
    out["static_collectives"] = [(c.op, c.payload, c.groups) for c in got]
    base = base_config(TOOL_SETS)
    out["layouts"] = {layout: [(c.op, c.payload, c.groups) for c in
                               record_layout(base, layout, "cpu", 2, 48, 6)]
                      for layout in LAYOUTS}
    out["joint_parity"] = execution_parity(mesh22)
    for head in ("plain",) + HEADS:
        out[f"shard_joint_{head}"] = run_steps(
            tiny_cfg(dynamic=False, shard_joint=True, head=head), batch, mesh22, n_steps=1)[:2]
    # (written by this test's parent: a config dataclass beside the tensors)
    dec = torch.load(os.path.join(tmp, "decode_inputs.pt"), weights_only=False)
    model = Transducer(dec["cfg"], device="cpu")
    model.load_state_dict(dec["weights"])
    out["decode"] = {}
    for mode in ("greedy", "beam"):
        fn = make_sharded_streaming_decode(
            model, mesh, mode, chunk_size=CHUNK, num_left_chunks=LEFT, blank_id=BLANK,
            beam_size=3, max_tokens=24, ctc_weight=0.3 if mode == "beam" else 0.0)
        out["decode"][mode] = [x.clone() for x in fn(dec["feats"], dec["feat_lens"])]
    return out


def _job_two(rank: int, make_mesh, tmp: str) -> dict:
    from tpuasr_torch.data import synthetic_pipeline
    from tpuasr_torch.eval.multihost import allreduce_cer_counts
    from tpuasr_torch.text.cer import CerCounts
    from tpuasr_torch.train import TrainState, make_optimizer, train_loop

    mesh = make_mesh(1)
    total = allreduce_cer_counts(CerCounts(rank + 1, 2 * (rank + 1), 0, 10 * (rank + 1)), mesh)
    out = {"cer": (total.substitutions, total.deletions, total.insertions, total.ref_len)}

    cfg = tiny_cfg()
    cfg.train.log_dir, cfg.train.save_dir = "", ""
    model = tiny_model(cfg)
    res = train_loop(cfg, model, TrainState.create(model, make_optimizer(cfg.optim)),
                     unequal_pipeline(rank), epochs=1, mesh=mesh)
    out["unequal"] = {"steps": res.state.step, "own": unequal_pipeline(rank).steps_per_epoch(0)}

    # zero3: an epoch of one batch a rank through train_loop, which saves
    # "latest" gathered; then the next step at 2 ranks on the whole batch
    cfg.train.save_dir = os.path.join(tmp, "ckpt")
    cfg.mesh.zero_stage = "zero3"
    cfg.data.batch_size = 4
    cfg.data.synth_min_tokens, cfg.data.synth_max_tokens = 2, 3
    model = tiny_model(cfg)
    res = train_loop(cfg, model, TrainState.create(model, make_optimizer(cfg.optim)),
                     synthetic_pipeline(cfg, 8, seed=0, host_id=rank, num_hosts=2), epochs=1,
                     mesh=mesh)
    losses, _, params, _ = run_steps(cfg, tiny_batch(), mesh, "zero3", n_steps=1,
                                     state=res.state)
    out["resume"] = {"step": res.state.step, "loss": losses[0], "params": params}
    return out


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def _launch(job: str, world: int, tmp_path: Path, during=None) -> list:
    """Start `world` ranks of `job`, run `during()` meanwhile, wait for all
    (at most LAUNCH_S; a failed rank kills the others at once) -> each
    rank's results and `during`'s."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    logs = [open(tmp_path / f"{job}_{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, job, str(r), str(world),
                               str(tmp_path)], stdout=logs[r], stderr=subprocess.STDOUT,
                              cwd=ROOT, env=env) for r in range(world)]
    try:
        side = during() if during is not None else None
        deadline = time.monotonic() + LAUNCH_S
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = []
    for f in logs:
        f.seek(0)
        texts.append(f.read())
        f.close()
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0 and f"rank {r} DONE" in text, \
            f"{job} rank {r} exited {p.returncode}:\n{text[-4000:]}"
    # the ranks' own files (numpy arrays among the results)
    return [torch.load(tmp_path / f"{job}_{r}.pt", weights_only=False)
            for r in range(world)], side


@pytest.fixture(scope="module")
def main4(tmp_path_factory):
    """The 4-rank launch, with the JAX references computed while it runs."""
    tmp = tmp_path_factory.mktemp("main4")
    decode = _decode_setup(tmp)
    return _launch("main4", 4, tmp, lambda: _jax_references(decode))


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("two")
    ranks, _ = _launch("two", 2, tmp)
    return ranks, tmp


def _decode_setup(tmp: Path) -> dict:
    """test_sharded_decode.py's model, weights and inputs: the JAX params,
    and the port's copy of them saved for the ranks."""
    import jax

    from tests.test_streaming import causal_cfg
    from tpuasr.config import to_dict
    from tpuasr.models import Transducer as JaxTransducer
    from tpuasr_torch.config import ModelConfig, from_dict
    from tpuasr_torch.convert import load_jax_params
    from tpuasr_torch.models import Transducer

    jc = causal_cfg()
    jm = JaxTransducer(jc)
    r = np.random.default_rng(7)
    b, t = 8, 93
    feats = r.standard_normal((b, t, 80)).astype(np.float32)
    feat_lens = np.asarray([t, 51, t, 33, 77, t, 62, 45], np.int32)
    params = jm.init(jax.random.PRNGKey(0), feats, feat_lens, np.zeros((b, 5), np.int32),
                     np.full((b,), 5, np.int32))
    pc = from_dict(ModelConfig, to_dict(jc))
    port = load_jax_params(Transducer(pc, device="cpu"), jax.tree.map(np.asarray, params))
    torch.save({"cfg": pc, "weights": port.state_dict(), "feats": torch.from_numpy(feats),
                "feat_lens": torch.from_numpy(feat_lens)}, tmp / "decode_inputs.pt")
    return {"model": jm, "params": params, "feats": feats, "feat_lens": feat_lens}


def _jax_references(decode: dict) -> dict:
    """JAX's sharded streaming decodes, its tp joint's unsharded route and
    the JAX model's loss and gradient on the whole tiny batch."""
    import jax

    from tools.tp_joint_bench import make_joint_loss
    from tpuasr.parallel import batch_sharding
    from tpuasr.parallel import make_mesh as jax_make_mesh
    from tpuasr.parallel import make_sharded_streaming_decode as jax_sharded_decode
    from tpuasr_torch.tools.tp_joint_bench import parity_inputs

    out = {"decode": {}}
    mesh = jax_make_mesh(jax.devices("cpu")[:8])
    sh = batch_sharding(mesh)
    for mode in ("greedy", "beam"):
        fn = jax_sharded_decode(decode["model"], mesh, mode, chunk_size=CHUNK,
                                num_left_chunks=LEFT, blank_id=BLANK, beam_size=3,
                                max_tokens=24, ctc_weight=0.3 if mode == "beam" else 0.0)
        toks, lens = fn(decode["params"], jax.device_put(decode["feats"], sh),
                        jax.device_put(decode["feat_lens"], sh))
        out["decode"][mode] = (np.asarray(toks), np.asarray(lens))
    p = parity_inputs()
    loss, grads = jax.jit(make_joint_loss())(*(p[k] for k in ("w", "b", "enc_p", "pred_p",
                                                                 "labels", "t_lens", "u_lens")))
    out["joint"] = {"loss": float(loss), **{k: np.asarray(g) for k, g in
                                           zip(("w", "b", "enc_p", "pred_p"), grads)}}
    for head in ("plain",) + HEADS:
        out[head] = _jax_loss_and_grad(head)
    return out


def _jax_loss_and_grad(head: str) -> dict:
    """The JAX model's loss and gradient on the whole tiny batch (static
    chunk, the joint's `head`), on the port's features (fbank has no
    gradient) and the port's seeded weights in the flax layout."""
    import jax

    from tests.test_torch_zoo import flax_variables
    from tpuasr.config import ModelConfig as JaxModelConfig
    from tpuasr.config import from_dict as jax_from_dict
    from tpuasr.models import Transducer as JaxTransducer
    from tpuasr_torch.audio import fbank_batch
    from tpuasr_torch.config import to_dict
    from tpuasr_torch.convert import convert_params

    cfg = tiny_cfg(dynamic=False, head=head)
    batch = tiny_batch()
    feats, feat_lens = fbank_batch(batch["waves"], batch["wave_lens"], cfg.feature,
                                   device="cpu")
    args = (feats.numpy(), feat_lens.numpy().astype(np.int32), batch["texts"].numpy(),
            batch["text_lens"].numpy())
    jm = JaxTransducer(jax_from_dict(JaxModelConfig, to_dict(cfg.model)))
    variables = flax_variables(jm, tiny_model(cfg), *args)

    def loss_fn(p):
        return jm.apply({"params": p}, *args)["loss"]

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    return {"loss": float(loss), "grads": convert_params(jax.tree.map(np.asarray, grads))}


def _leaves_close(got: torch.Tensor, want: torch.Tensor, cfg) -> None:
    """Two flat gradients in the model's parameter order: each leaf within
    1e-4 of the leaf's max + 1e-6."""
    named = list(tiny_model(cfg).named_parameters())
    sizes = [p.numel() for _, p in named]
    for (name, _), g, w in zip(named, got.split(sizes), want.split(sizes)):
        err = float((g - w).abs().max())
        assert err <= GRAD_REL * float(w.abs().max()) + 1e-6, (name, err)


def _flat(named: dict, cfg) -> torch.Tensor:
    """Named leaves (`convert_params`) -> a flat vector in the model's order."""
    return torch.cat([named[n].reshape(-1).float()
                      for n, _ in tiny_model(cfg).named_parameters()])


@pytest.mark.parametrize("stage", STAGES)
def test_zero_stages_match_one_rank(main4, stage):
    (ranks, _) = main4
    losses, first, params, _ = run_steps(tiny_cfg(), tiny_batch())
    for r in ranks:
        got = r["stages"][stage]
        np.testing.assert_allclose(got["losses"], losses, rtol=LOSS_TOL, atol=LOSS_TOL)
        np.testing.assert_allclose(got["params"].numpy(), params.numpy(), rtol=PARAM_TOL,
                                   atol=PARAM_TOL)
    _leaves_close(ranks[0]["stages"][stage]["grad"], first, tiny_cfg())
    # the three steps moved the weights by more than the tolerance
    assert float((params - run_steps(tiny_cfg(), tiny_batch(), n_steps=0)[2]).abs().max()) \
        > 5 * PARAM_TOL


def test_reduced_gradient_matches_jax(main4):
    ranks, ref = main4
    loss, grad = ranks[0]["static"]
    want = ref["plain"]
    assert abs(loss[0] - want["loss"]) <= 1e-4, (loss, want["loss"])
    cfg = tiny_cfg(dynamic=False)
    _leaves_close(grad, _flat(want["grads"], cfg), cfg)
    for r in ranks[1:]:
        assert torch.equal(r["static"][1], grad)  # every rank holds the same gradient


def test_shard_joint_matches_jax(main4):
    ranks, ref = main4
    want = ref["joint"]
    for r in ranks:
        got = r["joint_parity"]
        assert abs(float(got["loss"]) - want["loss"]) <= 2e-4 * max(1.0, abs(want["loss"]))
        for k in ("w", "b", "enc_p", "pred_p"):
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= 2e-4 * float(np.abs(want[k]).max()) + 1e-6, (k, err)


@pytest.mark.parametrize("head", ("plain",) + HEADS)
def test_shard_joint_step_matches_one_rank(main4, head):
    ranks, ref = main4
    cfg = tiny_cfg(dynamic=False, head=head)
    losses, first, _, _ = run_steps(cfg, tiny_batch(), n_steps=1)
    for r in ranks:
        loss, grad = r[f"shard_joint_{head}"]
        assert abs(loss[0] - losses[0]) <= 1e-5 * abs(losses[0]), (loss, losses)
        _leaves_close(grad, first, cfg)
    if head in HEADS:  # and the JAX model's loss and gradient on the whole batch
        loss, grad = ranks[0][f"shard_joint_{head}"]
        want = ref[head]
        assert abs(loss[0] - want["loss"]) <= 1e-4, (loss, want["loss"])
        _leaves_close(grad, _flat(want["grads"], cfg), cfg)


def test_recorded_step_and_its_collectives(main4):
    ranks, _ = main4
    n = sum(p.numel() for p in tiny_model(tiny_cfg(dynamic=False)).parameters())
    for r in ranks:
        (loss, grad), (loss_r, grad_r) = r["static"], r["static_recorded"]
        assert loss == loss_r and torch.equal(grad, grad_r)  # recording changes no bit
        # the rows' and targets' counts, then the flat gradient with the
        # metrics (loss, audio seconds, loss_rnnt, loss_ctc), over all 4 ranks
        assert r["static_collectives"] == [("all-reduce", 2 * 4, [[0, 1, 2, 3]]),
                                           ("all-reduce", 4 * n + 4 * 4, [[0, 1, 2, 3]])]


def test_scaling_tool_records_each_layout(main4):
    from tpuasr_torch.parallel.scaling import Collective
    from tpuasr_torch.tools.scaling_predict import base_config, prediction_rows

    ranks, _ = main4
    base = base_config(TOOL_SETS)
    n = sum(p.numel() for p in tiny_model(base).parameters())
    every, slice_ = [0, 1, 2, 3], -(-n // 4)
    grads = ("all-reduce", 4 * n + 4 * 4, [every])
    counts = ("all-reduce", 8, [every])
    got = ranks[0]["layouts"]
    assert got["dp"] == [counts, grads]
    assert got["zero1"] == [counts, grads, ("all-gather", 4 * 4 * slice_, [every])]
    assert got["zero3"] == [("all-gather", 4 * 4 * slice_, [every]), counts, grads]
    # 2 data x 2 model ranks: the split joint's all-reduces over rank 0's model
    # group (forward: max, sum, the owners' logits; backward: the activations'
    # and the head's gradients), the counts and the gradient over its data group
    tp = got["dptp"]
    assert [c for c in tp if c[2] == [[0, 2]]] == [("all-reduce", 8, [[0, 2]]),
                                                   ("all-reduce", 4 * n + 4 * 4, [[0, 2]])]
    assert [c[0] for c in tp if c[2] == [[0, 1]]] == ["all-reduce"] * 5 and len(tp) == 7
    rows = prediction_rows([Collective(*c) for c in got["dp"]], 2, 2, [2, 4], 100.0, 450.0,
                           400.0)
    p = (4 * n + 24) / 1e6
    assert rows[0]["ici_mb"] == pytest.approx(p) and rows[0]["dcn_mb"] == pytest.approx(p)
    assert rows[1]["dcn_mb"] == pytest.approx(1.5 * p)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_sharded_decode_matches_jax(main4, mode):
    ranks, ref = main4
    want_t, want_l = ref["decode"][mode]
    for r in ranks:
        toks, lens = r["decode"][mode]
        np.testing.assert_array_equal(lens.numpy(), want_l)
        np.testing.assert_array_equal(toks.numpy(), want_t)


def test_cer_counts_sum(two):
    ranks, _ = two
    for r in ranks:
        assert r["cer"] == (3, 6, 0, 30)


def test_unequal_shards_end_the_epoch_together(two):
    ranks, _ = two
    assert [r["unequal"]["own"] for r in ranks] == [3, 4]
    assert [r["unequal"]["steps"] for r in ranks] == [3, 3]


def test_zero_checkpoint_resumes_at_one_rank(two):
    from tpuasr_torch.train import TrainState, latest_path, restore_checkpoint

    ranks, tmp = two
    cfg = tiny_cfg()
    path = latest_path(str(tmp / "ckpt"))
    n = sum(p.numel() for p in tiny_model(cfg).parameters())
    saved = torch.load(path, weights_only=True)
    assert saved["opt_state"]["mu"].numel() == n  # whole vectors, whatever the world size
    state = restore_checkpoint(path, TrainState.create(tiny_model(cfg),
                                                       keeping_optimizer(cfg)))
    assert state.step == ranks[0]["resume"]["step"] == 1
    losses, _, params, _ = run_steps(cfg, tiny_batch(), n_steps=1, state=state)
    for r in ranks:
        assert abs(r["resume"]["loss"] - losses[0]) <= LOSS_TOL * max(1.0, abs(losses[0]))
        np.testing.assert_allclose(r["resume"]["params"].numpy(), params.numpy(),
                                   rtol=PARAM_TOL, atol=PARAM_TOL)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
