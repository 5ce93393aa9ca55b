"""Train and eval steps (port of ``tpuasr/train/step.py``).

One step: waves -> log-mel fbank on the device (kernel #1, no gradient) ->
SpecAugment when `specaug.enabled` (training only) -> the model's hybrid
loss forward (the transducer's RNN-T + CTC or the AED model's CTC +
attention; dropout, dynamic chunk) -> backward -> global gradient norm,
finite flag -> the NaN-guarded `GuardedAdam` update (`AccumulatingAdam`
with optim.accum_steps > 1). The CTC workload's steps
(`make_ctc_train_step`, `make_ctc_eval_step`) take the same path without
SpecAugment and the chunk draw. Nothing in a step waits for the host: the
metrics stay device tensors.

Randomness comes from an explicit seed per call, folded with the step
count as `jax.random.fold_in(rng, state.step)` does (step.py:109): the same
seed and step give the same dropout masks and chunk draw on the same device,
another seed other ones. Dropout draws from a generator on the model's
device; the dynamic-chunk draw, two host integers, from a CPU generator, so
building the mask never syncs. SpecAugment draws from a third generator of
its own on the device, as the JAX step splits off a fourth key for it
(tpuasr/train/step.py:50), so turning it on changes no dropout mask or
chunk draw. A Paraformer's glancing sampler draws from a fourth generator
on the device, passed on training steps only (the JAX step gives its
"sampler" rng to training steps alone, so its dev pass does not sample).
The bits differ from JAX's (another generator); the distributions are the
same.

With a `mesh` (`tpuasr_torch.parallel`) a step is one data rank's share of
the step on the concatenated batch, and sharding changes no number:
- each loss term is scaled by this rank's share of its normalizer before
  `backward()` (the losses are means over utterances, so rows; the
  Paraformer's quantity losses are sums over target tokens divided by
  their count, so tokens): one small all-reduce of the counts;
- after `backward()` one all-reduce over the data group sums the flat
  gradient and the scaled loss, its parts and the audio seconds, so the
  global gradient norm and the finite flag are the same on every rank and a
  step is skipped everywhere or nowhere;
- the update is `GuardedAdam`'s, on this rank's ZeRO slice where the state
  carries one (`tpuasr_torch.parallel.zero`);
- the dropout, SpecAugment and sampler generators fold in the data rank
  (rank 0 draws the bits a world of one draws), since two data ranks hold
  different rows; the model rank is folded into none (the model ranks of a
  data group run the same encoder on the same rows), nor is anything folded
  into the chunk draw, one draw a step for the whole batch as JAX's.
The Transducer gets the mesh's model axis (`Mesh.vocab_shard`) for
`model.shard_joint`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from tpuasr_torch.audio import fbank_batch, spec_augment
from tpuasr_torch.config import Config
from tpuasr_torch.train.optim import FusedAdamState, GuardedAdam, flatten, unflatten

_MASK63 = (1 << 63) - 1
# a data rank's terms are scaled by its share of their normalizer
# (`_DataShare`): rows for the per-utterance means, target tokens for these
TOKEN_PARTS = ("th_accuracy", "loss_quantity", "loss_quantity_tp")
METRIC_PARTS = ("loss_rnnt", "loss_ctc", "loss_att", "th_accuracy")


def _base(seed: int, step: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + int(step) * 0xBF58476D1CE4E5B9) & _MASK63


def _fold(base: int, data_rank: int) -> int:
    """`base` with the data rank folded in; rank 0 keeps it as it is."""
    return (base ^ (data_rank * 0xD1B54A32D192ED03)) & _MASK63


def step_generators(seed: int, step: int, device: torch.device, data_rank: int = 0
                    ) -> tuple[torch.Generator, torch.Generator]:
    """(chunk generator on the CPU, dropout generator on `device`) for one
    step, seeded from (seed, step); the dropout one also from the data
    rank, the chunk one never."""
    base = _base(seed, step)
    chunk = torch.Generator().manual_seed(base)
    drop = torch.Generator(device=device).manual_seed(
        (_fold(base, data_rank) ^ 0x94D049BB133111EB) & _MASK63)
    return chunk, drop


def specaug_generator(seed: int, step: int, device: torch.device,
                      data_rank: int = 0) -> torch.Generator:
    """SpecAugment's generator on `device` for one step, seeded from (seed,
    step, data rank) apart from `step_generators`' two."""
    return torch.Generator(device=device).manual_seed(
        (_fold(_base(seed, step), data_rank) ^ 0x2545F4914F6CDD1D) & _MASK63)


def sampler_generator(seed: int, step: int, device: torch.device,
                      data_rank: int = 0) -> torch.Generator:
    """The glancing sampler's generator on `device` for one step, seeded
    from (seed, step, data rank) apart from the other three."""
    return torch.Generator(device=device).manual_seed(
        (_fold(_base(seed, step), data_rank) ^ 0x3C6EF372FE94F82B) & _MASK63)


@dataclass
class TrainState:
    """The model (its parameters), the optimizer state, the host step
    count (it seeds the step's generators, so it never needs a sync), the
    plateau scale, the device count of NaN-skipped steps and, under ZeRO,
    this rank's `ZeroShard` (the opt_state then holds its slices)."""

    model: torch.nn.Module
    opt_state: FusedAdamState
    step: int
    lr_scale: float
    skipped: torch.Tensor
    zero: Optional[Any] = None

    @classmethod
    def create(cls, model: torch.nn.Module, tx: GuardedAdam) -> "TrainState":
        params = list(model.parameters())
        return cls(model, tx.init(params), 0, 1.0,
                   torch.zeros((), dtype=torch.int32, device=params[0].device))


def _features(model, cfg: Config, batch: dict):
    with torch.no_grad():
        return fbank_batch(batch["waves"], batch["wave_lens"], cfg.feature, device=model.device)


def _backward_and_update(state: TrainState, tx: GuardedAdam, loss: torch.Tensor,
                         reduce: Optional[Callable] = None):
    """loss.backward(), the global gradient norm, the finite flag and the
    guarded update; -> (new state, loss, grad norm, finite). `reduce`
    (grads, loss) -> (grads, loss) sums them over the data ranks first."""
    model = state.model
    params = list(model.parameters())
    loss.backward()
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    with torch.no_grad():
        if reduce is not None:
            grads, loss = reduce(grads, loss)
        grad_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        loss = loss.detach()
        finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
        opt_state = tx.update_guarded(grads, state.opt_state, params, finite,
                                      state.lr_scale, grad_norm, zero=state.zero)
    for p in params:
        p.grad = None
    return (dataclasses.replace(state, opt_state=opt_state, step=state.step + 1,
                                skipped=state.skipped + (~finite).to(torch.int32)),
            loss, grad_norm, finite)


def _target_tokens(model, batch: dict) -> torch.Tensor:
    """The step's target tokens: the AED decoder's and the Paraformer's (with
    add_eos) count an <eos> a row."""
    from tpuasr_torch.models.asr_model import ASRModel
    from tpuasr_torch.models.paraformer import Paraformer

    eos = 1 if isinstance(model, ASRModel) else \
        int(model.cfg.add_eos) if isinstance(model, Paraformer) else 0
    return batch["text_lens"].sum() + eos * batch["text_lens"].shape[0]


def _token_normalized(model, out: dict) -> Optional[torch.Tensor]:
    """The part of out["loss"] divided by the target tokens rather than the
    rows: the Paraformer's quantity losses (`nn.cif.quantity_loss`)."""
    from tpuasr_torch.models.paraformer import Paraformer

    if not isinstance(model, Paraformer):
        return None
    q = model.cfg.quantity_weight * out["loss_quantity"]
    return q + out["loss_quantity_tp"] if "loss_quantity_tp" in out else q


class _DataShare:
    """One data rank's share of a step on the concatenated batch: each loss
    term scaled by this rank's share of its normalizer (rows, or target
    tokens for TOKEN_PARTS), so that the gradients and the scaled values
    summed over the data ranks are the whole batch's."""

    def __init__(self, model, mesh, out: dict, batch: dict, sample_rate: int):
        self.mesh = mesh
        rows = batch["text_lens"].shape[0]
        local = torch.stack([torch.full((), float(rows), device=batch["text_lens"].device),
                             _target_tokens(model, batch).float()])
        self.share = local / mesh.reduce(local.clone())
        q = _token_normalized(model, out)
        loss = out["loss"]
        self.objective = loss * self.share[0] if q is None else \
            (loss - q) * self.share[0] + q * self.share[1]
        self.parts = {k: out[k].detach() * self.share[int(k in TOKEN_PARTS)]
                      for k in METRIC_PARTS if k in out}
        self.audio = batch["wave_lens"].sum() / sample_rate

    def reduce(self, grads, loss):
        """After backward: one all-reduce of the flat gradient and the
        scaled metrics -> (the global gradient as views, the global loss)."""
        vec = torch.cat([flatten(grads),
                         torch.stack([loss.detach().float(), self.audio.float(),
                                      *(v.float() for v in self.parts.values())])])
        self.mesh.reduce(vec)
        n = vec.numel() - 2 - len(self.parts)
        loss, self.audio, *parts = vec[n:]
        self.parts = dict(zip(self.parts, parts))
        return unflatten(vec[:n], grads), loss


def _data_share(model, mesh, out: dict, batch: dict, cfg: Config) -> Optional[_DataShare]:
    if mesh is None or mesh.data_size == 1:
        return None
    return _DataShare(model, mesh, out, batch, cfg.feature.sample_rate)


def _vocab_shard(model, mesh) -> dict:
    """The Transducer's forward keyword for `model.shard_joint`."""
    from tpuasr_torch.models.transducer import Transducer

    if mesh is None or not isinstance(model, Transducer):
        return {}
    return {"vocab_shard": mesh.vocab_shard()}


def make_train_step(model: torch.nn.Module, tx: GuardedAdam, cfg: Config,
                    mesh=None) -> Callable:
    """-> train_step(state, batch, seed) -> (state, metrics). batch: waves
    [B, N] (float or int16 PCM), wave_lens, texts [B, U], text_lens on the
    model's device (with a `mesh`: this data rank's rows). The model is a
    Transducer, an ASRModel (the AED workload) or a Paraformer (given its
    sampler's generator). metrics: loss, the model's loss_rnnt, loss_ctc,
    loss_att and th_accuracy where it has them, grad_norm, finite,
    audio_seconds, all device tensors (with a mesh, the whole batch's). The
    model is put in train() mode."""
    from tpuasr_torch.models.paraformer import Paraformer

    sa = cfg.specaug
    samples = isinstance(model, Paraformer)
    rank = 0 if mesh is None else mesh.data_rank
    shard = _vocab_shard(model, mesh)

    def train_step(state: TrainState, batch: dict, seed: int):
        if state.zero is not None:
            state.zero.materialize()
        chunk_gen, drop_gen = step_generators(seed, state.step, model.device, rank)
        feats, feat_lens = _features(model, cfg, batch)
        if sa.enabled:
            feats = spec_augment(specaug_generator(seed, state.step, model.device, rank), feats,
                                 feat_lens, sa.num_t_masks, sa.num_f_masks, sa.max_t, sa.max_f)
        model.train()
        for p in model.parameters():
            p.grad = None
        extra = {"sampler_gen": sampler_generator(seed, state.step, model.device, rank)} \
            if samples else {}
        out = model(feats, feat_lens, batch["texts"], batch["text_lens"],
                    chunk_gen=chunk_gen, dropout_gen=drop_gen, **extra, **shard)
        return _finish(state, tx, out, _data_share(model, mesh, out, batch, cfg), batch, cfg)

    return train_step


def _finish(state: TrainState, tx: GuardedAdam, out: dict, share: Optional[_DataShare],
            batch: dict, cfg: Config):
    """The step's backward, update and metrics (METRIC_PARTS of `out`)."""
    if share is None:
        new_state, loss, grad_norm, finite = _backward_and_update(state, tx, out["loss"])
        audio = batch["wave_lens"].sum() / cfg.feature.sample_rate
        parts = {k: out[k].detach() for k in METRIC_PARTS if k in out}
    else:
        new_state, loss, grad_norm, finite = _backward_and_update(state, tx, share.objective,
                                                                  share.reduce)
        audio, parts = share.audio, share.parts
    if new_state.zero is not None:
        new_state.zero.release()
    return new_state, {"loss": loss, "grad_norm": grad_norm, "finite": finite,
                       "audio_seconds": audio, **parts}


def make_eval_step(model: torch.nn.Module, cfg: Config, mesh=None) -> Callable:
    """-> eval_step(batch, seed) -> loss dict (no update, no dropout; the
    chunk draw still comes from the seed, as the JAX eval step passes its
    chunk rng). The model is put in eval() mode. With a `mesh` the batch is
    this data rank's rows and the loss theirs (`train_loop` averages the
    ranks); zero3's parameters must be whole (`parallel.zero.whole_state`)."""
    shard = _vocab_shard(model, mesh)

    @torch.no_grad()
    def eval_step(batch: dict, seed: int):
        chunk_gen, _ = step_generators(seed, 0, model.device)
        feats, feat_lens = _features(model, cfg, batch)
        model.eval()
        return model(feats, feat_lens, batch["texts"], batch["text_lens"],
                     chunk_gen=chunk_gen, **shard)

    return eval_step


def make_ctc_train_step(model: torch.nn.Module, tx: GuardedAdam, cfg: Config,
                        mesh=None) -> Callable:
    """The CTC workload's step (`CTCModel`; tools/train.py:251-300):
    -> train_step(state, batch, seed) -> (state, metrics). fbank (kernel #1
    on the card), no SpecAugment and no chunk draw, the model's CTC loss
    with dropout from the step's generator, the guarded update. metrics:
    loss, grad_norm, finite, audio_seconds, all device tensors. A `mesh`
    works as in `make_train_step`."""
    rank = 0 if mesh is None else mesh.data_rank

    def train_step(state: TrainState, batch: dict, seed: int):
        if state.zero is not None:
            state.zero.materialize()
        _, drop_gen = step_generators(seed, state.step, model.device, rank)
        feats, feat_lens = _features(model, cfg, batch)
        model.train()
        for p in model.parameters():
            p.grad = None
        _, _, loss = model(feats, feat_lens, batch["texts"], batch["text_lens"],
                           dropout_gen=drop_gen)
        out = {"loss": loss}
        return _finish(state, tx, out, _data_share(model, mesh, out, batch, cfg), batch, cfg)

    return train_step


def make_ctc_eval_step(model: torch.nn.Module, cfg: Config, mesh=None) -> Callable:
    """-> eval_step(batch, seed) -> {"loss"}: the dev loss, no dropout
    (tools/train.py:313-318); `mesh` as in `make_eval_step` (the CTC model
    has no model axis to use)."""

    @torch.no_grad()
    def eval_step(batch: dict, seed: int):
        feats, feat_lens = _features(model, cfg, batch)
        model.eval()
        return {"loss": model(feats, feat_lens, batch["texts"], batch["text_lens"])[2]}

    return eval_step
