"""ZeRO stages over the data axis (port of ``tpuasr/parallel/zero.py``).

- "none": parameters and optimizer state replicated; the step all-reduces
  the flat gradient and every rank applies the whole update (DDP's layout).
- "zero1": the optimizer's moments (mu, nu, nu_max, and with
  optim.accum_steps > 1 the gradient mean acc, as JAX shards the whole
  opt_state, MultiSteps' accumulator included) are split over the data
  ranks; each rank updates its slice of the parameters and the slices are
  all-gathered into every rank's parameters.
- "zero3": a rank also keeps only its slice of the parameters between
  steps; the whole vector is gathered for a step (or an evaluation, or a
  save) and released after it.

The JAX package gives each leaf a `NamedSharding` that splits its largest
divisible dimension (`leaf_spec`): a layout, which changes no number. The
port's optimizer already keeps its state as flat fp32 vectors over the
parameters in order and updates them elementwise (`GuardedAdam.update_flat`),
so its idiom is a contiguous slice of the flat vector: ceil(N / n) entries
a rank, the last slice zero-padded. Zero entries stay zero through the
update. A step gathers the whole tree at once; a per-block gather, as FSDP
does it, is a later memory item.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from tpuasr_torch.config import MESH_STAGES as STAGES
from tpuasr_torch.parallel.mesh import Mesh
from tpuasr_torch.train.optim import FusedAdamState, flatten, unflatten


def shard_bounds(n: int, parts: int, index: int) -> tuple[int, int, int]:
    """-> (lo, hi, chunk): slice `index` of ceil(n / parts) entries of a
    flat vector of n, [lo, hi) inside it (the last one shorter)."""
    chunk = -(-n // parts)
    lo = min(n, index * chunk)
    return lo, min(n, lo + chunk), chunk


class ZeroShard:
    """One rank's part of the ZeRO layout of a model's flat parameter vector:
    its bounds, and with zero3 the slice of the parameters it keeps and the
    flat buffer whose views the model's parameters are."""

    def __init__(self, mesh: Mesh, stage: str, params: Sequence[torch.Tensor]):
        if stage not in STAGES[1:]:
            raise ValueError(f"ZeroShard stage {stage!r} not in {STAGES[1:]}")
        self.mesh, self.stage = mesh, stage
        params = list(params)
        self.n = sum(p.numel() for p in params)
        self.lo, self.hi, self.chunk = shard_bounds(self.n, mesh.data_size, mesh.data_rank)
        self.flat: Optional[torch.Tensor] = None
        self.shard: Optional[torch.Tensor] = None
        if stage == "zero3":
            dev = params[0].device
            self.flat = torch.zeros(self.chunk * mesh.data_size, dtype=torch.float32,
                                    device=dev)
            off = 0
            with torch.no_grad():
                for p in params:
                    self.flat[off:off + p.numel()].copy_(p.reshape(-1))
                    p.data = self.flat[off:off + p.numel()].view_as(p)
                    off += p.numel()
            self.shard = self.flat[self.lo:self.lo + self.chunk].clone()
            self.release()

    def take(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's slice of a flat vector of n, zero-padded to `chunk`."""
        s = flat[self.lo:self.hi]
        return F.pad(s, (0, self.chunk - s.numel())) if s.numel() < self.chunk else s

    def gather(self, part: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every data rank's slice, concatenated: the flat vector of n."""
        if out is None:
            return self.mesh.gather(part)[:self.n]
        self.mesh.gather(part, out=out)
        return out[:self.n]

    def norm(self, part: torch.Tensor) -> torch.Tensor:
        """The global L2 norm of a vector sliced as this layout slices it."""
        sq = (part * part).sum()
        return torch.sqrt(self.mesh.reduce(sq))

    @property
    def released(self) -> bool:
        return self.flat is not None and self.flat.untyped_storage().nbytes() == 0

    def materialize(self) -> None:
        """zero3: gather the whole parameter vector into the model's
        parameters (a no-op when they are whole, and for zero1)."""
        if self.released:
            self.flat.untyped_storage().resize_(self.flat.numel() * self.flat.element_size())
            self.gather(self.shard, out=self.flat)

    def release(self) -> None:
        """zero3: free the whole parameter vector (the parameters keep their
        shapes; their storage holds nothing until `materialize`)."""
        if self.flat is not None:
            self.flat.untyped_storage().resize_(0)

    def update(self, tx, grads: Sequence[torch.Tensor], state: FusedAdamState,
               params: Sequence[torch.Tensor], finite: torch.Tensor,
               lr_scale, grad_norm: torch.Tensor) -> FusedAdamState:
        """One optimizer step on this rank's slice (`GuardedAdam.update_flat`
        with the global norm), then the parameters: zero1 all-gathers the
        updated slices into every rank's parameters, zero3 keeps its slice."""
        p = self.shard if self.stage == "zero3" else self.take(flatten(params))
        p, state = tx.update_flat(self.take(flatten(grads)), p, state, finite, lr_scale,
                                  grad_norm, norm=self.norm)
        if self.stage == "zero3":
            self.shard.copy_(p)
        else:
            torch._foreach_copy_(list(params), unflatten(self.gather(p), params))
        return state


def _opt_map(opt: FusedAdamState, fn) -> FusedAdamState:
    """`fn` on every flat vector of the optimizer state (count and
    mini_step are scalars and stay)."""
    return opt._replace(**{k: None if getattr(opt, k) is None else fn(getattr(opt, k))
                           for k in ("mu", "nu", "nu_max", "acc")})


def shard_train_state(state, mesh: Mesh, stage: str):
    """A whole (one-rank) TrainState -> this rank's ZeRO layout of it: the
    moments sliced, and with zero3 the parameters too. "none", or a data
    axis of one rank, returns `state` as it is."""
    if stage not in STAGES:
        raise ValueError(f"zero stage {stage!r} not in {STAGES}")
    if stage == "none" or mesh.data_size == 1:
        return state
    zero = ZeroShard(mesh, stage, list(state.model.parameters()))
    opt = _opt_map(state.opt_state, lambda v: zero.take(v).clone())
    return dataclasses.replace(state, opt_state=opt, zero=zero)


@contextlib.contextmanager
def whole_state(state):
    """Every rank: the state as one rank holds it, for a save or an
    evaluation pass: the moments gathered and zero3's parameters
    materialized (released again on exit). Without ZeRO, `state` itself."""
    zero = state.zero
    if zero is None:
        yield state
        return
    zero.materialize()
    try:
        yield dataclasses.replace(state, opt_state=_opt_map(state.opt_state, zero.gather),
                                  zero=None)
    finally:
        if zero.stage == "zero3":
            zero.release()


def assert_sharded(state, mesh: Mesh, stage: str) -> None:
    """Every rank holds ceil(N / n) entries of each flat vector the stage
    shards (the moments; zero3 also the parameters, whose whole vector is
    released); raises AssertionError otherwise."""
    if stage == "none":
        return
    want = -(-sum(p.numel() for p in state.model.parameters()) // mesh.data_size)
    held = {k: v.numel() for k, v in state.opt_state._asdict().items()
            if k in ("mu", "nu", "nu_max", "acc") and v is not None}
    zero = state.zero
    if stage == "zero3":
        if zero is None or not zero.released:
            raise AssertionError("zero3: the whole parameter vector is still held")
        held["params"] = zero.shard.numel()
    bad = {k: v for k, v in held.items() if v != want}
    if bad or not held:
        raise AssertionError(f"{stage}: slices {held} of a vector, each should hold {want}")
