"""Multi-host scaling prediction from the collectives the port's step
issues (port of ``tpuasr/parallel/scaling.py``).

The JAX package compiles its sharded step over a virtual device mesh and
parses the collectives out of XLA's HLO (`parse_collectives`). The port has
no compiler in the way: every collective of its step goes through one of two
choke points, `parallel.mesh.all_reduce` and `all_gather_flat`, and while a
`record_collectives()` context is open each call appends a `Collective`
(op, payload bytes per rank, the group's global ranks) to the context's
list. The step runs for real, on as many ranks as the layout has, so the
bytes are what it sends. Costing them is the JAX module's ring /
hierarchical model (`comm_report`, `rescale_for_hosts`, `predict`), with the
same arguments and outputs. One formula differs: a reduce-scatter's input
p·g crosses (cc-1)/cc of itself on the links inside a host and (h-1)/h of
itself across hosts, where `tpuasr/parallel/scaling.py:153-156` divides the
two by h and by cc. (The port's step issues no reduce-scatter today.)

Ranks map to hosts as rank // chips_per_host (torchrun's node-major order).
Only the link speeds are assumptions, stated as such: NVLink 4 at 450 GB/s
a GPU one way (NVIDIA's H100 SXM data sheet: 900 GB/s bidirectional), and a
DGX H100 host's eight ConnectX-7 NICs at 400 Gb/s each, 400 GB/s a host
(NVIDIA's DGX H100 user guide). Both are arguments of `predict`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

NVLINK_GBPS = 450.0  # GB/s a GPU one way, NVLink 4 (an assumption: the data sheet's figure)
NIC_GBPS = 400.0     # GB/s a host, 8 x 400 Gb/s (an assumption: the DGX H100's NICs)


@dataclass
class Collective:
    op: str  # all-reduce | all-gather | reduce-scatter | collective-permute | all-to-all
    payload: int  # per-rank result bytes
    groups: list  # lists of global ranks


@dataclass
class CommReport:
    """Per-step communication, split by link class."""

    ici_bytes: float = 0.0  # per-GPU bytes over the links inside a host (NVLink)
    dcn_bytes: float = 0.0  # per-host bytes over the host's NICs
    by_op: dict = field(default_factory=dict)


_OPEN: list[list[Collective]] = []


@contextlib.contextmanager
def record_collectives():
    """While open, every collective of `parallel.mesh` (`all_reduce`,
    `all_gather_flat`) on a group of more than one rank appends its
    `Collective` to the list this yields, in call order. Nothing is recorded,
    synced or copied when no context is open."""
    got: list[Collective] = []
    _OPEN.append(got)
    try:
        yield got
    finally:
        _OPEN.remove(got)


def recording() -> bool:
    return bool(_OPEN)


def note(op: str, payload: int, ranks) -> None:
    """Append one collective to every open record."""
    for got in _OPEN:
        got.append(Collective(op, int(payload), [list(ranks)]))


def comm_report(colls: list[Collective], chips_per_host: int, n_hosts: int) -> CommReport:
    """Ring/hierarchical wire-byte model of one step's collectives.

    Payloads are per rank. For a group of g = h·c ranks spanning h hosts:
      all-reduce   -> NVLink 2(c-1)/c·p per GPU, NIC 2(h-1)/h·p per host
      all-gather   -> (c-1)/c·p, (h-1)/h·p   (p = gathered bytes)
      reduce-scatter -> (c-1)/c·pin, (h-1)/h·pin   (pin = input bytes = g·p)
      collective-permute -> p on whichever link the pair crosses
      all-to-all   -> (g-1)/g·p split by in/cross-host peers
    """
    rep = CommReport()
    for c in colls:
        if not c.groups or not c.groups[0]:
            continue
        # the groups partition the ranks and run at once on disjoint links:
        # one group's cost is the per-GPU cost
        grp = c.groups[0]
        h = len({d // chips_per_host for d in grp})
        g = len(grp)
        cc = max(1, g // h)
        p = float(c.payload)
        ici = dcn = 0.0
        if c.op == "all-reduce":
            ici = 2.0 * (cc - 1) / cc * p
            dcn = 2.0 * (h - 1) / h * p
        elif c.op == "all-gather":
            ici = (cc - 1) / cc * p
            dcn = (h - 1) / h * p
        elif c.op == "reduce-scatter":
            pin = p * g
            ici = (cc - 1) / cc * pin
            dcn = (h - 1) / h * pin
        elif c.op == "collective-permute":
            if h > 1:
                dcn = p
            else:
                ici = p
        elif c.op == "all-to-all":
            ici = (cc - 1) / g * p
            dcn = (g - cc) / g * p
        if h == 1:
            dcn = 0.0
        rep.by_op.setdefault(c.op, [0.0, 0.0])
        rep.by_op[c.op][0] += ici
        rep.by_op[c.op][1] += dcn
    for ici, dcn in rep.by_op.values():
        rep.ici_bytes += ici
        rep.dcn_bytes += dcn
    return rep


def rescale_for_hosts(colls: list[Collective], chips_per_host: int, compiled_hosts: int,
                      target_hosts: int) -> list[Collective]:
    """The recorded layout's collectives extrapolated to another host count.

    Weak scaling on the data axis: per-rank payloads do not depend on the
    host count (gradients are parameter-shaped; ZeRO slices shrink as 1/N,
    kept at the recorded size: conservative beyond it). A group that spans
    every recorded host spans every target host."""
    out = []
    for c in colls:
        new_groups = []
        for grp in c.groups:
            hosts = {d // chips_per_host for d in grp}
            if len(hosts) == compiled_hosts and compiled_hosts > 1:
                cc = max(1, len(grp) // len(hosts))
                new_groups.append([h * chips_per_host + (d % chips_per_host)
                                   for h in range(target_hosts) for d in grp[:cc]])
            else:
                new_groups.append(grp)
        out.append(Collective(c.op, c.payload, new_groups))
    return out


def relayout(colls: list[Collective], world: int, model_parallel_size: int,
             target_world: int, target_model_parallel_size: int | None = None
             ) -> list[Collective]:
    """Rank 0's collectives recorded at `world` ranks of a (data x model)
    layout laid over `target_world` ranks, payloads unchanged (weak scaling
    on the data axis, as `rescale_for_hosts`): a model group (mp consecutive
    ranks) becomes ranks 0..tmp-1, a data group (every mp-th rank) the
    target's 0, tmp, .., target_world - tmp, where tmp is the target's
    model axis (by default the recorded one)."""
    mp = model_parallel_size
    tmp = mp if target_model_parallel_size is None else target_model_parallel_size
    model = list(range(tmp))
    data = list(range(0, target_world, tmp))
    out = []
    for c in colls:
        grp = c.groups[0]
        is_model = mp > 1 and grp == list(range(grp[0], grp[0] + mp))
        out.append(Collective(c.op, c.payload, [model if is_model else data]))
    return out


def predict(colls: list[Collective], chips_per_host: int, n_hosts: int, compute_ms: float,
            ici_gbps: float = NVLINK_GBPS, dcn_gbps: float = NIC_GBPS) -> dict:
    """One step's predicted communication and scaling efficiency: compute
    plus the links' time with no overlap, and the larger of the two with
    full overlap. `ici_gbps` is the in-host link (NVLink) a GPU, `dcn_gbps`
    the NICs a host (GB/s, assumptions)."""
    rep = comm_report(colls, chips_per_host, n_hosts)
    t_ici = rep.ici_bytes / (ici_gbps * 1e9) * 1e3
    t_dcn = rep.dcn_bytes / (dcn_gbps * 1e9) * 1e3
    no_overlap = compute_ms / (compute_ms + t_ici + t_dcn)
    full_overlap = compute_ms / max(compute_ms, t_ici + t_dcn)
    return {
        "hosts": n_hosts,
        "chips_per_host": chips_per_host,
        "ici_mb": rep.ici_bytes / 1e6,
        "dcn_mb": rep.dcn_bytes / 1e6,
        "t_compute_ms": compute_ms,
        "t_ici_ms": t_ici,
        "t_dcn_ms": t_dcn,
        "eff_no_overlap": no_overlap,
        "eff_full_overlap": full_overlap,
        "by_op": {k: (v[0] / 1e6, v[1] / 1e6) for k, v in rep.by_op.items()},
    }
