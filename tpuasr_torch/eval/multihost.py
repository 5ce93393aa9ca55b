"""Cross-rank evaluation counts (port of ``tpuasr/eval/multihost.py``): at
several ranks each decodes its own rows, and the corpus CER sums the
ranks' S/D/I/N counts, never their strings."""

from __future__ import annotations

import torch

from tpuasr_torch.text.cer import CerCounts


def allreduce_cer_counts(local: CerCounts, mesh=None) -> CerCounts:
    """Sum CER counts over the ranks: one int64 all-reduce of (S, D, I, N)
    over the mesh's data group (the ranks of a model group decode the same
    rows), or over every rank without a mesh. The identity at one rank."""
    import torch.distributed as dist

    from tpuasr_torch.parallel.mesh import all_reduce

    if mesh is None:
        if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() == 1:
            return local
        nccl = dist.get_backend() == "nccl"
        dev = torch.device("cuda", torch.cuda.current_device()) if nccl else torch.device("cpu")
    elif mesh.data_size == 1:
        return local
    else:
        dev = mesh.device
    vec = torch.tensor([local.substitutions, local.deletions, local.insertions,
                        local.ref_len], dtype=torch.int64, device=dev)
    if mesh is None:
        all_reduce(vec, dist.group.WORLD)
    else:
        mesh.reduce(vec)
    s, d, i, n = (int(x) for x in vec.cpu())
    return CerCounts(s, d, i, n)
