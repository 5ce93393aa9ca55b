"""What splitting the joint's vocabulary over the model axis buys, and that
it changes no number (port of ``tools/tp_joint_bench.py``).

The materialized RNN-T route (`model.shard_joint`, the tanh joint ->
[B, T, U+1, V] logits -> log-softmax -> the lattice, the mean loss and its
gradients to W, b and both activations), run two ways:

- `analyze`: each rank's peak CUDA memory (`torch.cuda.max_memory_allocated`
  over the call, above what was allocated before it) for the loss and its
  gradients unsharded on one rank, and with the vocabulary split over the
  mesh's model ranks. It stands in for the JAX tool's compiled memory
  analysis, which PyTorch has no counterpart of: the figures are measured
  on the card, not predicted.
- `execution_parity`: at a small shape (B4 T48 U12 V256 D64, the JAX
  tool's), the dp x tp loss and gradients against the unsharded route on
  the whole batch, tolerance 2e-4.

Run it on N ranks (the mesh is N / tp data ranks x tp model ranks):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m tpuasr_torch.tools.tp_joint_bench --tp 2 [--execute]

(`--device cpu` runs the plain lattice over gloo; on one card two ranks take
gloo with `--backend gloo`, as NCCL refuses two ranks on one device.)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

FIELDS = ("w", "b", "enc_p", "pred_p")


def make_joint_loss(blank_id: int = 5, shard=None):
    """-> step(w, b, enc_p, pred_p, labels, t_lens, u_lens) -> (mean loss,
    its gradients to (w, b, enc_p, pred_p)); `shard` (a `VocabShard`)
    splits the logits over its group's vocabulary."""
    from tpuasr_torch.losses import rnnt_loss_from_logits, rnnt_loss_sharded

    def step(w, b, enc_p, pred_p, labels, t_lens, u_lens):
        leaves = [x.detach().requires_grad_() for x in (w, b, enc_p, pred_p)]
        w_, b_, enc, pred = leaves
        if shard is None:
            logits = torch.tanh(enc[:, :, None] + pred[:, None]) @ w_ + b_
            loss = rnnt_loss_from_logits(logits, labels, t_lens, u_lens, blank_id, "mean")
        else:
            loss = rnnt_loss_sharded(enc, pred, w_, b_, labels, t_lens, u_lens, blank_id, shard)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), grads

    return step


def parity_inputs(b: int = 4, t: int = 48, u: int = 12, v: int = 256, d: int = 64) -> dict:
    """The JAX tool's small-shape inputs (tools/tp_joint_bench.py:
    execution_parity), drawn alike from numpy's seed 0."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {"w": rng.normal(0, 0.05, (d, v)).astype(f32), "b": np.zeros((v,), f32),
            "enc_p": rng.normal(size=(b, t, d)).astype(f32),
            "pred_p": rng.normal(size=(b, u + 1, d)).astype(f32),
            "labels": rng.integers(6, v, (b, u)).astype(np.int32),
            "t_lens": np.asarray([t, t - 5, t - 9, t // 2], np.int32)[:b],
            "u_lens": np.asarray([u, u - 2, u - 1, u // 2], np.int32)[:b]}


def _sharded_step(mesh, inputs: dict, blank_id: int = 5):
    """This rank's rows through the vocabulary-split route -> (the whole
    batch's loss, its gradients {w, b, enc_p, pred_p}): the data ranks'
    losses and W / b gradients summed with rows weights, the activations'
    gradients gathered in row order."""
    from tpuasr_torch.parallel import shard_batch

    rows = shard_batch({k: inputs[k] for k in ("enc_p", "pred_p", "labels", "t_lens",
                                               "u_lens")}, mesh)
    share = rows["enc_p"].shape[0] / inputs["enc_p"].shape[0]
    loss, grads = make_joint_loss(blank_id, mesh.vocab_shard())(
        inputs["w"], inputs["b"], rows["enc_p"], rows["pred_p"], rows["labels"],
        rows["t_lens"], rows["u_lens"])
    head = mesh.reduce(torch.cat([loss.reshape(1), grads[0].reshape(-1),
                                  grads[1].reshape(-1)]) * share)
    out = {"loss": head[0]}
    n_w = inputs["w"].numel()
    out["w"] = head[1:1 + n_w].view_as(inputs["w"])
    out["b"] = head[1 + n_w:].view_as(inputs["b"])
    for name, g in zip(("enc_p", "pred_p"), grads[2:]):
        whole = mesh.gather((g * share).reshape(-1))
        out[name] = whole.view((-1,) + tuple(g.shape[1:]))
    return out


def execution_parity(mesh, b: int = 4, t: int = 48, u: int = 12, v: int = 256, d: int = 64,
                     tol: float = 2e-4, device="cpu") -> dict:
    """dp x tp on `mesh` (every rank calls it) == the unsharded route on the
    whole batch: the loss within tol (relative above 1), every gradient
    within rtol 5e-4 and atol tol. (The JAX tool's atol is 5e-5; on the
    CPU the port's unsharded fp32 route lies 1.46e-4 from a float64
    evaluation at one entry of W's blank column, the split route 6.5e-5.)
    -> the sharded {loss, w, b, enc_p, pred_p} as numpy arrays, for a
    caller to hold against another reference."""
    inputs = {k: torch.from_numpy(x).to(device) for k, x in parity_inputs(b, t, u, v, d).items()}
    got = _sharded_step(mesh, inputs)
    loss_ref, grads_ref = make_joint_loss()(*(inputs[k] for k in FIELDS),
                                            inputs["labels"], inputs["t_lens"], inputs["u_lens"])
    if abs(float(got["loss"]) - float(loss_ref)) > tol * max(1.0, abs(float(loss_ref))):
        raise AssertionError(f"dp x tp loss {float(got['loss'])} != unsharded "
                             f"{float(loss_ref)}")
    for name, ref in zip(FIELDS, grads_ref):
        np.testing.assert_allclose(got[name].cpu().numpy(), ref.cpu().numpy(), rtol=5e-4,
                                   atol=tol, err_msg=name)
    return {k: x.detach().cpu().numpy() for k, x in got.items()}


def analyze(mesh, b: int, t: int, u: int, v: int, d: int, device="cuda") -> dict:
    """Each rank's peak CUDA memory for the loss and its gradients (every
    rank calls it): rank 0 alone on the whole batch unsharded (the others
    wait), then every rank on its rows with the vocabulary split over the
    mesh's model ranks. -> bytes: the logits' size, rank 0's unsharded
    peak, each rank's sharded peak."""
    import torch.distributed as dist

    from tpuasr_torch.parallel.mesh import all_gather_flat, barrier

    g = torch.Generator().manual_seed(0)
    inputs = {"w": torch.randn(d, v, generator=g) * 0.05, "b": torch.zeros(v),
              "enc_p": torch.randn(b, t, d, generator=g),
              "pred_p": torch.randn(b, u + 1, d, generator=g),
              "labels": torch.randint(6, v, (b, u), generator=g, dtype=torch.int32),
              "t_lens": torch.full((b,), t, dtype=torch.int32),
              "u_lens": torch.full((b,), u, dtype=torch.int32)}
    inputs = {k: x.to(device) for k, x in inputs.items()}

    def peak(fn) -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn()
        torch.cuda.synchronize()
        used = torch.cuda.max_memory_allocated() - base
        del out
        torch.cuda.empty_cache()
        return used

    res = {"logits_bytes": b * t * (u + 1) * v * 4, "tp": mesh.model_parallel_size,
           "dp": mesh.data_size}
    unsharded = 0
    if mesh.rank == 0:
        step = make_joint_loss()
        unsharded = peak(lambda: step(*(inputs[k] for k in FIELDS), inputs["labels"],
                                      inputs["t_lens"], inputs["u_lens"]))
    barrier()
    sharded = peak(lambda: _sharded_step(mesh, inputs))
    world = dist.group.WORLD if mesh.world_size > 1 else None
    everyone = all_gather_flat(torch.tensor([sharded], dtype=torch.float64, device=device),
                               world, mesh.world_size)
    res["unsharded_peak_bytes_rank0"] = int(unsharded)
    res["sharded_peak_bytes_per_rank"] = [int(x) for x in everyone.tolist()]
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--b", type=int, default=8)
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--u", type=int, default=128)
    ap.add_argument("--v", type=int, default=4096)
    ap.add_argument("--d", type=int, default=256)
    ap.add_argument("--tp", type=int, default=2, help="model ranks (must divide the world)")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None, help="nccl | gloo (default: by device)")
    ap.add_argument("--execute", action="store_true",
                    help="also run the small-shape dp x tp parity check")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from tpuasr_torch.parallel import init_distributed, make_mesh

    created = not dist.is_initialized()
    world, rank, device = init_distributed(args.device, backend=args.backend)
    try:
        mesh = make_mesh(args.tp if world > 1 else 1, device)
        out = {}
        if device.type == "cuda":
            out["analysis"] = analyze(mesh, args.b, args.t, args.u, args.v, args.d, device)
            if rank == 0:
                a = out["analysis"]
                print(f"shape B{args.b} T{args.t} U{args.u} V{args.v} d{args.d} fp32, "
                      f"dp{a['dp']} x tp{a['tp']} on {torch.cuda.get_device_name(device)}: "
                      f"logits {a['logits_bytes'] / 2**30:.2f} GiB; peak unsharded (rank 0) "
                      f"{a['unsharded_peak_bytes_rank0'] / 2**30:.2f} GiB; peak sharded per "
                      f"rank {[round(x / 2**30, 2) for x in a['sharded_peak_bytes_per_rank']]}"
                      f" GiB")
        if args.execute:
            out["parity_loss"] = float(execution_parity(mesh, device=device)["loss"])
            if rank == 0:
                print(f"execution parity (B4 T48 U12 V256 D64): dp x tp == unsharded "
                      f"(loss {out['parity_loss']:.4f})")
        return out
    finally:
        if created and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
