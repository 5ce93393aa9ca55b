"""RNN-Transducer loss (port of ``tpuasr/losses/rnnt.py``).

- The joint's log-probs reduce to two lattice inputs, blank_lp [B, T, U+1]
  and label_lp [B, T, U].
- Padding: for t >= t_len, blank_lp := 0 (a free blank) and label_lp := -1e30,
  so every path drifts to the last frame; labels past u_len get -1e30; the
  likelihood is read per row at (T-1, u_len). -1e30 stands in for -inf.
- The lattice is `tpuasr_torch.ops.rnnt_lattice` (kernels #8/#9 on the
  card, the plain anti-diagonal lattice on the CPU), whose backward is the
  closed-form occupancy gradient.
- Infeasible rows (e.g. t_len = 0) give loss 0 and gradient 0.

`rnnt_loss_from_logits` is the materialized route (the joint's full
[B, T, U+1, V] logits), as `tpuasr/ops/rnnt_pallas.py:221-250` runs it on
an accelerator: an fp32 log-softmax, the blank and label gather, the masking,
the lattice, and the infeasible-row guard here with the caller.
"""

from __future__ import annotations

import torch

from tpuasr_torch.ops.rnnt_lattice import _NEG, mask_lattice_inputs, rnnt_lattice


def zero_infeasible(ll: torch.Tensor) -> torch.Tensor:
    """-ll, or 0 with gradient 0 where the row has no alignment."""
    nll = -ll
    return torch.where(ll > _NEG / 2, nll, nll.detach() * 0.0)


def rnnt_loss(log_probs: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
              u_lens: torch.Tensor, blank: int) -> torch.Tensor:
    """Per-utterance negative log-likelihood [B]; log_probs [B, T, U+1, V]
    log-softmaxed, labels [B, U]."""
    u = log_probs.shape[2] - 1
    blank_lp = log_probs[..., blank]
    label_lp = log_probs[:, :, :u].gather(
        3, labels.long()[:, None, :, None].expand(-1, log_probs.shape[1], -1, 1))[..., 0]
    blank_m, label_m, _, _ = mask_lattice_inputs(blank_lp, label_lp, t_lens, u_lens)
    return zero_infeasible(rnnt_lattice(blank_m, label_m, u_lens))


def rnnt_loss_from_logits(logits: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
                          u_lens: torch.Tensor, blank: int,
                          reduction: str = "mean") -> torch.Tensor:
    """Raw joint logits [B, T, U+1, V] in, reduced loss out (log-softmax in
    fp32). CPU tensors take the plain lattice, CUDA tensors kernels #8/#9."""
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rnnt_loss_from_logits: unsupported device {logits.device}")
    nll = rnnt_loss(torch.log_softmax(logits.float(), dim=-1), labels, t_lens, u_lens, blank)
    return _reduce(nll, reduction)


class _ShardedJointLogProbs(torch.autograd.Function):
    """The plain joint head over one model rank's vocabulary slice, with the
    log-softmax taken across the model group: (enc_p [B, T, D], pred_p
    [B, U+1, D], W [D, V], b [V], labels [B, U]) -> the whole vocabulary's
    (blank_lp [B, T, U+1], label_lp [B, T, U]) in fp32, the same on every
    rank of the group.

    Forward: this rank's logits [B, T, U+1, V / tp] in the compute type (the
    activation of enc_p + pred_p, times its columns of W, plus its b), their
    max all-reduced (MAX), the exponentials' sums all-reduced (SUM), and the
    blank and label logits from the rank that owns each column (one SUM).
    Backward recomputes the slice: its logits' gradient stays local, and so
    do the products to its columns of W and b; the gradients to enc_p and
    pred_p are partial sums over the vocabulary and are summed over the
    group, and the W and b gradients are gathered over it (a SUM of slices
    zero elsewhere), so every rank of the group holds the whole head's."""

    @staticmethod
    def forward(ctx, enc_p, pred_p, w, b, labels, blank: int, act: str, shard):
        from tpuasr_torch.nn.joint import ACT

        blank_lp, label_lp, lse = _split_log_softmax(
            ACT[act](enc_p[:, :, None] + pred_p[:, None]), w, b, labels, blank, shard)
        ctx.save_for_backward(enc_p, pred_p, w, b, labels, lse)
        ctx.blank, ctx.act, ctx.shard = blank, act, shard
        return blank_lp, label_lp

    @staticmethod
    def backward(ctx, g_blank, g_label):
        from tpuasr_torch.nn.joint import ACT
        from tpuasr_torch.parallel.mesh import all_reduce

        enc_p, pred_p, w, b, labels, lse = ctx.saved_tensors
        shard = ctx.shard
        v0, v1 = shard.range(w.shape[1])
        bsz, t, dim = enc_p.shape
        dt = enc_p.dtype
        with torch.enable_grad():
            joined = (enc_p.detach()[:, :, None] + pred_p.detach()[:, None]).requires_grad_()
            h = ACT[ctx.act](joined)
        d = _split_logit_grad(h.detach(), w, b, lse, labels, ctx.blank, g_blank, g_label, shard)
        d_joined = torch.autograd.grad(h, joined, d @ w[:, v0:v1].to(dt).T)[0].float()
        d_in = torch.cat([d_joined.sum(2).reshape(-1), d_joined.sum(1).reshape(-1)])
        all_reduce(d_in, shard.group)
        d_w, d_b = _split_head_grads(h.detach(), d, w, shard)
        n_enc = bsz * t * dim
        return (d_in[:n_enc].view_as(enc_p).to(enc_p.dtype),
                d_in[n_enc:].view_as(pred_p).to(pred_p.dtype),
                d_w, d_b, None, None, None, None)


class _ShardedHeadLogProbs(torch.autograd.Function):
    """A head act(x) . W + b over one model rank's vocabulary slice, x the
    joint's whole pre-activation [B, T, U+1, D] (a post-join linear's
    output, or enc_p + pred_p for the HAT's token head): as
    `_ShardedJointLogProbs`, with the log-softmax across the model group,
    -> label_lp [B, T, U] (and blank_lp [B, T, U+1] first when `blank` is a
    column of W). Backward sums x's partial gradient [B, T, U+1, D] over the
    group and gathers W's and b's, so what feeds x (the post-join linear,
    the HAT's blank branch) back-propagates the same on every rank."""

    @staticmethod
    def forward(ctx, x, w, b, labels, blank, act: str, shard):
        from tpuasr_torch.nn.joint import ACT

        blank_lp, label_lp, lse = _split_log_softmax(ACT[act](x), w, b, labels, blank, shard)
        ctx.save_for_backward(x, w, b, labels, lse)
        ctx.blank, ctx.act, ctx.shard = blank, act, shard
        return label_lp if blank is None else (blank_lp, label_lp)

    @staticmethod
    def backward(ctx, *grads):
        from tpuasr_torch.nn.joint import ACT
        from tpuasr_torch.parallel.mesh import all_reduce

        x, w, b, labels, lse = ctx.saved_tensors
        shard = ctx.shard
        g_blank, g_label = (None, grads[0]) if ctx.blank is None else grads
        v0, v1 = shard.range(w.shape[1])
        with torch.enable_grad():
            xg = x.detach().requires_grad_()
            h = ACT[ctx.act](xg)
        d = _split_logit_grad(h.detach(), w, b, lse, labels, ctx.blank, g_blank, g_label, shard)
        d_x = torch.autograd.grad(h, xg, d @ w[:, v0:v1].to(x.dtype).T)[0].float()
        all_reduce(d_x, shard.group)
        d_w, d_b = _split_head_grads(h.detach(), d, w, shard)
        return d_x.to(x.dtype), d_w, d_b, None, None, None, None


def _split_log_softmax(h, w, b, labels, blank, shard):
    """The split head's forward on the activations h [B, T, U+1, D] -> (the
    blank's log-probs [B, T, U+1] or None when `blank` is None, the labels'
    [B, T, U], the log-sum-exp [B, T, U+1]), each whole on every rank."""
    from tpuasr_torch.parallel.mesh import all_reduce

    v0, v1 = shard.range(w.shape[1])
    u = labels.shape[1]
    nb = 0 if blank is None else u + 1
    logits = _slice_logits(h, w, b, v0, v1)
    lab = labels.long() - v0
    own = (lab >= 0) & (lab < v1 - v0)
    # the blank's logits [B, T, U+1] and the labels' [B, T, U] side by side,
    # zero in the columns another rank owns
    picked = torch.zeros(logits.shape[:2] + (nb + u,), dtype=torch.float32,
                         device=logits.device)
    if blank is not None and v0 <= blank < v1:
        picked[..., :nb] = logits[..., blank - v0]
    idx = lab.clamp(0, v1 - v0 - 1)[:, None, :, None].expand(-1, logits.shape[1], -1, 1)
    picked[..., nb:] = torch.where(own[:, None], logits[:, :, :u].gather(3, idx)[..., 0], 0.0)
    m = all_reduce(logits.amax(dim=-1), shard.group, "max")
    s = all_reduce(logits.sub_(m[..., None]).exp_().sum(dim=-1), shard.group)
    lse = m + torch.log(s)
    all_reduce(picked, shard.group)
    blank_lp = None if blank is None else picked[..., :nb] - lse
    return blank_lp, picked[..., nb:] - lse[:, :, :u], lse


def _split_logit_grad(h, w, b, lse, labels, blank, g_blank, g_label, shard) -> torch.Tensor:
    """This rank's slice of the logits' gradient, in h's type:
    d logit_v = g_blank [v = blank] + g_label [v = label] - p_v (g_blank +
    g_label) (no g_blank terms when `blank` is None)."""
    v0, v1 = shard.range(w.shape[1])
    t, u = h.shape[1], labels.shape[1]
    g_label = g_label.float()
    d = _slice_logits(h, w, b, v0, v1).sub_(lse[..., None]).exp_()
    g_all = torch.nn.functional.pad(g_label, (0, 1))
    d.mul_(-(g_all if blank is None else g_blank.float() + g_all)[..., None])
    if blank is not None and v0 <= blank < v1:
        d[..., blank - v0] += g_blank.float()
    lab = labels.long() - v0
    own = (lab >= 0) & (lab < v1 - v0)
    idx = lab.clamp(0, v1 - v0 - 1)[:, None, :, None].expand(-1, t, -1, 1)
    d[:, :, :u].scatter_add_(3, idx, torch.where(own[:, None], g_label, 0.0)[..., None])
    return d.to(h.dtype)


def _split_head_grads(h, d, w, shard) -> tuple[torch.Tensor, torch.Tensor]:
    """W's [D, V] and b's [V] gradients, this rank's columns from its slice
    of the logits' gradient d, gathered over the group (a SUM of slices
    zero elsewhere)."""
    from tpuasr_torch.parallel.mesh import all_reduce

    v0, v1 = shard.range(w.shape[1])
    dim = h.shape[-1]
    d_head = torch.zeros(dim + 1, w.shape[1], dtype=torch.float32, device=w.device)
    d_head[:dim, v0:v1] = (h.reshape(-1, dim).T @ d.reshape(-1, v1 - v0)).float()
    d_head[dim, v0:v1] = d.sum(dim=(0, 1, 2)).float()
    all_reduce(d_head, shard.group)
    return d_head[:dim], d_head[dim]


def _slice_logits(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, v0: int, v1: int
                  ) -> torch.Tensor:
    """Columns [v0, v1) of the head's logits in fp32, computed in h's type
    as the materialized route computes them (`TransducerJoint`)."""
    dt = h.dtype
    return (h @ w[:, v0:v1].to(dt) + b[v0:v1].to(dt)).float()


def _hat_log_probs(joint, x, labels, blank: int, shard):
    """The HAT head (tpuasr/nn/joint.py:78-93) on x [B, T, U+1, D] with its
    token head split over the model group, then the loss's log-softmax over
    all V columns (tpuasr/losses/rnnt.py:199) -> (blank_lp, label_lp).

    The blank's log-probability log_sigmoid(blank_pred(tanh(x))) is one
    column, computed whole on every rank; the V-1 token columns' log-softmax
    is `_ShardedHeadLogProbs` (label id y is token column y - [y > blank]);
    both are shifted by scale = log(max(1 - p_blank, 1e-6)). The token
    log-softmax's log-sum-exp is 0, so the loss's log-softmax over
    [blank_logp, tokens + scale] divides by logaddexp(blank_logp, scale):
    1 where the clip does not bind, more where it does."""
    import torch.nn.functional as F

    u = labels.shape[1]
    blank_logp = F.logsigmoid(joint.blank_pred(torch.tanh(x)).float())[..., 0]
    scale = torch.log(torch.clamp(1.0 - torch.exp(blank_logp), min=1e-6))
    lab = labels.long()
    tok = (lab - (lab > blank).long()).clamp(0, joint.token_pred.out_features - 1)
    tokens = _ShardedHeadLogProbs.apply(x, joint.token_pred.weight.T, joint.token_pred.bias,
                                        tok, None, joint.cfg.activation, shard)
    norm = torch.logaddexp(blank_logp, scale)
    blank_lp = blank_logp - norm
    label_lp = torch.where(lab[:, None] == blank, blank_lp[:, :, :u],
                           tokens + (scale - norm)[:, :, :u])
    return blank_lp, label_lp


def _reduce(nll: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "none":
        return nll
    if reduction == "mean":
        return nll.mean()
    if reduction == "sum":
        return nll.sum()
    raise ValueError(reduction)


def rnnt_loss_sharded(enc_p: torch.Tensor, pred_p: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor, labels: torch.Tensor, t_lens: torch.Tensor,
                      u_lens: torch.Tensor, blank: int, shard, activation: str = "tanh",
                      reduction: str = "mean") -> torch.Tensor:
    """The materialized route with the joint's logits split over the
    vocabulary on the model axis (`model.shard_joint`,
    tpuasr/models/transducer.py:282-288): each rank of `shard`'s group forms
    [B, T, U+1, V / tp] (`_ShardedJointLogProbs`), and every rank runs the
    lattice (kernels #8/#9 on the card) on the combined [B, T, U+1] inputs,
    so every rank returns the same loss. enc_p / pred_p are the projected
    encoder and predictor outputs in the compute type, W [D, V] and b [V]
    the plain head's parameters (whole on every rank)."""
    blank_lp, label_lp = _ShardedJointLogProbs.apply(enc_p, pred_p, w, b, labels, blank,
                                                     activation, shard)
    return _lattice_loss(blank_lp, label_lp, t_lens, u_lens, reduction)


def rnnt_loss_sharded_joint(joint, enc_p: torch.Tensor, pred_p: torch.Tensor,
                            labels: torch.Tensor, t_lens: torch.Tensor, u_lens: torch.Tensor,
                            blank: int, shard, reduction: str = "mean") -> torch.Tensor:
    """`model.shard_joint` for any `TransducerJoint` (enc_p / pred_p its
    projected inputs): the plain head by `rnnt_loss_sharded`; with a
    post-join linear, that linear on enc_p + pred_p on every rank, then the
    plain head split (`_ShardedHeadLogProbs`); the HAT by `_hat_log_probs`
    (after the post-join linear where there is one). The lattice is #8/#9
    on the card, as for the plain head."""
    c = joint.cfg
    if joint.plain_head:
        w, b = joint.head_params()
        return rnnt_loss_sharded(enc_p, pred_p, w, b, labels, t_lens, u_lens, blank, shard,
                                 c.activation, reduction)
    x = enc_p[:, :, None] + pred_p[:, None]
    if c.postjoin_linear:
        x = joint.post_ffn(x)
    if c.hat_joint:
        blank_lp, label_lp = _hat_log_probs(joint, x, labels, blank, shard)
    else:
        w, b = joint.head_params()
        blank_lp, label_lp = _ShardedHeadLogProbs.apply(x, w, b, labels, blank, c.activation,
                                                        shard)
    return _lattice_loss(blank_lp, label_lp, t_lens, u_lens, reduction)


def _lattice_loss(blank_lp, label_lp, t_lens, u_lens, reduction: str) -> torch.Tensor:
    blank_m, label_m, _, _ = mask_lattice_inputs(blank_lp, label_lp, t_lens, u_lens)
    return _reduce(zero_infeasible(rnnt_lattice(blank_m, label_m, u_lens)), reduction)
