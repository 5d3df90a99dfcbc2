"""Loss and train step (gradients + AdamW update), with microbatch
accumulation: the reference's ``repro.train.train_step`` on a
:class:`~repro_torch.models.model.Transformer`.

    step = make_train_step(cfg, AdamW(lr=3e-3), microbatches=1)
    opt_state, metrics = step(model, opt_state, batch)

The model's parameters are updated in place; ``metrics`` holds ``loss``,
``grad_norm`` and ``step`` as 0-d tensors on the model's device.

With a mesh in ``ctx`` (``make_train_step(cfg, opt, ctx)``, the model
distributed by ``ctx.distribute``), every rank passes the same global
batch: the step places it by ``"batch"`` (each rank keeps its rows), the
forward and backward run on DTensors, each gradient is reduced to its
parameter's placement, and ``loss`` and ``grad_norm`` come back whole on
every rank.  The loss is computed on each rank's vocab shard of the
logits (:func:`vocab_parallel_cross_entropy`), as GSPMD computes the
reference's: no rank builds the global logits or their gradient.  The
gradients come from autograd through the model's forward; on a GPU the
flash attention and SSD scan go through their ``autograd.Function``s,
whose backwards are CUDA kernels too (the reference's Pallas kernels
define no VJP: it trains through their plain versions, as the CPU path
here does).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Transformer
from repro_torch.parallel.sharding import NULL_CTX, ShardingCtx, is_dtensor
from repro_torch.train.optimizer import AdamW, AdamWState


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token NLL, computed in float32: logsumexp minus the label's
    logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (lse - ll).mean()


class _ShardNLL(torch.autograd.Function):
    """Per-token NLL (b, s) in float32 from one rank's logits (b, s,
    V_local), whose column 0 is column ``lo`` of the vocab.

    With ``groups`` (those of the mesh axes that split the vocab) the row
    max, the sum of exponentials and the label's logit are all-reduced
    over them (max, sum, sum).  Without, the logits hold the whole vocab
    and the NLL is :func:`cross_entropy`'s: logsumexp minus gather of the
    float32 logits, bit for bit.

    The backward runs no collective: g·softmax − g·onehot on the shard,
    from the saved logits (in their own dtype: no float32 copy is kept)
    and log-sum-exp, in the arithmetic of autograd's backward of
    :func:`cross_entropy` (g·exp(x − lse), then −g added at the label),
    so that without groups the gradient is autograd's bit for bit."""

    @staticmethod
    def forward(fctx, logits, labels, lo, groups):
        from torch.distributed import _functional_collectives as funcol

        def reduce(t, op):
            for g in groups:
                t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
            return t

        col = labels.long() - lo
        hit = (col >= 0) & (col < logits.shape[-1])
        col = torch.where(hit, col, 0)
        if groups:
            m = reduce(logits.amax(dim=-1).float(), "max")
            sumexp = (logits - m[..., None]).exp_().sum(dim=-1)
            lse = m + torch.log(reduce(sumexp, "sum"))
            ll = torch.gather(logits, -1, col[..., None])[..., 0].float()
            ll = reduce(torch.where(hit, ll, 0.0), "sum")
        else:
            x = logits.float()
            lse = torch.logsumexp(x, dim=-1)
            ll = torch.gather(x, -1, col[..., None])[..., 0]
        fctx.save_for_backward(logits, col, hit, lse)
        return lse - ll

    @staticmethod
    def backward(fctx, g):
        logits, col, hit, lse = fctx.saved_tensors
        p = (logits - lse[..., None]).exp_().mul_(g[..., None])
        p.scatter_add_(-1, col[..., None],
                       torch.where(hit, -g, 0.0)[..., None])
        return p.to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                                 ctx: ShardingCtx) -> torch.Tensor:
    """Per-token NLL (B, S) of the DTensor ``logits`` (B, S, V) at
    ``labels`` (B, S), placed by ``("batch", "seq")`` and replicated over
    the vocab's mesh axes, each rank working on its own shard
    (``ctx.kernel_map`` of :class:`_ShardNLL`).

    Where the ``"vocab"`` rule splits V over mesh axes of more than one
    rank, the shards' partial results are reduced over those axes.
    Elsewhere (the ``fsdp`` layout, a vocab that does not divide the axis,
    an axis of one rank) each rank's logits hold the whole vocab and no
    collective runs: its NLL and gradient are :func:`cross_entropy`'s bit
    for bit.  Either way no DTensor ``gather`` builds the gradient of the
    global logits."""
    B, S, V = logits.shape
    lspec = ctx.spec_for(("batch", "seq", "vocab"), (B, S, V))
    tspec = ctx.spec_for(("batch", "seq"), (B, S))
    lo, _, groups = ctx.local_range(lspec[2] if len(lspec) > 2 else None, V)
    return ctx.kernel_map(lambda x, t: _ShardNLL.apply(x, t, lo, groups),
                          (lspec, tspec), tspec, logits, labels)


def loss_fn(model: Transformer, batch: dict,
            ctx: ShardingCtx = NULL_CTX) -> torch.Tensor:
    """The cross entropy of ``model`` on ``batch``: ``tokens`` and
    ``labels`` (B, S), and a VLM's ``vision_embed`` or an encoder-decoder
    model's ``enc_embed``, as :meth:`Transformer.forward` takes them."""
    logits = model(batch["tokens"], vision_embed=batch.get("vision_embed"),
                   enc_embed=batch.get("enc_embed"), ctx=ctx)
    labels = ctx.place(batch["labels"].to(logits.device), ("batch", "seq"))
    if not is_dtensor(logits):
        return cross_entropy(logits, labels)
    return vocab_parallel_cross_entropy(logits, labels, ctx).mean()


def _grads(model: Transformer, params: dict, batch: dict,
           ctx: ShardingCtx):
    """(loss, gradients by parameter name); a parameter the forward does
    not use (a VLM cross layer's ``ln3``) gets zeros, as under
    ``jax.grad``.  On a mesh the loss comes back whole and the gradients
    as DTensors, partial sums where the ranks split the tokens (AdamW
    reduces them to their parameters' placements)."""
    with ctx.scope():
        loss = loss_fn(model, batch, ctx)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
    if is_dtensor(loss):
        loss = loss.full_tensor()
    return loss.detach(), grads


def make_train_step(cfg: ModelConfig, opt: AdamW,
                    ctx: Optional[ShardingCtx] = None,
                    microbatches: int = 1):
    """Returns ``train_step(model, opt_state, batch) -> (opt_state,
    metrics)`` for a model of ``cfg``.  ``microbatches > 1`` splits the
    batch along dim 0 into that many equal slices, sums their gradients
    in float32 in slice order, and divides the sum and the summed loss by
    ``microbatches`` (activation memory / global-batch decoupling).
    ``ctx`` with a mesh runs the step sharded (the model distributed by
    it); each microbatch slice is then placed on the mesh."""
    ctx = ctx or NULL_CTX

    def train_step(model: Transformer, opt_state: AdamWState, batch: dict):
        if model.cfg != cfg:
            raise ValueError(f"the step was made for {cfg.name}, the model "
                             f"is {model.cfg.name}")
        params = dict(model.named_parameters())
        if microbatches == 1:
            loss, grads = _grads(model, params, batch, ctx)
        else:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{microbatches} microbatches")
            mb = B // microbatches
            gsum = {k: torch.zeros_like(p, dtype=torch.float32)
                    for k, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                loss, g = _grads(model, params, part, ctx)
                gsum = {k: gsum[k] + g[k] for k in gsum}
                lsum = lsum + loss
            grads = {k: g / microbatches for k, g in gsum.items()}
            loss = lsum / microbatches
        opt_state, gnorm = opt.update(grads, opt_state, params)
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "step": opt_state.step}

    return train_step
