"""AdamW on tensors keyed by parameter name, with the reference's
arithmetic (``repro.train.optimizer``) term for term.

    opt = AdamW(lr=3e-3, warmup_steps=10)
    state = opt.init(model)                      # AdamWState(step, m, v)
    state, gnorm = opt.update(grads, state, dict(model.named_parameters()))

The update clips by the global gradient norm (taken in float32 over every
gradient), warms the learning rate up linearly, corrects both moments for
their bias and adds the decoupled weight decay inside the step:
``p - lr * (mh / (sqrt(vh) + eps) + wd * p)``.  ``torch.optim.AdamW``
decays before the step and places ``eps`` elsewhere, so it rounds
differently, and it keeps no bfloat16 state for float32 parameters; this
one keeps ``m`` and ``v`` in ``state_dtype`` (bfloat16 halves them).

The clip scale, the step and the learning rate stay on the device, so an
update reads nothing back to the host.  The parameters are updated in
place (each ``copy_`` of its new value, in its own dtype); the moments
are new tensors in a new :class:`AdamWState`.

DTensor parameters (a model distributed over a mesh) keep DTensor moments
with their placements.  Each gradient is first reduced to its
parameter's placement (a partial sum over the ranks that split the
tokens is summed); the gradient norm is that of the full gradient (each
sum of squares of a shard summed over the ranks) before the clip; the
update itself runs on each rank's shards.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Union

import torch
from torch import nn

from repro_torch.parallel.sharding import is_dtensor


class AdamWState(NamedTuple):
    step: torch.Tensor           # int32, 0-d, on the parameters' device
    m: dict                      # parameter name -> first moment
    v: dict                      # parameter name -> second moment


Params = Union[nn.Module, Mapping[str, torch.Tensor]]


def named(params: Params) -> dict[str, torch.Tensor]:
    """A module's parameters by name, or a mapping of tensors as it is."""
    return dict(params.named_parameters() if isinstance(params, nn.Module)
                else params)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: torch.dtype = torch.float32

    def init(self, params: Params) -> AdamWState:
        """Zero moments for every parameter of ``params`` (a module or a
        mapping of tensors), in ``state_dtype`` on each parameter's
        device; step 0."""
        ps = named(params)
        zeros = lambda p: torch.zeros_like(p, dtype=self.state_dtype)
        device = next(iter(ps.values())).device
        return AdamWState(
            step=torch.zeros((), dtype=torch.int32, device=device),
            m={k: zeros(p) for k, p in ps.items()},
            v={k: zeros(p) for k, p in ps.items()})

    def _schedule(self, step: torch.Tensor) -> torch.Tensor:
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        return self.lr * warm

    @torch.no_grad()
    def update(self, grads: Mapping[str, torch.Tensor], state: AdamWState,
               params: Params) -> tuple[AdamWState, torch.Tensor]:
        """One step: every parameter of ``params`` (by name, as
        ``grads``) is overwritten with its new value.  Returns (the new
        state, the global gradient norm before the clip, float32 0-d)."""
        ps = named(params)
        grads = {k: _placed_as(g, ps[k]) for k, g in grads.items()}
        gnorm = torch.sqrt(sum(_whole(torch.sum(torch.square(g.float())))
                               for g in grads.values()))
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self._schedule(step)
        b1c = 1 - self.b1 ** step.float()
        b2c = 1 - self.b2 ** step.float()
        m_new, v_new = {}, {}
        for k, p in ps.items():
            local = _local(p)
            g = _local(grads[k]).float() * scale
            m = self.b1 * _local(state.m[k]).float() + (1 - self.b1) * g
            v = self.b2 * _local(state.v[k]).float() + (1 - self.b2) * g * g
            mh = m / b1c
            vh = v / b2c
            delta = mh / (torch.sqrt(vh) + self.eps) \
                + self.weight_decay * local.float()
            local.copy_(local.float() - lr * delta)
            m_new[k] = _shaped_as(m.to(self.state_dtype), p)
            v_new[k] = _shaped_as(v.to(self.state_dtype), p)
        return AdamWState(step=step, m=m_new, v=v_new), gnorm


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (a view); a tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor reduction made whole (partial sums summed) as a plain
    tensor; a tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def _placed_as(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient redistributed to its parameter's placement."""
    if is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _shaped_as(local: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A shard computed on this rank as a DTensor placed as ``p``; a
    tensor as it is when ``p`` is one."""
    if not is_dtensor(p):
        return local
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              shape=p.shape, stride=p.stride())
