"""Single-token decode step of the dense GQA and the SSM models.

``decode_step(model, caches, tokens, pos)`` consumes a (B, 1) token batch
and the cache dict and returns (logits (B, 1, V), caches).  The reference
scans the layers with the caches as scan inputs and outputs; here each
layer writes its new cache entries *in place* into its slice of the
stacked caches (keys and values at ``pos``; a mamba2 layer's conv tail and
state), so the returned caches are the same tensors that came in.
"""
from __future__ import annotations

import torch

from repro_torch.models.model import Transformer, _rope


def _dense_decode_scan(model: Transformer, caches: dict, h, cos, sin,
                       pos: int):
    for layer, blk in enumerate(model.blocks):
        cache = (caches["k"][layer], caches["v"][layer])
        h, _ = blk(h, model.cfg, cos, sin, cache=cache, pos=pos)
    return h


def _mamba_decode_scan(model: Transformer, caches: dict, h):
    for layer, blk in enumerate(model.blocks):
        conv, state = caches["conv"][layer], caches["state"][layer]
        h, (new_conv, new_state) = blk(h, model.cfg, conv_state=conv,
                                       ssm_state=state)
        # new_conv is a slice of a window built with cat, not a view of
        # the cache slot it overwrites
        conv.copy_(new_conv)
        state.copy_(new_state)
    return h


@torch.inference_mode()
def decode_step(model: Transformer, caches: dict, tokens: torch.Tensor,
                pos: int):
    """One token for the whole batch at write position ``pos`` (an int;
    an SSM model's step does not depend on it).

    The caches are updated in place and returned."""
    cfg = model.cfg
    B, S1 = tokens.shape
    h = model.embed(tokens)
    if cfg.family == "ssm":
        h = _mamba_decode_scan(model, caches["blocks"], h)
        return model.logits(h), caches
    max_seq = caches["blocks"]["k"].shape[3]
    if not 0 <= pos <= max_seq - S1:
        raise ValueError(f"write position {pos} (+{S1}) outside the cache "
                         f"of length {max_seq}")
    # the rope rows of positions pos .. pos + S1 - 1 (the reference slices
    # them out of the table for the whole cache length; same values)
    cos, sin = _rope(cfg, S1, offset=pos, device=model.device)
    h = _dense_decode_scan(model, caches["blocks"], h, cos, sin, pos)
    return model.logits(h), caches
