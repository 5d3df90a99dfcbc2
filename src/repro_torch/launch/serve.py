"""Serving driver: prefill a batch of requests, then decode tokens.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
        --batch 4 --prompt-len 32 --gen 16 [--reduced] [--device cpu]

``--arch`` takes every registered model: the dense GQA models,
minicpm3-4b (MLA), the MoE models (deepseek-v2-lite-16b; phi3.5-moe-42b,
whose 167.5 GB of float32 weights fit one card only with ``--reduced``),
mamba2-2.7b, zamba2-7b (hybrid), llama-3.2-vision-11b (VLM) and
seamless-m4t-large-v2 (encoder-decoder).  A VLM's frozen cross cache is
built from the vision embeddings, an encoder-decoder model's from the
encoder's output over the source frames; both inputs are the reference's
stubs, zeros (``train.data.extra_inputs``).  The driver then prefills
token by token through the decode step, as the reference's driver does,
and decodes greedily, under ``torch.inference_mode()``.  The weights are
random, drawn from ``--seed`` on the target device.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.base import reduced as reduce_cfg
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.core.backend import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.decode import decode_step, encode, prefill_cross_cache
from repro_torch.serve.kvcache import init_cache
from repro_torch.train.data import SyntheticDataset, extra_inputs

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model: M.Transformer, prompts: torch.Tensor, gen: int, *,
             vision_embed: torch.Tensor | None = None,
             enc_embed: torch.Tensor | None = None):
    """Prefill ``prompts`` (B, S) token by token, then ``gen`` greedy
    tokens.  A VLM's cross cache is first built from ``vision_embed`` (B,
    Nv, d_model), an encoder-decoder model's from :func:`encode` of
    ``enc_embed`` (B, S_src, d_model), as the reference's driver does,
    before the clock starts.  Returns (generated ids (B, gen), prefill s,
    decode s); the times are wall seconds ending in a device
    synchronise."""
    B, S = prompts.shape
    dev, cfg = model.device, model.cfg
    src_len = enc_embed.shape[1] if cfg.family == "encdec" else None
    caches = init_cache(cfg, B, S + gen, dtype=model.tok_emb.dtype,
                        device=dev, src_len=src_len)
    if cfg.family == "vlm":
        caches["cross"] = prefill_cross_cache(model, vision_embed)
    if cfg.family == "encdec":
        caches["cross"] = prefill_cross_cache(
            model, encode(model, enc_embed), which="decoder")
    prompts = prompts.to(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits = None
    for t in range(S):
        logits, caches = decode_step(model, caches, prompts[:, t:t + 1], t)
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = []
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    t0 = time.perf_counter()
    for i in range(gen):
        out_tokens.append(tok)
        logits, caches = decode_step(model, caches, tok, S + i)
        tok = logits[:, -1].argmax(dim=-1)[:, None]
    _sync(dev)
    t_dec = time.perf_counter() - t0
    return torch.cat(out_tokens, dim=1), t_prefill, t_dec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32", choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduce_cfg(cfg)
    device = resolve_device(args.device)
    model = M.init(cfg, seed=args.seed, device=device,
                   dtype=DTYPES[args.dtype])
    B, S = args.batch, args.prompt_len
    ds = SyntheticDataset(vocab=cfg.vocab, seq_len=S, global_batch=B,
                          seed=args.seed)
    prompts = ds.batch(0)["tokens"]
    extras = extra_inputs(cfg, B, dtype=DTYPES[args.dtype], seq_len=S,
                          device=device)
    gen, t_prefill, t_dec = generate(model, prompts, args.gen, **extras)
    print(f"prefill: {S} tokens x {B} seqs in {t_prefill:.2f}s")
    print(f"decode:  {args.gen} tokens x {B} seqs in {t_dec:.2f}s "
          f"({args.gen * B / max(t_dec, 1e-9):.1f} tok/s)")
    print("generated token ids (first sequence):",
          [int(x) for x in gen[0]])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
