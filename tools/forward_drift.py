"""How far apart two float32 forwards of one model drift, by depth.

    python3 tools/forward_drift.py --arch phi3.5-moe-42b --depths 4,8,12

For each depth the model is built at full width with its depth cut to
that many layers (an encoder-decoder model's decoder; its encoder keeps
its own depth), weights drawn on the card from seed 0 (``M.init``), and
run on ``SyntheticDataset(seed=0)`` tokens, B 2 x 2048 (with
``chip_smoke.source_inputs``' seeded vision embeddings or frames for a
VLM or an encoder-decoder model), three times:
through the kernels (``impl="kernel"``), through the plain versions, and
through the plain versions with the plain flash attention blocked
differently (query blocks of 256 and key blocks of 512 instead of 512
and 1024: the same arithmetic summed in another order).  Two pairs are
compared, kernel against plain and reblocked plain against plain, by
``chip_smoke.routing_verdict`` (the MoE cells' rule: route flips, and the
logits before each row's first flip) and by the worst ratio of a logit's
difference to the ``allclose(atol=rtol=1e-4)`` allowance there, with the
hidden state's drift after each layer (each block the forward runs,
in its order, the encoder's excepted) relative to its RMS.  The second
pair shows the float32 noise floor that the first is held against.  One
JSON line per depth and pair, then the card's name and power limit.
Needs a CUDA GPU and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3.5-moe-42b")
    ap.add_argument("--depths", default="4,8,12")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    import chip_smoke as cs
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import _build
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.train.data import SyntheticDataset

    if not torch.cuda.is_available():
        print("forward_drift: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    _build.build_all()

    for depth in (int(d) for d in args.depths.split(",")):
        cfg = dataclasses.replace(get_arch(args.arch), n_layers=depth)
        model = M.init(cfg, seed=0, device=dev)
        toks = SyntheticDataset(cfg.vocab, 2048, 2, seed=0).batch(0)[
            "tokens"].to(dev)
        source = cs.source_inputs(cfg, 2, 2048, dev)
        moe = cfg.family == "moe"
        blocks = [m for m in model.modules()
                  if isinstance(m, (M.DenseBlock, M.CrossBlock,
                                    M.DecoderBlock, M.MambaBlock))
                  and not isinstance(m, M.EncoderBlock)]

        @torch.inference_mode()
        def run(impl):
            calls, hidden = [], []

            def keep(module, args, out):
                hidden.append(out[0] if isinstance(out, tuple) else out)
            hooks = [blk.register_forward_hook(keep) for blk in blocks]
            try:
                with (cs.recording_routes(calls) if moe
                      else contextlib.nullcontext()):
                    logits = model(toks, impl=impl, **source)
            finally:
                for hook in hooks:
                    hook.remove()
            return hidden, logits, cs.by_position(calls, 2)

        plain = run("ref")
        runs = {"kernel": run("kernel")}
        with cs.patched(layers, "flash_attention",
                        lambda f: cs.reblocked_flash):
            runs["plain_reblocked"] = run("ref")
        for name, (hidden, logits, routes) in runs.items():
            p_hidden, p_logits, p_routes = plain
            if moe:
                v = cs.routing_verdict(routes, p_routes, logits, p_logits,
                                       cfg.moe.first_dense)
                reach = v["first_flip_pos"]
                v.pop("flipped")
            else:
                v, reach = {}, [2048, 2048]
            worst, drift = 0.0, []
            for b, n in enumerate(reach):
                if n:
                    d = (logits[b, :n] - p_logits[b, :n]).abs()
                    allowed = 1e-4 + 1e-4 * p_logits[b, :n].abs()
                    worst = max(worst, float((d / allowed).max()))
            for h, p in zip(hidden, p_hidden):
                d = max(float((h[b, :n] - p[b, :n]).abs().max())
                        for b, n in enumerate(reach) if n)
                drift.append(d / float(p.pow(2).mean().sqrt()))
            print(json.dumps({"arch": args.arch, "layers": depth,
                              "pair": f"{name} vs plain",
                              "worst_logit_ratio_to_allowance": worst,
                              "logit_rms": float(p_logits.pow(2).mean()
                                                 .sqrt()),
                              "hidden_drift_rel_rms": drift,
                              "routing": v}), flush=True)
        del model, plain, runs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
