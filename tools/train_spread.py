"""How far float32 alone carries a held train cell of ``chip_smoke.py``
from its reference constants: the port's held steps on the CPU at each
intra-op thread count (another summation order each), and the largest
relative difference of each step's loss or grad_norm from the constants.

    PYTHONPATH=src python3 tools/train_spread.py --cell smollm-135m/held-S2048

prints one JSON line per thread count and a last line with the spread,
which is what ``TRAIN_SPREAD_*`` records.  ``smollm-135m/held-S2048``
takes ~4 minutes a thread count and ~12 GB; its reference constants are
recomputed by ``tests/test_torch_backward_s2048.py``.  The two other held
cells measure their spread inside their tests
(``tests/test_torch_train.py``, ``tests/test_torch_backward_expected.py``).
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# cell -> (arch, depth cut, batch, seq, name of the expected constant)
CELLS = {
    "smollm-135m/held": ("smollm-135m", {}, 2, 256, "EXPECTED_TRAIN"),
    "mamba2-2.7b/held-L2": ("mamba2-2.7b", {"n_layers": 2}, 2, 256,
                            "EXPECTED_TRAIN_MAMBA2"),
    "smollm-135m/held-S2048": ("smollm-135m", {}, 1, 2048,
                               "EXPECTED_TRAIN_S2048"),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(CELLS),
                    default="smollm-135m/held-S2048")
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 8])
    args = ap.parse_args(argv)

    import torch
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    arch, over, batch, seq, name = CELLS[args.cell]
    expected = getattr(cs, name)
    cfg = dataclasses.replace(get_arch(arch), **over)
    torch.set_float32_matmul_precision("highest")
    spread = [0.0] * len(expected)
    for threads in args.threads:
        torch.set_num_threads(threads)
        model = interop.model_params(cfg, interop.seeded_params(cfg, seed=0),
                                     device="cpu")
        t0 = time.perf_counter()
        got = cs.held_train_steps(model, batch, seq, len(expected))
        del model
        rel = [max(abs(g - e) / abs(e) for g, e in zip(gs, es))
               for gs, es in zip(got, expected)]
        spread = [max(s, r) for s, r in zip(spread, rel)]
        print(json.dumps({"cell": args.cell, "threads": threads, "got": got,
                          "rel_err": rel,
                          "s": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"cell": args.cell, "constant": name,
                      "spread": spread}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
