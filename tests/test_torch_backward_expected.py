"""The held train cells of ``chip_smoke.py`` that run through the backward
kernels, recomputed with the reference on the CPU.

``train/mamba2-2.7b/held-L2`` (full width, 2 layers, B 2 x 256) is held
here as ``test_torch_train.test_expected_train_is_the_reference`` holds
``EXPECTED_TRAIN``: the reference's three steps of its own train step
(``jax.value_and_grad`` of ``loss_fn``, then ``AdamW.update``, as
``make_train_step`` composes them) on ``interop.seeded_params(seed=0)``,
each step's loss as it reports it and its gradient norm in float64 over
its gradients, must equal the constants within 1e-6; then the port's steps
on the CPU at one and at eight intra-op threads must each land within the
constant's ``TRAIN_SPREAD_MAMBA2`` of them, and be held by
``train_agrees``.  ``train/smollm-135m/held-S2048`` (full width and depth,
B 1 x 2048) has its reference steps recomputed in
``tests/test_torch_backward_s2048.py``, a file of its own so that another
worker takes it, with these helpers; its spread (the port's steps at 2048
tokens: ~4 minutes and ~12 GB a thread count) is measured by
``tools/train_spread.py``.
"""
import dataclasses
import functools
import gc
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.train import train_step as ref_ts  # noqa: E402
from repro.train.optimizer import AdamW as RefAdamW  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reference_steps(arch: str, over: dict, weights: dict, batch: int,
                    seq: int, opt_kw: dict, steps: int) -> list:
    """[loss, float64 gradient norm] of each of the reference's ``steps``
    train steps on ``weights``, step i on ``SyntheticDataset(vocab, seq,
    batch, seed=0).batch(i)``."""
    cfg = dataclasses.replace(REF_ARCHS[arch], **over)
    opt = RefAdamW(**opt_kw)

    # the old parameters and moments are donated to the new ones, so the
    # step holds one copy of each (338 M floats for mamba2's two layers)
    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, state, b):
        loss, grads = jax.value_and_grad(
            lambda p: ref_ts.loss_fn(cfg, p, b))(params)
        params, state, _ = opt.update(grads, state, params)
        return params, state, loss, grads

    params = jax.tree.map(jnp.asarray, weights)
    state, out = opt.init(params), []
    ds = SyntheticDataset(cfg.vocab, seq, batch, seed=0)
    for i in range(steps):
        b = {k: v.numpy() for k, v in ds.batch(i).items()}
        params, state, loss, grads = step(params, state, b)
        norm = np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                           for g in jax.tree.leaves(grads)))
        out.append([float(loss), float(norm)])
        del grads
    del params, state
    gc.collect()
    return out


def reference_is(arch: str, over: dict, batch: int, seq: int,
                 expected) -> None:
    """The reference's steps on the seeded weights equal ``expected``."""
    cs = chip_smoke()
    cfg = dataclasses.replace(get_arch(arch), **over)
    want = reference_steps(arch, over, interop.seeded_params(cfg, seed=0),
                           batch, seq, cs.TRAIN_HELD_OPT, len(expected))
    for w, e in zip(want, expected):
        assert w == pytest.approx(e, rel=1e-6)


def held_to_constants(arch: str, over: dict, batch: int, seq: int,
                      expected, spread) -> None:
    """The reference's steps equal ``expected``; the port's, at one and at
    eight threads, agree with it within ``spread`` (and ``train_agrees``).
    The seeded weights are drawn again for each run rather than kept
    beside the model, its gradients and its moments."""
    cs = chip_smoke()
    cfg = dataclasses.replace(get_arch(arch), **over)
    reference_is(arch, over, batch, seq, expected)
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    seen = [0.0] * len(expected)
    try:
        for threads in (1, 8):
            torch.set_num_threads(threads)
            model = interop.model_params(
                cfg, interop.seeded_params(cfg, seed=0), device="cpu")
            got = cs.held_train_steps(model, batch, seq, len(expected))
            del model
            assert cs.train_agrees(got, expected, spread), got
            seen = [max(s, *(abs(g - e) / abs(e) for g, e in zip(gs, es)))
                    for s, gs, es in zip(seen, got, expected)]
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.set_num_threads(n)
    assert all(s <= t for s, t in zip(seen, spread)), seen


def test_expected_train_mamba2_is_the_reference():
    """``EXPECTED_TRAIN_MAMBA2``: mamba2-2.7b at full width cut to 2
    layers, B 2 x 256 (every layer's SSD in the reference is
    ``ssd_chunked`` under ``jax.grad``)."""
    cs = chip_smoke()
    held_to_constants("mamba2-2.7b", {"n_layers": 2}, cs.TRAIN_HELD_BATCH,
                      cs.TRAIN_HELD_SEQ, cs.EXPECTED_TRAIN_MAMBA2,
                      cs.TRAIN_SPREAD_MAMBA2)
