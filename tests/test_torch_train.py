"""The port's training stack against the reference's, on the CPU.

Both packages run the same numbers: the reference's parameters (its own
``init``, or ``interop.seeded_params``) carried over with
``interop.model_params``, tokens and source embeddings drawn with NumPy.
Tolerances, in float32 with full-precision products on one thread:

* ``cross_entropy`` on seeded logits: atol 1e-6;
* the loss (rtol 1e-5) and every gradient leaf, stacked to the
  reference's layout by ``models.model.stacked_leaves`` (atol = rtol =
  1e-4), on all ten reduced archs at B 2 x 32, with seeded vision
  embeddings or frames for the cross models (the reference's zero stubs
  would make every cross-attention add nothing);
* the parameters after three AdamW steps (atol = rtol = 1e-4), with one
  microbatch and with four, each held to the reference's step with the
  same count, and the loss of every step (rtol 1e-5);
* one ``update`` on the same parameters, gradients and bfloat16 state:
  parameters within 1e-6, moments within one bfloat16 step (2**-7
  relative); the clip's update on the reference's own example within
  1e-6;
* checkpoints: a directory written by either package is read by the
  other bit for bit, and for the same numbers both write the same bytes.

The reference's ``restore_checkpoint`` cannot read its own bfloat16
optimizer state (NumPy loads the ``<V2`` leaves as ``|V2``, which
``jnp.asarray`` refuses); ``test_port_checkpoint_is_the_reference_bytes``
records that, and holds the port's bfloat16 files to the reference's byte
for byte instead.
"""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train import train_step as ref_ts  # noqa: E402
from repro.train.optimizer import AdamW as RefAdamW  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.train_step import (cross_entropy,  # noqa: E402
                                          loss_fn, make_train_step)

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-5
TOL = 1e-4
B, S = 2, 32


@pytest.fixture(autouse=True)
def _highest_precision_one_thread():
    """float32 products in full float32; one intra-op thread per worker."""
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_num_threads(n)


def _pair(name, **over):
    """(reference cfg, port cfg) of ``reduced(name, **over)``."""
    return (ref_base.reduced(REF_ARCHS[name], **over),
            base.reduced(get_arch(name), **over))


def _leaves(tree) -> dict:
    """The reference's leaves keyed as the checkpoint keys them
    (``blocks/wq``), as NumPy arrays."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _stacked(cfg, by_name) -> dict:
    """Float32 tensors by name as the reference's stacked NumPy leaves."""
    return {k: t.detach().numpy()
            for k, t in M.stacked_leaves(cfg, by_name)}


def _batch(cfg, seed=0) -> dict:
    """NumPy tokens and labels (B, S), and a cross model's seeded source
    embeddings."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["vision_embed"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)
    if cfg.family == "encdec":
        out["enc_embed"] = rng.standard_normal(
            (B, cfg.n_audio_frames, cfg.d_model), dtype=np.float32)
    return out


def _torch(batch) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _models(name, seed=0, **over):
    """(ref cfg, ref params, port cfg, port model on the same weights)."""
    ref_cfg, cfg = _pair(name, **over)
    params = ref_model.init(ref_cfg, jax.random.key(seed))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, params, cfg, model


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# ----------------------------------------------------------------- loss
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    got = float(cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels)))
    want = float(ref_ts.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels)))
    assert abs(got - want) <= 1e-6
    # the reference test's hand-computed case
    p = np.exp([2.0, 0.0, -1.0])
    assert float(cross_entropy(torch.tensor([[[2.0, 0.0, -1.0]]]),
                               torch.tensor([[0]]))) \
        == pytest.approx(-np.log(p[0] / p.sum()), rel=1e-6)


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_loss_and_gradients_match_reference(name):
    ref_cfg, params, cfg, model = _models(name)
    batch = _batch(cfg)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: ref_ts.loss_fn(ref_cfg, p, batch))(params)
    ps = dict(model.named_parameters())
    loss = loss_fn(model, _torch(batch))
    grads = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    got = _stacked(cfg, {k: torch.zeros_like(p) if g is None else g
                         for (k, p), g in zip(ps.items(), grads)})
    want = _leaves(want_grads)
    assert float(loss.detach()) == pytest.approx(float(want_loss),
                                                 rel=LOSS_RTOL)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                   err_msg=key)


# ---------------------------------------------------------- the optimizer
@pytest.mark.parametrize("microbatches", [1, 4])
def test_adamw_steps_match_reference(microbatches):
    """Three steps of ``make_train_step`` from the same weights, as
    ``tests/test_train_extras.py`` sets them up (smollm reduced to two
    layers, B 8 x 16), against the reference's step with the same
    microbatch count; with four, also against the port's own full-batch
    step at the reference test's tolerances."""
    ref_cfg, params, cfg, model = _models("smollm-135m", n_layers=2)
    ds = SyntheticDataset(cfg.vocab, 16, 8, seed=0)
    ref_opt, opt = RefAdamW(lr=1e-3, warmup_steps=1), AdamW(
        lr=1e-3, warmup_steps=1)
    ref_step = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt,
                                              microbatches=microbatches))
    step = make_train_step(cfg, opt, microbatches=microbatches)
    full = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                device="cpu")
    full_step, full_state = make_train_step(cfg, opt), opt.init(full)
    ref_state, state = ref_opt.init(params), opt.init(model)
    for i in range(3):
        batch = ds.batch(i)
        params, ref_state, ref_m = ref_step(
            params, ref_state, {k: v.numpy() for k, v in batch.items()})
        state, m = step(model, state, batch)
        assert float(m["loss"]) == pytest.approx(float(ref_m["loss"]),
                                                 rel=LOSS_RTOL)
        assert int(m["step"]) == int(ref_m["step"]) == i + 1
        full_state, full_m = full_step(full, full_state, batch)
        assert float(m["loss"]) == pytest.approx(float(full_m["loss"]),
                                                 rel=1e-4)
    got, want = _stacked(cfg, dict(model.named_parameters())), _leaves(params)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=TOL, rtol=TOL,
                                   err_msg=key)
    for a, b in zip(got.values(), _stacked(
            cfg, dict(full.named_parameters())).values()):
        np.testing.assert_allclose(a, b, atol=5e-5, rtol=5e-4)


def test_optimizer_bf16_state_still_learns():
    """``tests/test_train_extras.py``'s bfloat16-state run on the port:
    the moments are bfloat16 and the loss falls over four steps on one
    batch; each step's loss is held to the reference's same run."""
    ref_cfg, params, cfg, model = _models("smollm-135m", n_layers=2)
    ds = SyntheticDataset(cfg.vocab, 16, 8, seed=0)
    opt = AdamW(lr=1e-2, warmup_steps=1, state_dtype=torch.bfloat16)
    ref_opt = RefAdamW(lr=1e-2, warmup_steps=1, state_dtype=jnp.bfloat16)
    step = make_train_step(cfg, opt)
    ref_step = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt))
    state, ref_state = opt.init(model), ref_opt.init(params)
    assert next(iter(state.m.values())).dtype == torch.bfloat16
    batch = ds.batch(0)
    losses = []
    for _ in range(4):
        state, m = step(model, state, batch)
        params, ref_state, ref_m = ref_step(
            params, ref_state, {k: v.numpy() for k, v in batch.items()})
        losses.append(float(m["loss"]))
        assert losses[-1] == pytest.approx(float(ref_m["loss"]), rel=1e-4)
    assert losses[-1] < losses[0]
    assert all(t.dtype == torch.bfloat16 for t in state.v.values())


def _update_both(opt_kw, params, grads, state_dtype):
    """One ``update`` of each package on the same numbers (a dict of
    NumPy arrays each); returns (port params, state, gnorm) and the
    reference's."""
    ref_opt = RefAdamW(**opt_kw, state_dtype={
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[
            state_dtype])
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_out = ref_opt.update({k: jnp.asarray(v) for k, v in grads.items()},
                             ref_opt.init(ref_p), ref_p)
    opt = AdamW(**opt_kw, state_dtype=state_dtype)
    ps = {k: torch.tensor(v) for k, v in params.items()}
    state, gnorm = opt.update({k: torch.tensor(v) for k, v in grads.items()},
                              opt.init(ps), ps)
    return (ps, state, gnorm), ref_out


def test_update_equals_reference_on_the_same_numbers():
    rng = np.random.default_rng(3)
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in (("a", (8, 16)), ("b", (16,)), ("c", (3, 4, 5)))}
    grads = {k: (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
             for k, v in params.items()}
    for state_dtype in (torch.float32, torch.bfloat16):
        (ps, state, gnorm), (ref_p, ref_state, ref_gnorm) = _update_both(
            dict(lr=1e-2, warmup_steps=4), params, grads, state_dtype)
        assert float(gnorm) == pytest.approx(float(ref_gnorm), rel=1e-6)
        assert int(state.step) == int(ref_state.step) == 1
        for k in params:
            np.testing.assert_allclose(ps[k].numpy(), np.asarray(ref_p[k]),
                                       atol=1e-6, rtol=1e-6)
            for got, want in ((state.m[k], ref_state.m[k]),
                              (state.v[k], ref_state.v[k])):
                assert got.dtype == state_dtype
                np.testing.assert_allclose(
                    got.float().numpy(), np.asarray(want, np.float32),
                    rtol=2.0 ** -7, atol=0)


def test_grad_clip_bounds_update():
    """``tests/test_train_extras.py``'s clip case on the port, held to
    the reference's update of the same numbers."""
    kw = dict(lr=1.0, grad_clip=1e-6, warmup_steps=1, weight_decay=0.0)
    (ps, _, gnorm), (ref_p, _, ref_gnorm) = _update_both(
        kw, {"w": np.ones(4, np.float32)}, {"w": np.full(4, 1e6, np.float32)},
        torch.float32)
    assert float(gnorm) > 1e5
    assert float(gnorm) == pytest.approx(float(ref_gnorm), rel=1e-6)
    assert bool(torch.isfinite(ps["w"]).all())
    np.testing.assert_allclose(ps["w"].numpy(), np.asarray(ref_p["w"]),
                               atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_train_step_reduces_loss(name):
    """``tests/test_models_smoke.py``'s four steps on each reduced arch,
    on the port (the reference's zero stubs for the cross models)."""
    from repro_torch.train.data import extra_inputs
    cfg = base.reduced(get_arch(name))
    model = M.init(cfg, seed=0, device="cpu")
    opt = AdamW(lr=1e-2, warmup_steps=1)
    step, state = make_train_step(cfg, opt), opt.init(model)
    batch = SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)
    batch.update(extra_inputs(cfg, B, seq_len=S, device="cpu"))
    losses = []
    for i in range(4):
        state, m = step(model, state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(losses[-1]), f"{name}: loss NaN at step {i}"
    assert losses[-1] < losses[0], f"{name}: loss did not fall ({losses})"


def test_step_refuses_another_model():
    cfg = base.reduced(get_arch("smollm-135m"))
    other = M.init(base.reduced(get_arch("starcoder2-7b")), device="cpu")
    opt = AdamW()
    with pytest.raises(ValueError):
        make_train_step(cfg, opt)(other, opt.init(other),
                                  SyntheticDataset(256, 8, 2).batch(0))
    with pytest.raises(ValueError):
        model = M.init(cfg, device="cpu")
        make_train_step(cfg, opt, microbatches=3)(
            model, opt.init(model), SyntheticDataset(256, 8, 2).batch(0))


# ---------------------------------------------------------- checkpoints
def _stepped(name, state_dtype, **over):
    """The reference's model and AdamW state after one step of each
    package from the same weights: (ref cfg, ref params, ref state, port
    cfg, port model, port state)."""
    ref_cfg, params, cfg, model = _models(name, **over)
    batch = _batch(cfg)
    ref_opt = RefAdamW(lr=1e-3, warmup_steps=1, state_dtype={
        torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[
            state_dtype])
    params, ref_state, _ = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt))(
        params, ref_opt.init(params), batch)
    opt = AdamW(lr=1e-3, warmup_steps=1, state_dtype=state_dtype)
    state, _ = make_train_step(cfg, opt)(model, opt.init(model),
                                         _torch(batch))
    return ref_cfg, params, ref_state, cfg, model, state


def _bits(a) -> np.ndarray:
    """The raw bytes of an array (bfloat16 from either package, or a |V2
    leaf as NumPy loads it) as unsigned integers of its width."""
    if isinstance(a, torch.Tensor):
        a = a.detach().contiguous()
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        a = a.numpy()
    a = np.ascontiguousarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def test_checkpoint_round_trip_rotation_and_shape_refusal(tmp_path):
    """``tests/test_system.py``'s round trip on the port, with rotation,
    an interrupted save left as ``.tmp`` and the shape refusal."""
    _, _, _, cfg, model, state = _stepped("smollm-135m", torch.float32)
    d = str(tmp_path / "ckpt")
    ckpt.save_checkpoint(d, 10, model, state)
    ckpt.save_checkpoint(d, 20, model, state, keep=2, extra={"run": "a"})
    os.makedirs(os.path.join(d, "step_00000030.tmp"))
    assert ckpt.latest_checkpoint(d).endswith("step_00000020")
    fresh = M.init(cfg, seed=7, device="cpu")
    fresh_opt = AdamW().init(fresh)
    out = ckpt.restore_checkpoint(ckpt.latest_checkpoint(d), fresh, fresh_opt)
    assert out["step"] == 20 and out["extra"] == {"run": "a"}
    assert out["params"] is fresh
    for (k, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), k
    for part in ("m", "v"):
        for k, t in getattr(state, part).items():
            assert torch.equal(getattr(out["opt"], part)[k], t), k
    assert out["opt"].step.dtype == torch.int32
    assert int(out["opt"].step) == int(state.step) == 1
    ckpt.save_checkpoint(d, 40, model, keep=1)
    assert sorted(x for x in os.listdir(d) if not x.endswith(".tmp")) \
        == ["step_00000040"]
    # a model of other shapes is refused before anything is written
    bad = M.init(base.reduced(get_arch("smollm-135m"), d_ff=96), seed=3,
                 device="cpu")
    before = {k: t.clone() for k, t in bad.named_parameters()}
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(ckpt.latest_checkpoint(d), bad)
    assert all(torch.equal(before[k], t) for k, t in bad.named_parameters())


CROSSINGS = [("smollm-135m", torch.float32), ("smollm-135m", torch.bfloat16),
             ("zamba2-7b", torch.bfloat16),
             ("seamless-m4t-large-v2", torch.float32)]


@pytest.mark.parametrize("name,state_dtype", CROSSINGS,
                         ids=lambda x: str(x).removeprefix("torch."))
def test_reference_checkpoint_restores_in_port(tmp_path, name, state_dtype):
    """A checkpoint the reference writes (after one of its steps) restores
    into a fresh port model and AdamW state bit for bit: a hybrid model's
    ``shared`` stacked over 1 and an encoder-decoder model's nested
    ``decoder/self``, ``decoder/cross`` leaves included."""
    _, params, ref_state, cfg, _, _ = _stepped(name, state_dtype)
    path = ref_ckpt.save_checkpoint(str(tmp_path), 5, params, ref_state)
    model = M.Transformer(cfg, device="cpu")
    out = ckpt.restore_checkpoint(path, model, AdamW(
        state_dtype=state_dtype).init(model))
    assert out["step"] == 5 and int(out["opt"].step) == int(ref_state.step)
    for got, want, dtype in (
            (dict(model.named_parameters()), params, torch.float32),
            (out["opt"].m, ref_state.m, state_dtype),
            (out["opt"].v, ref_state.v, state_dtype)):
        got, want = dict(M.stacked_leaves(cfg, got)), _leaves(want)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == dtype, key
            np.testing.assert_array_equal(_bits(got[key]), _bits(want[key]),
                                          err_msg=key)


@pytest.mark.parametrize("name,state_dtype", CROSSINGS,
                         ids=lambda x: str(x).removeprefix("torch."))
def test_port_checkpoint_is_the_reference_bytes(tmp_path, name,
                                                state_dtype):
    """For the same numbers both packages write the same directory, byte
    for byte (manifest included): the port saves what it restored from
    the reference's checkpoint.  The reference then restores the port's
    checkpoint bit for bit: all of it for float32 state, the parameters
    for bfloat16 state (its own restore refuses its bfloat16 moments)."""
    _, params, ref_state, cfg, _, _ = _stepped(name, state_dtype)
    ref_path = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 5, params,
                                        ref_state)
    model = M.Transformer(cfg, device="cpu")
    state = ckpt.restore_checkpoint(ref_path, model, AdamW(
        state_dtype=state_dtype).init(model))["opt"]
    path = ckpt.save_checkpoint(str(tmp_path / "port"), 5, model, state)
    assert sorted(os.listdir(path)) == sorted(os.listdir(ref_path))
    for f in os.listdir(path):
        assert Path(path, f).read_bytes() == Path(ref_path, f).read_bytes(), f
    if state_dtype == torch.float32:
        out = ref_ckpt.restore_checkpoint(path, params, ref_state)
        pairs = [(out["params"], params), (out["opt"], ref_state)]
    else:
        with pytest.raises(TypeError):
            ref_ckpt.restore_checkpoint(path, params, ref_state)
        pairs = [(ref_ckpt.restore_checkpoint(path, params)["params"],
                  params)]
    for got, want in pairs:
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(_bits(np.asarray(a)),
                                          _bits(np.asarray(b)))


# ---------------------------------------------------------- the driver
def _lines(capsys, argv) -> list:
    assert train_launch.main(argv) == 0
    return capsys.readouterr().out.splitlines()


def test_launch_train_checkpoints_and_resumes(tmp_path, capsys):
    """The driver on the CPU checkpoints every 3 steps; resumed from its
    latest checkpoint, it logs the same lines as a run that never
    stopped."""
    common = ["--reduced", "--device", "cpu", "--batch", "2", "--seq",
              "16", "--log-every", "1", "--checkpoint-every", "3"]
    d = str(tmp_path / "ckpt")
    first = _lines(capsys, common + ["--steps", "6", "--checkpoint-dir", d])
    assert first[0].startswith("step     1 loss ")
    assert f"checkpointed -> {os.path.join(d, 'step_00000006')}" in first
    assert first[-1].startswith("done: 6 steps in ")
    resumed = _lines(capsys, common + ["--steps", "9", "--checkpoint-dir",
                                       d, "--resume"])
    assert resumed[0] == (f"resumed from {os.path.join(d, 'step_00000006')}"
                          f" at step 6")
    assert resumed[-1].startswith("done: 3 steps in ")
    whole = _lines(capsys, common + ["--steps", "9"])
    strip = lambda lines: [x.split(" tok/s")[0] for x in lines
                           if x.startswith("step ")]
    assert strip(resumed) == strip(whole)[6:] and len(strip(resumed)) == 3
    with pytest.raises(SystemExit):
        train_launch.main(common + ["--mesh", "2x2"])


# --------------------------------------------------- chip_smoke's numbers
def test_expected_train_is_the_reference():
    """``chip_smoke.py`` holds the card's three steps of the full-width
    smollm-135m (30 layers, NumPy-seeded weights, B 2 x 256) to
    ``EXPECTED_TRAIN``.  This recomputes them with the reference's
    ``make_train_step``: each step's loss as it reports it, and its
    gradient norm taken in float64 over the reference's gradients at that
    step (the reference's own float32 norm sums each leaf with XLA:CPU's
    ``jnp.sum``, 1.2e-4 short of the exact norm at step 1).  Then the
    port runs the same steps on the CPU at one and at eight intra-op
    threads (two float32 summation orders): each step lands within
    ``TRAIN_SPREAD`` of the reference, which ``train_agrees`` widens the
    card's 1e-4 hold to (``FLOOR_FACTOR`` times it) where it exceeds half
    of 1e-4."""
    cs = _chip_smoke()
    ref_cfg, cfg = REF_ARCHS["smollm-135m"], get_arch("smollm-135m")
    weights = interop.seeded_params(cfg, seed=0)
    ds = SyntheticDataset(cfg.vocab, cs.TRAIN_HELD_SEQ, cs.TRAIN_HELD_BATCH,
                          seed=0)
    ref_opt = RefAdamW(**cs.TRAIN_HELD_OPT)
    step = jax.jit(ref_ts.make_train_step(ref_cfg, ref_opt))
    grad = jax.jit(jax.grad(lambda p, b: ref_ts.loss_fn(ref_cfg, p, b)))
    params = jax.tree.map(jnp.asarray, weights)
    state, want = ref_opt.init(params), []
    for i in range(len(cs.EXPECTED_TRAIN)):
        batch = {k: v.numpy() for k, v in ds.batch(i).items()}
        norm = float(np.sqrt(sum(np.square(np.asarray(g, np.float64)).sum()
                                 for g in jax.tree.leaves(grad(params,
                                                               batch)))))
        params, state, m = step(params, state, batch)
        want.append([float(m["loss"]), norm])
        assert float(m["grad_norm"]) == pytest.approx(norm, rel=1e-3)
    del params, state
    for w, e in zip(want, cs.EXPECTED_TRAIN):
        assert w == pytest.approx(e, rel=1e-6)
    spread = [0.0] * len(want)
    for threads in (1, 8):
        torch.set_num_threads(threads)
        model = interop.model_params(cfg, weights, device="cpu")
        got = cs.held_train_steps(model)
        assert cs.train_agrees(got)
        spread = [max(s, *(abs(g - e) / abs(e) for g, e in zip(gs, es)))
                  for s, gs, es in zip(spread, got, cs.EXPECTED_TRAIN)]
        del model
    assert all(s <= t for s, t in zip(spread, cs.TRAIN_SPREAD)), spread
