"""The port's sharding layer against the reference's, and sharded training.

* ``ShardingCtx.spec_for`` equals the reference's for every leaf of every
  arch's full-width parameter and cache schema, both layouts, six meshes,
  with and without ``pad_shard_axes=("heads",)`` (the reference reads only
  ``mesh.shape``, so a stand-in with a ``shape`` dict serves both);
* reduced smollm-135m trained on 4 ``gloo`` ranks (2x2 and 1x4 meshes,
  ``tp`` and ``fsdp`` layouts), and reduced mamba2-2.7b on 2x2 (its
  ``ssd_scan`` on each rank's heads): each step's loss and gradient norm
  equal the one-device port step's on the same weights and batch within
  1e-5, and the loss falls over 5 steps; the 2x2 losses of steps 1-3 are within
  1e-4 of the reference's own sharded run (GSPMD on 4 host devices in a
  subprocess) from the same seeded weights;
* a sharded checkpoint restores on one device to the gathered parameters
  bit for bit, and re-distributed to the same shards;
* ``launch/train.py --mesh 2x2 --device cpu`` under ``torch.distributed.run``
  logs a falling loss, and a mesh that is not the world size is refused.

The ranks run in spawned processes (``torch_ranks.run_ranks``), one job a
file: DTensor plans each new op layout once per process (~20 s), so the
checks share the job.
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
STEPS, LR, BATCH, SEQ = 5, 1e-2, 8, 32
RUNS = [("smollm-135m", (2, 2), "tp"), ("smollm-135m", (2, 2), "fsdp"),
        ("smollm-135m", (1, 4), "tp"), ("smollm-135m", (1, 4), "fsdp"),
        ("mamba2-2.7b", (2, 2), "tp")]
MESHES = [{"data": 1, "model": 1}, {"data": 2, "model": 2},
          {"data": 2, "model": 4}, {"data": 1, "model": 8},
          {"data": 4, "model": 2}, {"pod": 2, "data": 2, "model": 4}]


# --------------------------------------------------------------------------
# spec_for against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pad", [(), ("heads",)], ids=["even", "pad"])
@pytest.mark.parametrize("mesh", MESHES,
                         ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("layout", ["tp", "fsdp"])
def test_spec_for_is_the_reference(layout, mesh, pad):
    pytest.importorskip("jax")
    from repro.configs.registry import ARCHS
    from repro.models.model import schema
    from repro.parallel import sharding as ref
    from repro.serve.kvcache import cache_schema

    from repro_torch.models.model import leaf_paths
    from repro_torch.parallel import sharding

    stand_in = types.SimpleNamespace(shape=dict(mesh))
    ref_ctx = ref.ShardingCtx(mesh=stand_in, rules=dict(ref.LAYOUTS[layout]),
                              pad_shard_axes=pad)
    ctx = sharding.ShardingCtx(mesh=stand_in,
                               rules=dict(sharding.LAYOUTS[layout]),
                               pad_shard_axes=pad)
    assert sharding.LAYOUTS[layout] == ref.LAYOUTS[layout]
    n = 0
    for name, cfg in sorted(ARCHS.items()):
        for group in (schema(cfg), cache_schema(cfg, 8, 4096, src_len=512)):
            for path, d in leaf_paths(group):
                want = tuple(ref_ctx.spec_for(d.axes, d.shape))
                got = ctx.spec_for(d.axes, d.shape)
                assert got == want, (name, path, d.axes, d.shape, got, want)
                assert ctx.spec_for(d.axes) == tuple(ref_ctx.spec_for(d.axes))
                n += 1
    assert n > 150
    assert ctx.model_axis_size == ref_ctx.model_axis_size
    assert ctx.batch_axes() == ref_ctx.batch_axes()


def test_spec_placements_and_no_mesh():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.parallel.sharding import (FSDP_RULES, NULL_CTX,
                                               ShardingCtx)

    ctx = ShardingCtx(mesh=types.SimpleNamespace(
        shape={"data": 2, "model": 4}), rules=dict(FSDP_RULES))
    # embed over ("data", "model"): both mesh dims shard tensor dim 0
    assert ctx.placements_for(("embed", None), (64, 3)) == [Shard(0),
                                                           Shard(0)]
    assert ctx.placements_for(("vocab", "embed"), (256, 64)) == [Shard(1),
                                                                Shard(1)]
    with pytest.raises(ValueError):
        ctx.placements_of((("model", "data"),))
    x = torch.ones(3)
    assert NULL_CTX.constrain(x, "batch") is x
    assert NULL_CTX.place(x, ("batch",)) is x
    assert NULL_CTX.spec_for(("heads",), (4,)) == ("model",)
    assert NULL_CTX.model_axis_size == 1 and NULL_CTX.batch_axes() == ()


def test_forward_without_mesh_is_unchanged():
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import ShardingCtx

    cfg = reduced(get_arch("smollm-135m"))
    model = M.init(cfg, seed=0, device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    assert torch.equal(model(tokens), model(tokens, ctx=ShardingCtx()))


# --------------------------------------------------------------------------
# sharded training on 4 gloo ranks
# --------------------------------------------------------------------------

def train_job(rank, world, tmp):
    """Every run of RUNS: the sharded trajectory, each step beside the
    one-device step from the same weights and moments; then a checkpoint
    of the 2x2 tp model, saved sharded and restored sharded."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.interop import model_params, seeded_params
    from repro_torch.parallel.sharding import LAYOUTS, ShardingCtx, make_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW, AdamWState
    from repro_torch.train.train_step import make_train_step

    out = {}
    for arch, shape, layout in RUNS:
        cfg = reduced(get_arch(arch))
        params_np = seeded_params(cfg, 0)
        ds = SyntheticDataset(cfg.vocab, SEQ, BATCH, seed=0)
        ctx = ShardingCtx(mesh=make_mesh("cpu", shape),
                          rules=dict(LAYOUTS[layout]))
        model = ctx.distribute(model_params(cfg, params_np, device="cpu"))
        one = model_params(cfg, params_np, device="cpu")
        opt = AdamW(lr=LR, warmup_steps=1)
        state = opt.init(model)
        step, step1 = make_train_step(cfg, opt, ctx), make_train_step(cfg,
                                                                      opt)
        rows = []
        for i in range(STEPS):
            with torch.no_grad():
                for p, q in zip(model.parameters(), one.parameters()):
                    q.copy_(p.full_tensor())
            state1 = AdamWState(
                state.step.clone(),
                {k: t.full_tensor() for k, t in state.m.items()},
                {k: t.full_tensor() for k, t in state.v.items()})
            batch = ds.batch(i)
            state, m = step(model, state, batch)
            _, m1 = step1(one, state1, batch)
            rows.append([float(m["loss"]), float(m1["loss"]),
                         float(m["grad_norm"]), float(m1["grad_norm"])])
        out[(arch, shape, layout)] = np.array(rows)
        if (arch, shape, layout) == RUNS[0]:
            path = ckpt.save_checkpoint(str(tmp / "ckpt"), STEPS, model,
                                        state)
            gathered = {k: p.detach().full_tensor().numpy()
                        for k, p in model.named_parameters()}
            fresh = ctx.distribute(model_params(cfg, seeded_params(cfg, 1),
                                                device="cpu"))
            back = ckpt.restore_checkpoint(path, fresh, opt.init(fresh),
                                           ctx=ctx)
            same = all(
                torch.equal(p.to_local(), q.to_local())
                and p.placements == q.placements
                for p, q in zip(model.parameters(), fresh.parameters()))
            same_opt = all(
                torch.equal(state.m[k].to_local(), back["opt"].m[k].to_local())
                and torch.equal(state.v[k].to_local(),
                                back["opt"].v[k].to_local())
                for k in state.m)
            out["ckpt"] = (path, gathered, same and same_opt)
            # one step over 2 microbatches, from the same weights
            fresh1 = model_params(cfg, seeded_params(cfg, 1), device="cpu")
            with torch.no_grad():
                for p, q in zip(fresh.parameters(), fresh1.parameters()):
                    q.copy_(p.full_tensor())
            _, m = make_train_step(cfg, opt, ctx, microbatches=2)(
                fresh, opt.init(fresh), ds.batch(0))
            _, m1 = make_train_step(cfg, opt, microbatches=2)(
                fresh1, opt.init(fresh1), ds.batch(0))
            out["microbatched"] = [float(m["loss"]), float(m1["loss"]),
                                   float(m["grad_norm"]),
                                   float(m1["grad_norm"])]
    return out if rank == 0 else None


REF_TRAIN = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import reduced
from repro.configs.registry import get_arch
from repro.models import model as M
from repro.parallel.sharding import ShardingCtx
from repro.train.data import SyntheticDataset
from repro.train.optimizer import AdamW
from repro.train.train_step import make_train_step
from repro_torch.interop import seeded_params
cfg = reduced(get_arch("smollm-135m"))
mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
ctx = ShardingCtx(mesh=mesh)
params = jax.tree.map(jnp.asarray, seeded_params(cfg, 0))
params = jax.tree.map(jax.device_put, params,
                      ctx.param_shardings(M.schema(cfg)))
opt = AdamW(lr={lr}, warmup_steps=1)
state = opt.init(params)
step = jax.jit(make_train_step(cfg, opt, ctx))
ds = SyntheticDataset(cfg.vocab, {seq}, {batch}, seed=0)
losses = []
with mesh:
    for i in range(3):
        params, state, m = step(params, state, ds.batch(i))
        losses.append(float(m["loss"]))
np.save(sys.argv[1], np.array(losses))
"""


def _reference(code: str, out: Path) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code),
                             str(out)], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc: subprocess.Popen, seconds: float) -> None:
    try:
        _, err = proc.communicate(timeout=seconds)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"reference run still ran after {seconds} s")
    assert proc.returncode == 0, err[-4000:]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("parallel_train")
    ref = _reference(REF_TRAIN.format(lr=LR, seq=SEQ, batch=BATCH),
                     tmp / "ref_losses.npy")
    try:
        out = run_ranks("test_torch_parallel", "train_job", 4, tmp,
                        seconds=300)[0]
    finally:
        _finish(ref, 300)
    out["ref"] = np.load(tmp / "ref_losses.npy")
    return out


@pytest.mark.parametrize("run", RUNS, ids=lambda r: f"{r[0]}-{r[1][0]}x"
                         f"{r[1][1]}-{r[2]}")
def test_sharded_step_is_the_one_device_step(trained, run):
    rows = trained[run]
    assert rows.shape == (STEPS, 4)
    np.testing.assert_allclose(rows[:, 0], rows[:, 1], rtol=0, atol=1e-5)
    # mamba2's gradient norm also within 5e-5 relative: its conv bias
    # gradient sums summands that cancel, and the ranks' partial sums over
    # the batch reorder that float32 sum (1.05e-5 relative at step 5)
    rtol = 5e-5 if run[0] == "mamba2-2.7b" else 0
    np.testing.assert_allclose(rows[:, 2], rows[:, 3], rtol=rtol, atol=1e-5)
    assert rows[-1, 0] < rows[0, 0], rows[:, 0]


def test_sharded_microbatched_step_is_the_one_device_step(trained):
    loss, loss1, norm, norm1 = trained["microbatched"]
    assert abs(loss - loss1) <= 1e-5 and abs(norm - norm1) <= 1e-5


def test_sharded_losses_are_the_references(trained):
    ours = trained[RUNS[0]][:3, 0]
    np.testing.assert_allclose(ours, trained["ref"], rtol=0, atol=1e-4)


def test_sharded_checkpoint_restores_on_one_device(trained):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.interop import model_params, seeded_params
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.optimizer import AdamW

    path, gathered, restored_sharded = trained["ckpt"]
    assert restored_sharded
    cfg = reduced(get_arch("smollm-135m"))
    model = model_params(cfg, seeded_params(cfg, 1), device="cpu")
    out = restore_checkpoint(path, model, AdamW().init(model))
    assert out["step"] == STEPS and int(out["opt"].step) == STEPS
    for k, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), gathered[k]), k


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launch_train_mesh_under_torchrun(tmp_path):
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    try:
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
             "--reduced", "--mesh", "2x2", "--device", "cpu", "--steps",
             "4", "--log-every", "1", "--batch", "8", "--seq", "32"],
            capture_output=True, text=True, env=env, cwd=tmp_path,
            timeout=240)
    except subprocess.TimeoutExpired as e:
        raise AssertionError("torchrun still ran after 240 s") from e
    assert out.returncode == 0, out.stderr[-4000:]
    losses = [float(line.split()[3]) for line in out.stdout.splitlines()
              if line.startswith("step")]
    assert len(losses) == 4, out.stdout          # rank 0 alone logs
    assert losses[-1] < losses[0], losses
    assert "done: 4 steps" in out.stdout


def test_launch_train_refuses_a_mesh_that_is_not_the_world(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match="needs 4 processes, have 1"):
        train.main(["--reduced", "--device", "cpu", "--mesh", "2x2"])
