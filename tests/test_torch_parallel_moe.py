"""The port's multi-rank bodies against the reference's, on 4 ``gloo`` ranks.

* expert-parallel MoE (reduced phi3.5-moe-42b, 2x2 mesh): the logits equal
  the port's local forward and the reference's EP forward within 1e-4,
  and a training step's gradients the one-device ones within 1e-5;
* all-to-all MoE: the logits equal the **reference's all-to-all** forward
  within 1e-4, drops included, at capacity factor 1.25 and 0.5, on the
  batch-sharded (B 4) and the sequence-sharded (B 2) branch; with a
  capacity that drops nothing, logits and gradients equal the local path;
* ``flash_decode_gqa`` (reduced smollm-135m, 2x2 mesh, cache 16): 4 decode
  steps equal the port's one-device decode within 1e-5 and the
  reference's flash-decode run within 1e-5;
* ``decode_step`` on the 2x2 mesh without flash-decoding (GQA, MLA and
  SSM caches placed by the context, the attention caches sharded by
  sequence; the VLM's and the encoder-decoder model's frozen cross caches
  seeded, placed as their schema says) equals the one-device decode
  within 1e-5;
* every arch's reduced forward on the 2x2 mesh (each family's blocks on
  DTensors, its seeded vision or source embeddings placed by batch)
  equals its one-device forward within 1e-5;
* the sharded ``refine_many`` over ``["cpu"] * 3`` with B 4 (padded to 6)
  equals the one-device dispatch and NumPy's placements bit for bit.

The reference runs in a subprocess on 4 host devices, beside the ranks.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import run_ranks  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
SEQ, CACHE, DECODE_STEPS = 16, 16, 4
A2A = [(cf, B) for cf in (1.25, 0.5) for B in (4, 2)]
ARCHS = ["deepseek-v2-lite-16b", "llama-3.2-vision-11b", "mamba2-2.7b",
         "minicpm3-4b", "nemotron-4-340b", "phi3.5-moe-42b",
         "seamless-m4t-large-v2", "smollm-135m", "starcoder2-7b",
         "zamba2-7b"]
DECODE_ARCHS = ["smollm-135m", "minicpm3-4b", "mamba2-2.7b",
                "llama-3.2-vision-11b", "seamless-m4t-large-v2"]


def _tokens(vocab: int, shape: tuple, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape)


def _with_capacity(cfg, cf: float):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def moe_job(rank, world, tmp):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.interop import model_params, seeded_params
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import cache_schema, init_cache
    from repro_torch.train.train_step import _grads

    mesh = make_mesh("cpu", (2, 2))
    out = {}

    def full(t):
        return t.full_tensor().numpy()

    def grads_of(model, batch, ctx):
        loss, g = _grads(model, dict(model.named_parameters()), batch, ctx)
        return float(loss), {k: (full(t) if ctx.mesh else t.numpy())
                             for k, t in g.items()}

    cfg = reduced(get_arch("phi3.5-moe-42b"))
    params_np = seeded_params(cfg, 0)
    local = model_params(cfg, params_np, device="cpu")
    tok = {B: torch.from_numpy(_tokens(cfg.vocab, (B, SEQ), B))
           for B in (4, 2)}
    batch = {"tokens": tok[4], "labels": torch.roll(tok[4], -1, 1)}
    with torch.no_grad():
        out["local"] = {B: local(t).numpy() for B, t in tok.items()}
    out["local_grads"] = grads_of(local, batch, ShardingCtx())

    ctx = ShardingCtx(mesh=mesh)                       # expert-parallel
    ep = ctx.distribute(model_params(cfg, params_np, device="cpu"))
    with torch.no_grad():
        out["ep"] = full(ep(tok[4], ctx=ctx))
    out["ep_grads"] = grads_of(ep, batch, ctx)

    for cf, B in A2A + [(4.0, 4)]:
        cfg_cf = _with_capacity(cfg, cf)
        ctx = ShardingCtx(mesh=mesh, moe_impl="alltoall")
        a2a = ctx.distribute(model_params(cfg_cf, params_np, device="cpu"))
        with torch.no_grad():
            out[("a2a", cf, B)] = full(a2a(tok[B], ctx=ctx))
        if cf == 4.0:
            out["a2a_grads"] = grads_of(a2a, batch, ctx)

    cfg = reduced(get_arch("smollm-135m"))
    params_np = seeded_params(cfg, 0)
    one = model_params(cfg, params_np, device="cpu")
    ctx = ShardingCtx(mesh=mesh, flash_decode=True)
    sharded = ctx.distribute(model_params(cfg, params_np, device="cpu"))
    caches1 = init_cache(cfg, 2, CACHE, device="cpu")
    caches = init_cache(cfg, 2, CACHE, device="cpu", ctx=ctx)
    dec = torch.from_numpy(_tokens(cfg.vocab, (2, DECODE_STEPS), 7))
    rows = []
    for i in range(DECODE_STEPS):
        l1, caches1 = decode_step(one, caches1, dec[:, i:i + 1], i)
        ls, caches = decode_step(sharded, caches, dec[:, i:i + 1], i,
                                 ctx=ctx)
        rows.append((l1.numpy(), full(ls)))
    out["decode"] = rows
    # the one rank owning each position wrote it: the gathered caches are
    # the one-device caches
    out["cache_err"] = max(
        float((caches["blocks"][k].full_tensor() - caches1["blocks"][k])
              .abs().max()) for k in ("k", "v"))

    ctx = ShardingCtx(mesh=mesh)
    for arch in DECODE_ARCHS:
        cfg = reduced(get_arch(arch))
        params_np = seeded_params(cfg, 0)
        one = model_params(cfg, params_np, device="cpu")
        sharded = ctx.distribute(model_params(cfg, params_np, device="cpu"))
        caches1 = init_cache(cfg, 2, CACHE, device="cpu")
        caches = init_cache(cfg, 2, CACHE, device="cpu", ctx=ctx)
        if "cross" in caches:           # a frozen cross cache, seeded
            rng = np.random.default_rng(9)
            sch = cache_schema(cfg, 2, CACHE)["cross"]
            for name, d in sch.items():
                t = torch.from_numpy(rng.standard_normal(d.shape).astype(
                    np.float32))
                caches1["cross"][name] = t
                caches["cross"][name] = ctx.place(t, d.axes)
        dec = torch.from_numpy(_tokens(cfg.vocab, (2, DECODE_STEPS), 8))
        err = 0.0
        for i in range(DECODE_STEPS):
            l1, caches1 = decode_step(one, caches1, dec[:, i:i + 1], i)
            ls, caches = decode_step(sharded, caches, dec[:, i:i + 1], i,
                                     ctx=ctx)
            err = max(err, float(np.abs(full(ls) - l1.numpy()).max()))
        out[("decode", arch)] = err

    from repro_torch.train.data import extra_inputs
    for arch in ARCHS:
        cfg = reduced(get_arch(arch))
        params_np = seeded_params(cfg, 0)
        tokens = torch.from_numpy(_tokens(cfg.vocab, (4, SEQ), 5))
        src = {k: torch.from_numpy(np.random.default_rng(6).standard_normal(
            tuple(v.shape)).astype(np.float32))
            for k, v in extra_inputs(cfg, 4, seq_len=SEQ,
                                     device="cpu").items()}
        one = model_params(cfg, params_np, device="cpu")
        sharded = ctx.distribute(model_params(cfg, params_np, device="cpu"))
        with torch.no_grad():
            out[("forward", arch)] = (
                one(tokens, **src).numpy(),
                full(sharded(tokens, ctx=ctx, **src)))
    return out if rank == 0 else None


REF = """
import sys, dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs.base import reduced
from repro.configs.registry import get_arch
from repro.models import model as M
from repro.parallel.sharding import ShardingCtx
from repro.serve.decode import decode_step
from repro.serve.kvcache import cache_schema, init_cache
from repro_torch.interop import seeded_params
SEQ, CACHE, STEPS, A2A = {seq}, {cache}, {steps}, {a2a}

def tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)

mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
out = {{}}
cfg = reduced(get_arch("phi3.5-moe-42b"))
params = jax.tree.map(jnp.asarray, seeded_params(cfg, 0))
for impl, cases in (("replicated", [(None, 4)]), ("alltoall", A2A)):
    ctx = ShardingCtx(mesh=mesh, moe_impl=impl)
    ps = jax.tree.map(jax.device_put, params,
                      ctx.param_shardings(M.schema(cfg)))
    for cf, B in cases:
        c = cfg if cf is None else dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        with mesh:
            logits = jax.jit(lambda p, b: M.forward(c, p, b, ctx))(
                ps, {{"tokens": jnp.asarray(tokens(cfg.vocab, (B, SEQ), B))}})
        out["ep" if cf is None else f"a2a_{{cf}}_{{B}}"] = np.asarray(logits)

cfg = reduced(get_arch("smollm-135m"))
ctx = ShardingCtx(mesh=mesh, flash_decode=True)
ps = jax.tree.map(jax.device_put,
                  jax.tree.map(jnp.asarray, seeded_params(cfg, 0)),
                  ctx.param_shardings(M.schema(cfg)))
caches = jax.tree.map(jax.device_put, init_cache(cfg, 2, CACHE),
                      ctx.param_shardings(cache_schema(cfg, 2, CACHE)))
dec = jnp.asarray(tokens(cfg.vocab, (2, STEPS), 7))
step = jax.jit(lambda p, c, t, pos: decode_step(cfg, p, c, t, pos, ctx))
with mesh:
    for i in range(STEPS):
        logits, caches = step(ps, caches, dec[:, i:i + 1], jnp.int32(i))
        out[f"decode_{{i}}"] = np.asarray(logits)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("parallel_moe")
    env = {**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    code = REF.format(seq=SEQ, cache=CACHE, steps=DECODE_STEPS, a2a=A2A)
    ref = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), str(tmp / "ref.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        out = run_ranks("test_torch_parallel_moe", "moe_job", 4, tmp,
                        seconds=300)[0]
    finally:
        try:
            _, err = ref.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            ref.kill()
            ref.communicate()
            raise AssertionError("reference run still ran after 300 s")
    assert ref.returncode == 0, err[-4000:]
    out["ref"] = dict(np.load(tmp / "ref.npz"))
    return out


def test_ep_moe_is_local_and_reference(runs):
    np.testing.assert_allclose(runs["ep"], runs["local"][4], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(runs["ep"], runs["ref"]["ep"], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("impl", ["ep", "a2a"])
def test_parallel_moe_gradients_are_local(runs, impl):
    """A step's loss and every gradient, EP or all-to-all at a capacity
    that drops nothing, equal the one-device local path's."""
    loss1, g1 = runs["local_grads"]
    loss, g = runs[f"{impl}_grads"]
    assert abs(loss - loss1) <= 1e-5
    assert g.keys() == g1.keys()
    for k in g1:
        np.testing.assert_allclose(g[k], g1[k], rtol=0, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("cf,B", A2A, ids=lambda v: str(v))
def test_a2a_moe_is_the_references_a2a(runs, cf, B):
    ours, ref = runs[("a2a", cf, B)], runs["ref"][f"a2a_{cf}_{B}"]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    if cf == 0.5:       # capacity drops choices: not the local forward
        assert np.abs(ours - runs["local"][B]).max() > 1e-3


def test_a2a_moe_without_drops_is_local(runs):
    np.testing.assert_allclose(runs[("a2a", 4.0, 4)], runs["local"][4],
                               rtol=0, atol=1e-4)


def test_flash_decode_is_one_device_and_reference(runs):
    for i, (one, sharded) in enumerate(runs["decode"]):
        np.testing.assert_allclose(sharded, one, rtol=0, atol=1e-5)
        np.testing.assert_allclose(sharded, runs["ref"][f"decode_{i}"],
                                   rtol=0, atol=1e-5)
    assert runs["cache_err"] <= 1e-6


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_sharded_decode_is_one_device(runs, arch):
    assert runs[("decode", arch)] <= 1e-5


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_forward_sharded_is_one_device(runs, arch):
    one, sharded = runs[("forward", arch)]
    np.testing.assert_allclose(sharded, one, rtol=0, atol=1e-5)


def test_sharded_refine_many_is_one_device_and_numpy():
    from repro_torch.core import backend, mapping, mapping_torch
    from repro_torch.core.fattree import FatTreeTopology
    from repro_torch.core.topology import TorusTopology
    from repro_torch.workloads.patterns import npb_dt_like

    G = npb_dt_like(40).comm.G_v
    rng = np.random.default_rng(0)
    torus, ft = TorusTopology((4, 4, 4)), FatTreeTopology(8)
    p_f = np.zeros(ft.n_nodes)
    p_f[rng.choice(ft.n_nodes, 6, replace=False)] = 0.1
    cases = [("dense", torus.hop_matrix(), torus.n_nodes),
             ("implicit-torus", torus.lazy_distance(), torus.n_nodes),
             ("implicit-fattree", ft.lazy_distance(p_f, c=2.0), ft.n_nodes)]
    one = backend.TorchBackend(device="cpu")
    three = backend.TorchBackend(device="cpu", devices=["cpu"] * 3)
    assert one.devices == [torch.device("cpu")]
    for name, D, n_nodes in cases:
        P = np.stack([rng.permutation(n_nodes)[:40] for _ in range(4)])
        with backend.use(one):
            single = mapping_torch.refine_many(G, D, P)
        before = three.stats.get("sharded_dispatches", 0)
        with backend.use(three):
            sharded = mapping_torch.refine_many(G, D, P)
            hb = mapping_torch.hop_bytes_batch(G, D, sharded)
        assert three.stats["sharded_dispatches"] == before + 1, name
        with backend.use("numpy"):
            ref = np.stack([mapping._pairwise_refine(G, D, p) for p in P])
            ref_hb = np.array([mapping.hop_bytes(G, D, p) for p in ref])
        assert np.array_equal(sharded, single), name
        assert np.array_equal(sharded, ref), name
        np.testing.assert_allclose(hb, ref_hb, rtol=1e-9, err_msg=name)


def test_backend_devices_follow_the_cap(monkeypatch):
    from repro_torch.core import backend

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("REPRO_TORCH_DEVICES", "2")
    assert backend._default_devices(torch.device("cuda")) == [
        torch.device("cuda", 0), torch.device("cuda", 1)]
    monkeypatch.setenv("REPRO_TORCH_DEVICES", "0")
    assert len(backend._default_devices(torch.device("cuda"))) == 4
    assert backend._default_devices(torch.device("cpu")) == [
        torch.device("cpu")]
