"""``core.profiler.profile_torch``: a torch step read on fake tensors.

* a two-matmul DTensor program on a fake (2, 2) mesh gives hand-computed
  collectives (kinds, replica groups, operand bytes), FLOPs, HBM bytes and
  argument bytes, exactly;
* the plain flash-attention region's bytes are tagged ``"flash"``
  exactly: forward, and backward through the autograd nodes it made;
* a reduced smollm-135m train step on a fake (2, 2) mesh lists the same
  collectives as the same step on four real ``gloo`` ranks (which also
  hold the sharded model to the one-device model where the mesh leaves
  the heads whole: 3 heads over 1 KV head, ``layers._proj``); read as on
  nccl (``reshard_all_to_all``) the list differs only where gloo's
  all-gather fallback stands for an all-to-all; and
  ``comm_graph_from_profile`` of it equals the reference's fed the same
  collectives (``G_v``, ``G_m`` exactly);
* ``arg_bytes`` of a reduced smollm train and prefill cell on a (2, 2)
  mesh equals the reference's ``memory_analysis().argument_size_in_bytes``
  for the same cell, compiled on four host devices (exactly: every sharded
  dim divides its axis).

Fake process groups are process-wide, so each fake job runs in a process
of its own (``torch_ranks.run_alone``).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import run_alone, run_ranks  # noqa: E402

MiB = 2 ** 20
# the reduced smollm cells: (global batch, seq) of a train and a prefill
# step, dividing the (2, 2) mesh's data axis
TRAIN = ("train_tiny", 64, 8, "train")
PREFILL = ("prefill_tiny", 64, 8, "prefill")


def _fake_mesh(world: int, shape: tuple):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.parallel.sharding import make_mesh
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return make_mesh("cpu", shape)


def _colls(ops) -> list:
    return [[c.kind, c.operand_bytes, [list(g) for g in c.groups],
             c.group_size] for c in ops]


def two_matmul_job(out: str) -> None:
    import json
    from pathlib import Path

    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.core.profiler import fake_mode, profile_torch
    mesh = _fake_mesh(4, (2, 2))
    with fake_mode():
        a = distribute_tensor(torch.empty(1024, 1024), mesh,
                              [Shard(0), Replicate()], src_data_rank=None)
        b = distribute_tensor(torch.empty(1024, 1024), mesh,
                              [Replicate(), Shard(1)], src_data_rank=None)

    def step(a, b):
        c = a @ b                                     # [S(0), S(1)]
        d = c.redistribute(mesh, [Replicate(), Replicate()])
        return d @ b                                  # [R, S(1)]

    p = profile_torch(step, a, b, mesh=mesh)
    Path(out).write_text(json.dumps({
        "collectives": _colls(p.collectives), "flops": p.flops,
        "bytes": p.bytes_accessed, "arg": p.arg_bytes, "peak": p.peak_bytes,
        "n": p.num_partitions, "tags": p.bytes_by_tag}))


def test_two_matmul_program_by_hand(tmp_path):
    """a (1024, 1024) f32 on [Shard(0), Replicate()] and b on [Replicate(),
    Shard(1)] over (data 2, model 2): each rank holds 2 MiB of each.

    c = a @ b: local (512, 1024) @ (1024, 512), 2·512·1024·512 FLOPs,
    reads 4 MiB, writes 1 MiB.  Replicating c gathers its column shards
    over the model axis (1 MiB each: groups (0, 1), (2, 3); the result,
    (1024, 512), is 2 MiB), stitches the columns back with a cat (reads and
    writes 2 MiB), then gathers the rows over the data axis (2 MiB each:
    groups (0, 2), (1, 3); result 4 MiB).  d @ b: local (1024, 1024) @
    (1024, 512), 2·1024·1024·512 FLOPs, reads 6 MiB, writes 2 MiB."""
    r = run_alone("test_torch_launch_profile", "two_matmul_job", tmp_path,
                  seconds=120)
    assert r["collectives"] == [
        ["all-gather", 1 * MiB, [[0, 1], [2, 3]], 2],
        ["all-gather", 2 * MiB, [[0, 2], [1, 3]], 2]]
    assert r["flops"] == 2 * 512 * 1024 * 512 + 2 * 1024 * 1024 * 512
    assert r["bytes"] == (4 + 1) * MiB + (1 + 2) * MiB + (2 + 2) * MiB \
        + (2 + 4) * MiB + (6 + 2) * MiB
    assert r["arg"] == 4 * MiB and r["n"] == 4 and r["tags"] == {}
    # a, b, d (4 MiB) and the result (2 MiB) are live together at the end
    assert 4 * MiB + 6 * MiB <= r["peak"] <= 4 * MiB + 17 * MiB


def test_flash_region_is_tagged():
    """The flash entry point's plain version on CPU tensors: all its bytes
    are tagged, forward and backward, and they are the untagged plain
    version's bytes."""
    from repro_torch.core.profiler import fake_mode, profile_torch
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    with fake_mode():
        q = torch.empty(1, 4, 1024, 16, requires_grad=True)
        k = torch.empty(1, 2, 1024, 16, requires_grad=True)
        v = torch.empty(1, 2, 1024, 16, requires_grad=True)
    fwd = profile_torch(lambda q, k, v: flash_attention(q, k, v), q, k, v)
    plain = profile_torch(lambda q, k, v: flash_attention_ref(q, k, v),
                          q, k, v)
    assert fwd.bytes_by_tag == {"flash": plain.bytes_accessed} \
        and fwd.bytes_accessed == plain.bytes_accessed > 0
    assert plain.bytes_by_tag == {} and fwd.flops == plain.flops > 0

    def train(q, k, v):
        out = flash_attention(q, k, v)
        torch.autograd.grad(out, (q, k, v), torch.ones_like(out))

    both = profile_torch(train, q, k, v)
    assert both.bytes_by_tag["flash"] == both.bytes_accessed
    assert both.bytes_accessed > 2 * fwd.bytes_accessed


def _smollm_step(mesh, fake: bool):
    """(step, args) of a reduced smollm-135m train step, float32, B 8 x 64,
    on ``mesh``."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step
    cfg = reduced(get_arch("smollm-135m"))
    ctx = ShardingCtx(mesh=mesh)
    model = M.Transformer(cfg, device="cpu") if fake \
        else M.init(cfg, seed=0, device="cpu")
    model = ctx.distribute(model)
    opt = AdamW()
    toks = torch.zeros((8, 64), dtype=torch.int64)
    batch = {"tokens": toks, "labels": toks}
    return make_train_step(cfg, opt, ctx), (model, opt.init(model), batch)


def smollm_fake_job(out: str) -> None:
    import json
    from pathlib import Path

    from repro_torch.core.profiler import fake_mode, profile_torch
    torch.set_num_threads(1)
    mesh = _fake_mesh(4, (2, 2))
    res = {}
    for name, a2a in (("gloo", False), ("nccl", True)):
        with fake_mode():
            step, args = _smollm_step(mesh, fake=True)
        p = profile_torch(step, *args, mesh=mesh, reshard_all_to_all=a2a)
        res[name] = _colls(p.collectives)
        res[name + "_n"] = p.num_partitions
    Path(out).write_text(json.dumps(res))


# reduced archs with 3 query heads over 1 KV head: the model axis of 2
# divides neither, so every head-split projection (GQA, MLA, the VLM's
# cross layers) runs through ``layers._proj``'s gathered weights
ODD_HEADS = ("smollm-135m", "minicpm3-4b", "llama-3.2-vision-11b")


def smollm_gloo_job(rank: int, world: int, tmp) -> dict:
    """Rank ``rank``'s collective list of the reduced smollm step; and,
    for ``ODD_HEADS``, the largest gap between the sharded and the
    one-device forward's logits (B 4 x 16, seeded source embeddings), and
    smollm's sharded train step's loss and gradient norm beside the
    one-device step's."""
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.profiler import record_collectives
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh
    from repro_torch.train.data import extra_inputs
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step
    mesh = make_mesh("cpu", (2, 2))
    step, args = _smollm_step(mesh, fake=False)
    out = {"colls": _colls(record_collectives(step, *args, mesh=mesh))}
    ctx = ShardingCtx(mesh=mesh)
    g = torch.Generator().manual_seed(1)
    for arch in ODD_HEADS:
        cfg = reduced(get_arch(arch), n_heads=3, n_kv_heads=1)
        toks = torch.randint(0, cfg.vocab, (4, 16), generator=g)
        src = {k: torch.randn(v.shape, generator=g)
               for k, v in extra_inputs(cfg, 4, seq_len=16,
                                        device="cpu").items()}
        one = M.init(cfg, seed=0, device="cpu")
        sharded = ctx.distribute(M.init(cfg, seed=0, device="cpu"))
        with torch.no_grad():
            want = one(toks, **src)
            got = sharded(toks, ctx=ctx, **src).full_tensor()
        out[arch] = float((got - want).abs().max())
        if arch == "smollm-135m":
            batch = {"tokens": toks, "labels": toks}
            rows = []
            for model, c in ((one, None), (sharded, ctx)):
                opt = AdamW()
                _, m = make_train_step(cfg, opt, c)(model, opt.init(model),
                                                    batch)
                rows.append([float(m["loss"]), float(m["grad_norm"])])
            out["train"] = rows
    return out


@pytest.fixture(scope="module")
def smollm_lists(tmp_path_factory):
    """The fake job's lists and the four gloo ranks', run side by side."""
    tmp = tmp_path_factory.mktemp("smollm")
    with ThreadPoolExecutor(1) as pool:
        fake = pool.submit(run_alone, "test_torch_launch_profile",
                           "smollm_fake_job", tmp, seconds=240)
        real = run_ranks("test_torch_launch_profile", "smollm_gloo_job", 4,
                         tmp, seconds=240)
        return fake.result(), real


def test_fake_step_lists_the_gloo_steps_collectives(smollm_lists):
    fake, real = smollm_lists
    lists = [r["colls"] for r in real]
    assert len(fake["gloo"]) > 20
    assert fake["gloo"] == lists[0]
    # every rank's own step gives rank 0's list of all groups
    assert all(r == lists[0] for r in lists[1:])


def test_unsharded_heads_compute_the_one_device_model(smollm_lists):
    """Projections whose heads dim the mesh leaves whole (``_proj``):
    the sharded forward within 1e-5 of the one-device forward for GQA,
    MLA and the VLM's cross layers, and smollm's sharded train step's
    loss and gradient norm within 1e-5 of the one-device step's."""
    _, real = smollm_lists
    for r in real:
        for arch in ODD_HEADS:
            assert r[arch] <= 1e-5, (arch, r[arch])
        (loss1, norm1), (loss, norm) = r["train"]
        assert abs(loss - loss1) <= 1e-5 and abs(norm - norm1) <= 1e-5


def test_nccl_reading_swaps_gathers_for_all_to_alls(smollm_lists):
    """Where gloo gathers a shard to move it to another dim, nccl runs an
    all-to-all on the same group and operand: nothing else differs."""
    fake, _ = smollm_lists
    gloo, nccl = fake["gloo"], fake["nccl"]
    assert len(gloo) == len(nccl)
    swapped = 0
    for g, c in zip(gloo, nccl):
        if g != c:
            assert (g[0], c[0]) == ("all-gather", "all-to-all")
            assert g[1:] == c[1:]
            swapped += 1
    assert swapped == sum(c[0] == "all-to-all" for c in nccl)


def test_comm_graph_is_the_references(smollm_lists):
    from repro.core.profiler import CollectiveOp as RefOp
    from repro.core.profiler import HloProfile as RefProfile
    from repro.core.profiler import comm_graph_from_profile as ref_graph

    from repro_torch.core.profiler import (CollectiveOp, HloProfile,
                                           comm_graph_from_profile)
    fake, _ = smollm_lists
    for name in ("gloo", "nccl"):
        rows = fake[name]
        ops = [dict(kind=k, operand_bytes=b,
                    groups=[tuple(g) for g in grps], group_size=n,
                    multiplier=1.0) for k, b, grps, n in rows]
        got = comm_graph_from_profile(HloProfile(
            flops=0.0, bytes_accessed=0.0, num_partitions=4,
            collectives=[CollectiveOp(**o) for o in ops]))
        want = ref_graph(RefProfile(
            flops=0.0, bytes_accessed=0.0, num_partitions=4,
            collectives=[RefOp(**o) for o in ops]))
        assert np.array_equal(got.G_v, want.G_v)
        assert np.array_equal(got.G_m, want.G_m)
        assert got.G_v.sum() > 0


def port_arg_bytes_job(out: str) -> None:
    import json
    from pathlib import Path

    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.profiler import fake_mode, profile_torch
    from repro_torch.launch.dryrun import build_cell
    torch.set_num_threads(1)
    mesh = _fake_mesh(4, (2, 2))
    cfg = reduced(get_arch("smollm-135m"))
    res = {}
    for cell in (TRAIN, PREFILL):
        with fake_mode():
            fn, args = build_cell(cfg, ShapeConfig(*cell), mesh)
        res[cell[0]] = profile_torch(fn, *args, mesh=mesh).arg_bytes
    Path(out).write_text(json.dumps(res))


def ref_arg_bytes_job(out: str) -> None:
    import json
    from pathlib import Path

    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    assert len(jax.devices()) == 4      # jax keeps the count it started with
    from jax.sharding import Mesh

    from repro.launch import dryrun as RD

    from repro.configs.base import ShapeConfig, reduced
    from repro.configs.registry import get_arch
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    cfg = reduced(get_arch("smollm-135m"))
    res = {}
    for cell in (TRAIN, PREFILL):
        fn, args, in_sh, out_sh = RD.build_cell(cfg, ShapeConfig(*cell), mesh)
        with mesh:
            compiled = jax.jit(fn, in_shardings=in_sh,
                               out_shardings=out_sh).lower(*args).compile()
        res[cell[0]] = compiled.memory_analysis().argument_size_in_bytes
    Path(out).write_text(json.dumps(res))


def test_arg_bytes_are_the_references(tmp_path):
    with ThreadPoolExecutor(2) as pool:
        got, want = pool.map(
            lambda job: run_alone("test_torch_launch_profile", job, tmp_path,
                                  seconds=300),
            ("port_arg_bytes_job", "ref_arg_bytes_job"))
    assert got == want and got[TRAIN[0]] > got[PREFILL[0]] > 0
