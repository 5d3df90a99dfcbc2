"""The dry run's train step keeps the cross entropy on each rank's vocab
shard: reduced smollm-135m with its vocab kept wide (16384) traced by
``profile_torch`` on a fake process group of 16 ranks (a 4 x 4 ``tp``
mesh, ``launch.dryrun.build_cell``'s bf16 parameters and float32 AdamW
state) peaks below 4·(B/4)·S·V bytes, what one rank's vocab-replicated
float32 logits alone would take.  A loss that gathers the vocab, or whose
``gather`` backward builds the global logits' zeros, passes that line.

The prefill forward multiplies each rank's own tokens by the unembedding
(``Transformer.logits``): with a vocab that does not divide the model
axis (16382 on 4), it peaks below what the global batch's bf16 logits
take on one rank, which DTensor's own plan for the product (the embed dim
split, partial logits of every token) needs.

The profile counts a collective's result once: a fake ``wait_tensor``
makes new storage where the real one returns its input, and the recorder
counts it as that input's, live while either is.

The fake group is process-wide, so the traces run in a process of their
own (``torch_ranks.run_alone``)."""
import json

import pytest

pytest.importorskip("torch")

from torch_ranks import run_alone  # noqa: E402

B, S, V, MESH = 8, 64, 16384, (4, 4)
V_ODD = V - 2
MiB = 1 << 20


def traced(out):
    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.profiler import fake_mode, profile_torch
    from repro_torch.launch.dryrun import build_cell, fake_process_group
    from repro_torch.parallel.sharding import make_mesh
    import torch

    cfg = reduced(get_arch("smollm-135m"), vocab=V)
    with fake_process_group(MESH[0] * MESH[1]):
        mesh = make_mesh("cpu", MESH)
        with fake_mode():
            fn, args = build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh)
        prof = profile_torch(fn, *args, mesh=mesh)
        cfg = reduced(get_arch("smollm-135m"), vocab=V_ODD)
        with fake_mode():
            fn, args = build_cell(cfg, ShapeConfig("p", S, B, "prefill"),
                                  mesh)
        prefill = profile_torch(fn, *args, mesh=mesh)

        def gather(x):
            ops = torch.ops._c10d_functional
            y = ops.all_gather_into_tensor(x, 4, mesh.get_group(1).group_name)
            z = ops.wait_tensor(y)
            del y
            return z, torch.empty(MiB // 4)

        with fake_mode():
            x = torch.empty(MiB // 4)
        gathered = profile_torch(gather, x, mesh=mesh)
    with open(out, "w") as f:
        json.dump({"peak": prof.peak_bytes, "args": prof.arg_bytes,
                   "all_reduces": sum(c.kind == "all-reduce"
                                      for c in prof.collectives),
                   "gather_peak": gathered.peak_bytes,
                   "prefill_peak": prefill.peak_bytes}, f)


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    return run_alone("test_torch_dryrun_loss", "traced",
                     tmp_path_factory.mktemp("dryrun_loss"), seconds=180)


def test_train_step_peak_is_below_one_ranks_replicated_logits(profiles):
    replicated = 4 * (B // MESH[0]) * S * V
    assert 0 < profiles["args"] < profiles["peak"] < replicated, profiles
    assert profiles["all_reduces"] >= 3, profiles


def test_prefill_logits_are_each_ranks_own_tokens(profiles):
    assert profiles["prefill_peak"] < 2 * B * S * V_ODD, profiles


def test_a_collectives_result_counts_once(profiles):
    # 1 MiB argument, its 4 MiB gather (live after its fake alias's
    # source is dropped), 1 MiB more
    assert profiles["gather_peak"] == 6 * MiB, profiles
