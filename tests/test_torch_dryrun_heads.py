"""What the dry run's sharded attention, lookup and unembedding make on a
rank: reduced llama-3.2-vision-11b (32 query heads over 4 KV heads, a
flash-length self-attention and a cross layer over 64 vision tokens)
traced by ``profile_torch`` on a fake process group of 16 ranks, a 2 x 8
``tp`` mesh: the query heads divide the model axis of 8, the KV heads do
not.

* No attention intermediate holds more than a rank's H / 8 = 4 query
  heads (a 4-D tensor whose second dim has more heads than that: scores,
  softmax, the plain flash's query or repeated K/V): each rank attends
  with its own query heads, which meet the KV head they map to, in the
  prefill forward and in a train step (its backward included).
* No tensor of the whole (V, d) table (two dims, one of them V, V x d
  elements or more, the table's dtype) is made beside the parameters' own shards: in
  the prefill forward and the train step where the vocab divides the
  model axis (each rank gathers its own rows over the embed dim), in a
  decode step for both vocabs (where it does not divide, the token ids
  and the activations move: ``lookup_by_columns``,
  ``matmul_by_columns``), and in the lookup with its gradient at the
  train shape for both vocabs.

Every tensor an operation makes while the step runs is read as it is
made (``tools/dryrun_families.py``'s ``recording``, on the profiler's
recorder), so one that lives only briefly counts.
The fake group is process-wide, so the traces run in a process of their
own (``torch_ranks.run_alone``)."""
import importlib.util
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_ranks import run_alone  # noqa: E402

TOOL = Path(__file__).resolve().parents[1] / "tools" / "dryrun_families.py"
MESH, H, HKV, D = (2, 8), 32, 4, 64
S, B, CACHE, N_VIS = 2048, 2, 64, 64
VOCABS = {"divides": 4096, "does-not-divide": 4094}
# the cells whose table the step must not gather, by vocab
TABLE_CELLS = {"divides": ["prefill", "train", "decode", "lookup"],
               "does-not-divide": ["decode", "lookup"]}


def traced(out):
    import torch

    from repro_torch.configs.base import ShapeConfig, reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.profiler import fake_mode, profile_torch
    from repro_torch.launch.dryrun import build_cell, fake_process_group
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh

    spec = importlib.util.spec_from_file_location("dryrun_families", TOOL)
    families = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(families)
    res = {}
    with families.recording() as made:
        with fake_process_group(MESH[0] * MESH[1]):
            mesh = make_mesh("cpu", MESH)
            for vocab, V in VOCABS.items():
                cfg = reduced(get_arch("llama-3.2-vision-11b"), n_heads=H,
                              n_kv_heads=HKV, vocab=V, n_vision_tokens=N_VIS)
                shapes = {"prefill": ShapeConfig("p", S, B, "prefill"),
                          "train": ShapeConfig("t", S, B, "train"),
                          "decode": ShapeConfig("d", CACHE, B, "decode")}
                cells = {}
                for name, shape in shapes.items():
                    with fake_mode():
                        cells[name] = build_cell(cfg, shape, mesh)
                ctx = ShardingCtx(mesh=mesh)
                with fake_mode():
                    model = ctx.distribute(M.Transformer(
                        cfg, device="cpu", dtype=torch.bfloat16))
                    tokens = ctx.place(torch.zeros((B, S), dtype=torch.int32),
                                       ("batch", "seq"))

                def lookup(model, tokens):
                    with ctx.scope():
                        rows = model.embed(tokens, ctx)
                        return torch.autograd.grad(rows.float().sum(),
                                                   (model.tok_emb,))
                cells["lookup"] = (lookup, (model, tokens))
                for name, (fn, args) in cells.items():
                    made.clear()
                    profile_torch(fn, *args, mesh=mesh)
                    res[f"{vocab}/{name}"] = {
                        "heads": sorted({
                            (op, str(shp)) for op, shp, dt in made
                            if len(shp) == 4 and dt.is_floating_point
                            and shp[1] > H // MESH[1]}),
                        "table": sorted({
                            (op, str(shp)) for op, shp, dt in made
                            if len(shp) == 2 and dt == torch.bfloat16
                            and V in (shp[0], shp[1])
                            and shp[0] * shp[1] >= V * D})}
    with open(out, "w") as f:
        json.dump(res, f)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    return run_alone("test_torch_dryrun_heads", "traced",
                     tmp_path_factory.mktemp("dryrun_heads"), seconds=400)


@pytest.mark.parametrize("cell", ["prefill", "train"])
@pytest.mark.parametrize("vocab", list(VOCABS))
def test_attention_holds_own_heads_only(made, vocab, cell):
    assert made[f"{vocab}/{cell}"]["heads"] == []


@pytest.mark.parametrize("vocab,cell", [(v, c) for v in VOCABS
                                        for c in TABLE_CELLS[v]])
def test_no_whole_table_beside_the_parameters(made, vocab, cell):
    assert made[f"{vocab}/{cell}"]["table"] == []
