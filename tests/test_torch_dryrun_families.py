"""Every family's dry-run step traces on a fake mesh, and its attention and
SSD hold a rank's own heads only: each arch reduced (d 64, a few layers,
the reduced vocab) with its heads chosen so that they meet the model axis
of a 2 x 8 ``tp`` mesh (16 fake ranks) as the full arch's meet the model
axis of 16:

* neither the query nor the KV heads divide: smollm-135m (9 over 3),
  starcoder2-7b (12 over 4), minicpm3-4b (12, MLA);
* the query heads divide and the KV heads do not: nemotron-4-340b,
  llama-3.2-vision-11b, phi3.5-moe-42b (32 over 4);
* both divide: seamless-m4t-large-v2 (16 over 16; a non-causal encoder
  and cross-attention over 64 frames), zamba2-7b (16 over 16, 8 SSD
  heads), deepseek-v2-lite-16b (16, MLA); mamba2-2.7b (8 SSD heads).

Each is traced by ``profile_torch`` at a train step (16 rows, one a rank:
a mamba2 layer's conv and the residual between layers on each rank's own
rows), a prefill forward (2048 tokens: the flash branch) and a decode
step (a 64-deep cache), as ``launch.dryrun.build_cell`` builds them:

* every trace runs to its end.  DTensor's own pad (the SSD's causal conv,
  MLA's V padded to K's head dim) and its einsums over a split heads dim
  (the plain softmax where both head counts divide) failed in some torch
  releases at these shapes;
* where the query heads (or the SSD heads) divide the model axis, no
  operation of the train step or the prefill makes a 4-D tensor whose
  second dim is a heads dim over more heads than a rank's own H / 8, and
  over more rows x heads than a rank's share (scores, softmax, the flash
  blocks, the SSD's heads-first operands; sequence-first layouts are
  left out): in some torch
  releases DTensor's plan for the backward of the output projection built
  the gradient of every head on each rank.

The traces are ``tools/dryrun_families.py``'s; what each operation makes
is read as it is made (the profiler's recorder).  The fake group is
process-wide, so the traces run in a process of their own
(``torch_ranks.run_alone``)."""
import importlib.util
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_ranks import run_alone  # noqa: E402

TOOL = Path(__file__).resolve().parents[1] / "tools" / "dryrun_families.py"


def _tool():
    spec = importlib.util.spec_from_file_location("dryrun_families", TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


families = _tool()


def traced(out):
    with open(out, "w") as f:
        json.dump(_tool().trace(), f)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    return run_alone("test_torch_dryrun_families", "traced",
                     tmp_path_factory.mktemp("dryrun_families"), seconds=900)


@pytest.mark.parametrize("kind", families.KINDS)
@pytest.mark.parametrize("arch", list(families.FAMILIES))
def test_family_step_traces(made, arch, kind):
    assert made[f"{arch}/{kind}"]["error"] is None, \
        made[f"{arch}/{kind}"]["error"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", [a for a in families.FAMILIES if a not in (
    "smollm-135m", "starcoder2-7b", "minicpm3-4b")])
def test_family_holds_own_heads_only(made, arch, kind):
    assert made[f"{arch}/{kind}"]["heads"] == []
