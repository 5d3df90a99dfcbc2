"""The port's dry run end to end: ``python -m repro_torch.launch.dryrun
--device cpu`` in a subprocess (its fake process group of 256 ranks is
process-wide), on the cells ``tests/test_dryrun.py`` compiles with the
reference and the VLM's sharded decode (its cross layers on the frozen
cross cache), with the reference test's assertions: one row, ``ok``, 256
devices, a memory term, a dominant term, ``fits_hbm`` and both placement
policies.  No parameter storage is allocated: every tensor is fake."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("arch,shape", [
    ("smollm-135m", "decode_32k"),
    ("mamba2-2.7b", "long_500k"),
    ("llama-3.2-vision-11b", "decode_32k"),
])
def test_dryrun_cell_traces(arch, shape, tmp_path):
    out = tmp_path / "cell.jsonl"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--out", str(out), "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    rows = [json.loads(line) for line in open(out)]
    assert len(rows) == 1 and rows[0]["ok"]
    row = rows[0]
    assert row["devices"] == 256
    assert row["compute_s"] >= 0 and row["memory_s"] > 0
    assert row["dominant"] in ("compute", "memory", "collective")
    assert row["fits_hbm"] in (True, False)
    # placement analysis present with both policies
    assert "placement" in row
    assert {"linear", "tofa"} <= set(row["placement"])
    # the CPU places with the plain versions: no kernel was launched
    assert row["placement_launches"] == {}
    assert 0 < row["arg_bytes_per_dev"] <= row["total_bytes_per_dev"]


def test_dryrun_refuses_a_started_group():
    """The fake group is the dry run's own: a process that already runs
    one is refused, not joined."""
    r = subprocess.run(
        [sys.executable, "-c",
         "import torch.distributed as dist\n"
         "from torch.testing._internal.distributed.fake_pg import FakeStore\n"
         "dist.init_process_group('fake', store=FakeStore(), rank=0, "
         "world_size=2)\n"
         "from repro_torch.launch.dryrun import run_cell\n"
         "try:\n"
         "    run_cell('smollm-135m', 'decode_32k', multi_pod=False)\n"
         "except RuntimeError as e:\n"
         "    print('refused:', e)\n"],
        capture_output=True, text=True, cwd=ROOT, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert "refused: a process group is already started" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-2000:]
