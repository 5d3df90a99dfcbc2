#!/usr/bin/env python3
"""Drive the repro_torch port on one NVIDIA GPU and check what it returns.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA GPU and the CUDA
toolkit.  The script

1. builds the port's CUDA kernels from the ``.cu`` sources in the checkout
   (one ``nvcc`` per source, all started together);
2. holds each kernel against its plain PyTorch version on the card at full
   shapes, float64 and float32, with integer-valued inputs, requiring exact
   equality, and times both on the card alone (CUDA events around calls
   queued behind a spin kernel) and the kernel wrapper's host time, beside
   the time of one empty kernel timed the same way (``launch_floor_ms``);
   the hop kernels also at the implicit cells' shape of 1024 ranks;
3. places real jobs through the port's ``PlacementEngine`` (torch backend
   on ``cuda``, float64) — dense, fault-weighted, dense-guest, implicit
   torus and implicit fat-tree paths (512 ranks on 16384 and 8192 nodes)
   — and requires each hop-bytes to equal
   the reference package's NumPy result, and each kernel to have been
   launched on the path that needs it (launch counts are zeroed just
   before each placement and read just after, with a line of each
   kernel's most frequent launch shapes before each cell's line; the three
   cheap cells are placed once more under ``torch.profiler`` for the
   device's busy time);
4. holds each kernel against its plain version again at the largest shape
   the placements handed it, and reports those times in the summary line;
   the hop kernels also at the two shapes the placements launched them at
   most often, in both dtypes;
5. holds the model-stack kernels (``flash_attention``, ``rmsnorm``,
   ``swap_gain``) against their plain versions at the shapes smollm-135m
   gives them, within the reference's kernel-test tolerances (exactly, for
   ``swap_gain`` on integer-valued inputs), and times each beside the one
   PyTorch call that computes the same function, where there is one; the
   float32 ``flash_attention`` (3xTF32 on the tensor cores) is also held,
   beside its float32 plain version, to the plain version run in float64 at
   the three model shapes, and may be at most twice as far from it;
   ``swap_gain`` also at the largest dense guest's (4096, 4096) and, at
   (1024, 1024), with the L2 flushed before each timed call (``cold_ms``);
   ``rmsnorm`` and ``swap_gain`` are then driven once through their entry
   points;
6. runs smollm-135m at full width and depth (30 layers, float32,
   NumPy-seeded weights) on ``cuda``: a 2048-token forward through the
   flash kernel, held to the same forward through the plain version and to
   the reference package's logits (``EXPECTED_FORWARD``); 8 decode steps
   from empty caches, held to the forward (forward and decode then run
   once more under ``torch.profiler``); and the serve driver with its
   default arguments;
6a. runs the two other dense GQA archs after holding ``flash_attention``
   at their shapes, float32 against the float64 plain version too:
   starcoder2-7b at full width and depth (32 layers, 36 heads of 128 over
   4 KV heads, gelu MLP; 7.40 B parameters, 29.6 GB drawn on the card),
   its B 2 x 2048 forward (32 flash launches) held within 1e-4 to its
   plain-version forward, 8 decode steps held to it, and the serve
   driver; and nemotron-4-340b cut to one layer at full width (96 heads
   of 192 over 8, relu2 MLP of 73728, untied vocab 256000: 3.45 B
   parameters in the layer and 9.44 B of embeddings, 51.5 GB), its
   forward (one flash launch) and 8 decode steps held the same way, with
   no serve driver (it would build all 96 layers);
7. holds the ``ssd_scan`` kernel against the exact recurrence and the
   chunked plain version at the reference's kernel-test shapes, the
   reduced mamba2's and mamba2-2.7b's own (chunk 64 and 128), float32 and
   bfloat16, and runs mamba2-2.7b at full width: two layers on
   NumPy-seeded weights held to the reference package's logits
   (``EXPECTED_MAMBA2``); all 64 layers on a 2 x 2048-token forward, held
   to its plain-version forward; 8 decode steps from empty caches held to
   that forward; and the serve driver;
7a. runs zamba2-7b (hybrid: groups of mamba2 layers, each followed by one
   shared attention block) and minicpm3-4b (MLA attention) at full width,
   after holding ``flash_attention`` at their head dims (112; 96 with V
   padded) and ``ssd_scan`` at zamba2's d_state 64: each cut in depth on
   NumPy-seeded weights and held to the reference package's logits
   (``EXPECTED_ZAMBA2``, 7 layers, B 2 x 256; ``EXPECTED_MINICPM3``, 2
   layers, B 1 x 2048 through the flash branch), then at full depth on a
   2 x 2048-token forward held to its plain-version forward (zamba2: 81
   ``ssd_scan`` and 13 ``flash_attention`` launches; minicpm3: 62
   ``flash_attention``), 8 decode steps held to that forward, and the
   serve driver;
7b. runs the MoE family at full width after holding ``flash_attention`` at
   its head dims (phi3.5-moe-42b's 128, deepseek-v2-lite-16b's 192 with V
   padded from 128), float32 against the float64 plain version too:
   deepseek-v2-lite cut to 2 layers (one dense, one MoE) on NumPy-seeded
   weights, B 1 x 2048, held to ``EXPECTED_DSV2``; all 27 layers on a
   2 x 2048-token forward, held to its plain-version forward by the
   routing rule (``routing_verdict``: a token sent to other experts is
   allowed only where its router probabilities tie within 1e-4 of the
   k-th, and the logits before each row's first such token are held
   within 1e-4), 8 decode steps held to that forward by the same rule,
   and the serve driver; then phi3.5-moe-42b cut to ``PHI35_DEPTH``
   layers, its forward and 8 decode steps held the same way (no serve
   driver: it would build all 32 layers);
7c. runs the cross-attention families at full width after holding
   ``flash_attention`` at seamless-m4t-large-v2's decoder shape (16 heads
   of 64; llama-3.2-vision-11b's self layers run phi3.5's Dh 128 shape),
   each fed seeded source embeddings (``seeded_source``: the reference's
   zero stubs would make every cross-attention add nothing):
   llama-3.2-vision-11b cut to 5 layers (one group of 4 self layers and
   a cross layer over 1600 vision tokens) on NumPy-seeded weights, B 1 x
   2048, held to ``EXPECTED_VLM``; 10 layers (``VLM_HELD_DEPTH``), B 2 x
   2048, held to its plain-version forward within 1e-4 with 8 decode
   steps; all 40 layers (9.77 B parameters, 39.1 GB, drawn on the card:
   32 flash launches, none for the cross layers) and 8 decode steps held
   by the noise-floor rule (``floor_verdict``: within 1e-4 is below
   float32's own noise at that depth), and the serve driver;
   seamless-m4t-large-v2 cut to 2 + 2 layers over 2048 seeded frames,
   held to ``EXPECTED_SEAMLESS``; all 24 + 24 layers, B 2 x 2048 over
   2048 frames (24 flash launches, the encoder's and the
   cross-attention's plain), held to its plain-version forward, 8 decode
   steps on the cross cache ``encode`` and ``prefill_cross_cache``
   build, and the serve driver;
7d. holds the backward kernels (``kernel/flash_attention_bwd``,
   ``kernel/ssd_scan_bwd``): dq, dk, dv at smollm-135m's B 2 x 4096 and
   the five model shapes at B 2 x 2048 in float32 and in bfloat16 (Dh 64,
   96, 112, 128, 192; each record beside its kernel's time in the
   previous design, ``was_ms``), and the SSD's four gradients
   (with a nonzero final-state gradient) at mamba2's and zamba2's
   B 2 x 2048 in both types (each beside the CUDA-core design's time,
   ``was_ms``, with each of its four launches' device ms, ``split_ms``),
   each against the plain version's autograd
   gradients run in float64, at most twice as far as the same-dtype
   plain version's; two backwards bit-identical; the backward alone timed
   beside the plain version's backward and, for flash,
   ``F.scaled_dot_product_attention``'s;
7e. trains on the card (the ``train`` phases): the full-width smollm-135m
   on NumPy-seeded weights, three steps of ``make_train_step`` at B 2 x
   256 (no kernel below ``FLASH_MIN_SEQ``), each step's loss and gradient
   norm held to the reference package's (``EXPECTED_TRAIN``, by
   ``train_agrees``); the same model at B 8 x 1024 for 20 steps (the
   loss must fall; step time, tokens/s, peak memory, one step profiled
   and one counting its host syncs), with a checkpoint after 10 steps
   restored into a fresh model and AdamW state whose next step must
   equal the uninterrupted run's bit for bit (deterministic algorithms
   for that step); ``launch/train.py`` for 20 steps with a checkpoint
   every 10, then ``--resume`` to 30; deepseek-v2-lite-16b cut to 2
   layers at full width (MLA and MoE under grad, 1.085 B parameters),
   5 steps at B 2 x 1024 with finite gradients and a falling loss; then
   the cells through the backward kernels, each step launching one
   forward and one backward kernel a layer that reaches it:
   mamba2-2.7b cut to 2 layers and smollm-135m at B 1 x 2048, three
   steps each held to the reference's (``EXPECTED_TRAIN_MAMBA2``,
   ``EXPECTED_TRAIN_S2048``); mamba2-2.7b cut to 16 layers (0.90 B
   parameters) at B 2 x 2048 for 10 steps, zamba2-7b cut to 7 layers at
   B 1 x 2048 for 5, and smollm-135m at B 2 x 4096 for 10, each with a
   falling loss, step 1 held to the same step through the plain versions
   (``train_agrees``), step time, tokens/s, peak memory and one step
   profiled for the device's idle share and the backward kernels' share
   (the kernels alone, and each ``_backward`` between CUDA events, the
   ``ssd_scan`` states' recompute in it);
7f. runs the sharding layer at world size 1 (the ``parallel`` phase):
   an nccl group of its own and a 1 x 1 DeviceMesh on the card;
   smollm-135m at full width, B 2 x 2048, two sharded steps (DTensor
   parameters, each block checkpointed, the flash kernels through
   ``local_map``: 120 forward and 60 backward launches) held to two
   unsharded steps bit for bit (or by ``train_agrees``), each step's wall
   and the host ms DTensor adds; ``moe_ffn_ep`` and ``moe_ffn_a2a`` on
   deepseek-v2-lite-16b's MoE layer (B 1 x 2048) held to ``moe_ffn_local``
   by ``routing_verdict``; 8 ``flash_decode_gqa`` steps of smollm held to
   the plain decode within 1e-5; then the torus-16^3 npb_dt-1024 tofa
   placement through a backend of devices ``["cuda:0", "cuda:0"]`` (the
   sharded ``refine_many``) held to the one-device placement and
   ``EXPECTED``, and a sharded refine of an all-to-all guest on the
   implicit 8^3 torus (``swap_select``, ``torus_hop``) bit-equal to the
   one-device dispatch; every line with the card's name and power limit;
7g. runs the dry run (the ``dryrun`` phase): ``python -m
   repro_torch.launch.dryrun`` on smollm-135m and starcoder2-7b x
   train_4k and llama-3.2-vision-11b x decode_32k (its sharded decode,
   the cross layers included; 16 x 16 mesh) and deepseek-v2-lite-16b x
   decode_32k (2 x 16 x 16), each in a process
   of its own (its fake process group of 256 or 512 ranks is
   process-wide) with the placement analysis on the card, each row printed
   with the launches of each placement kernel in it, and the train
   cell's ``total_bytes_per_dev`` beside the card's name and power limit
   (it must fit the card: the cross entropy runs on each rank's vocab
   shard); TOFA on each cell's
   guest graph on the H100 fabric, on the card at float64, held bit for
   bit to the NumPy engine's placement; and, at world size 1 on an nccl
   group, ``make_tofa_mesh`` on a profile of the smollm-135m step and one
   ``parallel_train_cell`` step on the mesh it builds;
8. runs the paper's Section 5.2 experiment through the port's scenario
   presets with every placement on ``cuda`` (the ``paper`` phase):
   ``paper-fig4-5`` at the paper's protocol for 85-rank NPB-DT (10
   batches x 100 instances, 16 faulty candidates, p_f 0.02) and for
   64-rank LAMMPS (3 batches), each policy's completion times held bit for
   bit to the reference package's (``EXPECTED_PAPER``), one more NPB-DT
   batch under ``torch.profiler``; the scheduler's elastic re-placement of
   a LAMMPS job whose node dies, held to ``EXPECTED_ELASTIC``; and the
   nine other presets at ``fast=True``, each held to the same preset on
   the CPU;
9. runs the port's online placement service and replica engine with the
   engine on ``cuda`` (the ``service`` phase): the reference's full
   request storm (6x6x6 torus, 600 requests at 10/s, 24 flaky nodes
   failing 4 at a time every 5 s) for ``tofa`` and ``linear``, every
   simulated field held to the reference's (``EXPECTED_STORM``), tofa's
   cache hit rate at least 0.90 and its p99 completion below linear's,
   with placements per second reported beside the reference's CPU floor
   and the first 30 requests profiled; ``run_replicas("fat-tree",
   n_replicas=32, fast=True)`` held to the reference test's pinned
   statistics and to standalone presets, and four vectorized
   ``paper-fig4-5`` replicas to the event path; and ``compare_policies``
   / ``assign_devices`` on a two-pod fabric with degraded chips, held to
   the reference's hop-bytes (``EXPECTED_FABRIC``), whose all-to-all
   guest must launch ``swap_select``.

Steps 5 to 7f run between steps 2 and 3; ``ssd_scan`` and the new shapes
of steps 6a to 7c are checked with the other model kernels in step 5.  Each phase
prints one JSON line.  Then come the kernel summary line, the card's name
and power limit, and, only when every phase passed, the final
``{"ok": true, ...}`` line.  Any failure exits non-zero without it.  The
compiler's resource report (also printed, with each flash instance's
shared memory and blocks an SM holds), the profiler tables and every
phase's line (``chip_smoke.jsonl``) go to ``chiprun_out/``.

The script imports nothing of JAX or of the reference package.
"""
from __future__ import annotations

import contextlib
import json
import math
import re
import statistics
import subprocess
import sys
import time
import traceback
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
T_START = time.perf_counter()

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): HBM3
# bandwidth, the non-tensor-core float32 / float64 rates, and the dense
# bfloat16 and TF32 tensor-core rates.  float32 work is held to the
# non-tensor rate (main() turns TF32 off for matmul and cuDNN), except the
# flash kernel's, which computes float32-accurate products as three TF32
# ones (3xTF32) and is held to 3 x its operations at the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12, "bfloat16": 989e12,
            "tf32": 495e12}

# Reference hop-bytes.  The first two are committed in
# benchmarks/BENCH_mapping.json (trajectory point "pr9-sharded-refine").
# The others were computed with the reference package's NumPy engine
# (float64, policy seeded with np.random.default_rng(0)):
#   PYTHONPATH=src python -c "import numpy as np; from repro.core.engine \
#     import PlacementEngine, PlacementRequest; ...; print(PlacementEngine(\
#     backend='numpy').place(req, policy=..., rng=np.random.default_rng(0))\
#     .hop_bytes)"
# on the same request each phase below builds.
EXPECTED = {
    "place/torus-16x16x16/npb_dt-1024/healthy": 133004800000.0,
    "place/torus-16x16x16/npb_dt-1024/healthy/greedy": 150976000000.0,
    "place/fattree-k16/npb_dt-256/faulty32": 30182400000.0,
    "place/torus-16x16x16/alltoall-1024/healthy": 471755468750.0,
    "place/torus-32x32x16/npb_dt-512/implicit": 51673600000.0,
    "place/fattree-k32/npb_dt-512/faulty64": 55628800000.0,
}

# The paper's Section 5.2 experiment (paper phase): run_preset(
# "paper-fig4-5") at the paper's protocol (8x8x8 torus, 10 batches x 100
# instances, 16 faulty candidates per batch, p_f 0.02, seed 0) for 85-rank
# NPB-DT, and for 64-rank LAMMPS cut to 3 batches.  Each policy's batch
# completion times (simulated seconds), aborted attempts and event count,
# as the reference package's preset returns them on its NumPy engine; the
# test tests/test_torch_paper_expected.py recomputes them:
#   PYTHONPATH=src python -m pytest -q tests/test_torch_paper_expected.py
EXPECTED_PAPER = {
    "npb_dt-85": {
        "linear": {"batch_completions": [
            22.891540000000017, 21.67606000000001, 22.081220000000013,
            23.29670000000002, 21.270900000000008, 22.486380000000015,
            20.258000000000003, 21.47348000000001, 21.67606000000001,
            20.460580000000004], "aborted_attempts": 74, "n_events": 2148},
        "tofa": {"batch_completions": [
            15.642000000000024, 14.109999999999982, 14.10599999999999,
            14.104000000000017, 16.154000000000035, 14.62000000000002,
            14.62000000000002, 14.10599999999999, 15.130000000000042,
            13.593999999999983], "aborted_attempts": 0, "n_events": 2000},
    },
    "lammps-64": {
        "linear": {"batch_completions": [
            69.37440799999993, 63.74945599999994, 66.87442933333327],
            "aborted_attempts": 20, "n_events": 640},
        "tofa": {"batch_completions": [
            57.085866666666625, 56.85946666666676, 54.8870666666666],
            "aborted_attempts": 0, "n_events": 600},
    },
}
# the paper's TOFA improvement over Slurm's default placement
PAPER_IMPROVEMENT = {"npb_dt-85": 0.31, "lammps-64": 0.189}
# Elastic re-placement (examples/fault_tolerant_batch.py step 3) on a
# fresh scheduler: 8x8x8 torus, one all-replied heartbeat round,
# lammps_like(64) submitted under tofa, then the node under rank 10 dies.
# The reference package's scheduler on its NumPy engine gives this victim,
# hop-bytes before, and re-placement (recomputed by the same test).
EXPECTED_ELASTIC = {
    "victim": 10, "hop_bytes_before": 22338560000.0,
    "hop_bytes": 22645760000.0, "provenance": "replace-incremental",
    "placement": [
        15, 7, 56, 0, 9, 3, 2, 1, 17, 11, 19, 18, 16, 8, 49, 25, 71, 113,
        57, 121, 67, 123, 58, 122, 83, 75, 82, 146, 80, 73, 89, 81, 64,
        120, 185, 65, 131, 130, 186, 129, 139, 74, 66, 138, 144, 136, 137,
        145, 72, 79, 184, 128, 201, 202, 194, 193, 457, 458, 450, 449, 465,
        456, 505, 448],
}

# The full-width smollm-135m forward (model phase) is held to the
# reference package at these positions of each of its two rows.
HELD_POSITIONS = (0, 1023, 2047)
# forward_summary of the reference package's forward (CPU, float32) on the
# same weights, interop.seeded_params(smollm-135m, seed=0), and tokens,
# SyntheticDataset(49152, 2048, 2, seed=0).batch(0), that the model phase
# runs: row 0 at HELD_POSITIONS, then row 1.  The test
# tests/test_torch_models.py::test_expected_forward_is_the_reference
# recomputes them with the reference package:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_models.py -k expected_forward
EXPECTED_FORWARD = [
    [48467, -270.35507481644163, 0.04476463794708252],
    [41252, 104.98106756992638, 0.0692596435546875],
    [44141, 135.47028165729716, 0.2727811336517334],
    [34651, -61.52785515564028, 0.10175049304962158],
    [13620, -24.220059016370215, 0.060172438621520996],
    [43510, -93.21593950502574, 0.29175543785095215],
]


def forward_summary(held) -> list:
    """[argmax id, float64 sum, top-2 gap, L2 norm] of each row's logits
    at each held position; ``held`` is ``logits[:, positions]``, a (B,
    len(positions), V) NumPy array."""
    import numpy as np
    out = []
    for row in held:
        for v in np.asarray(row, dtype=np.float64):
            top2 = np.sort(v)[-2:]
            out.append([int(np.argmax(v)), float(v.sum()),
                        float(top2[1] - top2[0]), float(np.linalg.norm(v))])
    return out


def forward_agrees(summary, expected=EXPECTED_FORWARD) -> bool:
    """Sums within rtol 1e-4 of the expected ones, and argmax ids equal
    wherever the expected top-2 gap exceeds 1e-3.  Where the expected row
    also gives the logits' L2 norm, a sum is held within 1e-4 of the
    larger of its own size and that norm: V logits each off by ~1e-4 of
    their size in no common direction move their sum by ~1e-4 of the
    norm, which a sum that cancels to near zero does not bound."""
    return len(summary) == len(expected) and all(
        abs(s[1] - e[1]) <= 1e-4 * max([abs(e[1]), *e[3:]])
        and (s[0] == e[0] or e[2] <= 1e-3)
        for s, e in zip(summary, expected))


# The cut-depth mamba2-2.7b forward (two layers, full width, B 2 x 256
# tokens) is held to the reference package at these positions.
MAMBA2_HELD_POSITIONS = (0, 127, 255)
# forward_summary of the reference package's forward (CPU, float32) on
# interop.seeded_params(mamba2-2.7b with n_layers=2, seed=0) and
# SyntheticDataset(50280, 256, 2, seed=0).batch(0): row 0 at
# MAMBA2_HELD_POSITIONS, then row 1.  Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_ssm.py -k expected_mamba2
EXPECTED_MAMBA2 = [
    [25942, 30.699237526394427, 0.7524933815002441],
    [14439, 38.93713191058487, 0.30605459213256836],
    [5842, -225.65918770618737, 0.37107372283935547],
    [12249, 175.2925356309861, 0.2604396343231201],
    [21853, 405.7033743020147, 0.2919578552246094],
    [11623, 198.10172006301582, 0.5906195640563965],
]


# The cut-depth zamba2-7b forward (7 layers: one group of 6 mamba2 layers,
# the shared block, one trailing layer; full width; B 2 x 256 tokens) is
# held to the reference package at these positions.
ZAMBA2_HELD_POSITIONS = (0, 127, 255)
# forward_summary of the reference package's forward (CPU, float32) on
# interop.seeded_params(zamba2-7b with n_layers=7, seed=0) and
# SyntheticDataset(32000, 256, 2, seed=0).batch(0): row 0 at
# ZAMBA2_HELD_POSITIONS, then row 1, each with its logits' L2 norm, which
# bounds the sum's tolerance (forward_agrees).  Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_hybrid.py -k expected_zamba2
EXPECTED_ZAMBA2 = [
    [10780, 63.786664771148935, 0.026947021484375, 214.57965636851694],
    [25518, -231.49328653048724, 0.04395341873168945, 212.99258329548098],
    [25688, -33.41605650819838, 0.45428466796875, 216.1453059521404],
    [20901, -5.104152203537524, 0.03411245346069336, 215.58148619136907],
    [4521, -17.829670194536448, 0.1756601333618164, 215.359289043662],
    [12285, 254.16348306136206, 0.19585514068603516, 214.30284549485557],
]
# The cut-depth minicpm3-4b forward (2 layers, full width, B 1 x 2048
# tokens: the flash branch with V padded 64 -> 96) is held at these.
MINICPM3_HELD_POSITIONS = (0, 1023, 2047)
# forward_summary of the reference package's forward (CPU, float32) on
# interop.seeded_params(minicpm3-4b with n_layers=2, seed=0) and
# SyntheticDataset(73448, 2048, 1, seed=0).batch(0) at
# MINICPM3_HELD_POSITIONS.  Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_mla.py -k expected_minicpm3
EXPECTED_MINICPM3 = [
    [14733, -319.2522032801062, 0.11726045608520508, 275.1309757798686],
    [19628, -198.0785928685218, 0.31125354766845703, 274.01266138207285],
    [2722, 399.5780456913635, 0.3611917495727539, 273.16618967684485],
]
# The cut-depth deepseek-v2-lite-16b forward (2 layers: layer 0 dense,
# layer 1 MoE with 64 experts top-6 and 2 shared; full width; B 1 x 2048
# tokens: the flash branch with V padded 128 -> 192) is held at these.
DSV2_HELD_POSITIONS = (0, 1023, 2047)
# forward_summary of the reference package's forward (CPU, float32) on
# interop.seeded_params(deepseek-v2-lite-16b with n_layers=2, seed=0) and
# SyntheticDataset(102400, 2048, 1, seed=0).batch(0) at
# DSV2_HELD_POSITIONS.  Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_moe.py -k expected_deepseek
EXPECTED_DSV2 = [
    [44783, 537.3467696146108, 0.1911776065826416, 289.0076596816154],
    [95756, 369.65182813233696, 0.42598867416381836, 290.85648175541644],
    [50262, -84.17194872675464, 0.16052865982055664, 289.12154153873934],
]

# The cut-depth llama-3.2-vision-11b forward (5 layers: one group of 4
# self-attention layers and its cross layer; full width; B 1 x 2048
# tokens: the flash branch, and the cross layer's plain attention to 1600
# seeded vision embeddings) is held to the reference package at these.
VLM_HELD_POSITIONS = (0, 1023, 2047)
# forward_summary of the reference package's forward (CPU, float32) on
# interop.seeded_params(llama-3.2-vision-11b with n_layers=5, seed=0),
# SyntheticDataset(128256, 2048, 1, seed=0).batch(0) and
# seeded_source((1, 1600, 4096), seed=0) at VLM_HELD_POSITIONS.
# Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_vlm.py -k expected_vlm
EXPECTED_VLM = [
    [110426, -170.73093337286264, 0.7487006187438965, 459.1299728463319],
    [42887, -106.39505392784486, 0.09175395965576172, 459.2434031340946],
    [98372, -164.99776898720302, 0.11436986923217773, 458.5914367972209],
]
# The cut-depth seamless-m4t-large-v2 forward (2 encoder + 2 decoder
# layers, full width, B 1 x 2048 tokens over 2048 seeded source frames:
# the decoder's self-attention through the flash branch, the encoder's
# and the cross-attention plain) is held at these.
SEAMLESS_HELD_POSITIONS = (0, 1023, 2047)
# forward_summary of the reference package's forward (CPU, float32) on
# interop.seeded_params(seamless-m4t-large-v2 with n_enc_layers=2,
# n_layers=2, seed=0), SyntheticDataset(256206, 2048, 1, seed=0).batch(0)
# and seeded_source((1, 2048, 1024), seed=0) at SEAMLESS_HELD_POSITIONS.
# Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_encdec.py -k expected_seamless
EXPECTED_SEAMLESS = [
    [166383, -76.17551796883345, 0.0017790794372558594, 324.68329781652074],
    [25330, 162.9665769515559, 0.04574751853942871, 323.4718411841582],
    [39915, 375.71638720016927, 0.00023746490478515625, 323.63932222569224],
]

# The held training cell (train/smollm-135m/held): the full-width
# smollm-135m (30 layers) on interop.seeded_params(seed=0) weights, three
# steps of make_train_step with AdamW(**TRAIN_HELD_OPT), step i on
# SyntheticDataset(49152, TRAIN_HELD_SEQ, TRAIN_HELD_BATCH, seed=0)
# .batch(i).
TRAIN_HELD_BATCH, TRAIN_HELD_SEQ = 2, 256
TRAIN_HELD_OPT = {"lr": 1e-2, "warmup_steps": 1}
# [loss, grad_norm] of each step of the reference package's
# make_train_step on the same weights and batches (CPU, float32): the loss
# as it reports it, the gradient norm in float64 over the reference's
# gradients at that step (its own float32 norm sums a leaf with
# XLA:CPU's jnp.sum, 1.2e-4 short of this at step 1).  Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_train.py -k expected_train
EXPECTED_TRAIN = [
    [10.966775894165039, 23.587729696067537],
    [10.919955253601074, 3.91367841174439],
    [10.972583770751953, 1.2541776366239366],
]
# How far float32 alone carries each step from EXPECTED_TRAIN: the
# largest relative difference of the port's loss or grad_norm, run on the
# CPU at one and at eight intra-op threads (two summation orders of the
# same products; the same test measures it).  A step moves each weight
# whose clipped gradient is near AdamW's eps (1e-8) by an amount that
# rounding decides, and at lr 1e-2 the steps after the first carry that
# on: the grad_norm of step 3 lands 8.7e-4 apart.
TRAIN_SPREAD = [5e-7, 8.6e-5, 8.7e-4]


def train_agrees(got, expected=EXPECTED_TRAIN, spread=TRAIN_SPREAD) -> bool:
    """Each step's loss and grad_norm within rtol 1e-4 of ``expected``,
    or, where the step's float32 spread exceeds half of that, within
    ``FLOOR_FACTOR`` times the spread (the noise-floor rule)."""
    return len(got) == len(expected) and all(
        abs(g - e) <= max(1e-4, FLOOR_FACTOR * s) * abs(e)
        for gs, es, s in zip(got, expected, spread)
        for g, e in zip(gs, es))


def held_train_steps(model, batch: int = TRAIN_HELD_BATCH,
                     seq: int = TRAIN_HELD_SEQ,
                     steps: int = len(EXPECTED_TRAIN)) -> list:
    """The held training steps on ``model`` (a model on its seeded
    weights, on any device): ``steps`` steps of ``make_train_step`` with
    AdamW(**TRAIN_HELD_OPT), step i on ``SyntheticDataset(vocab, seq,
    batch, seed=0).batch(i)``; [loss, grad_norm] of each step."""
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    opt = AdamW(**TRAIN_HELD_OPT)
    step, state = make_train_step(model.cfg, opt), opt.init(model)
    ds = SyntheticDataset(model.cfg.vocab, seq, batch, seed=0)
    out = []
    for i in range(steps):
        state, m = step(model, state, ds.batch(i))
        out.append([float(m["loss"]), float(m["grad_norm"])])
    return out


# The held cells through the backward kernels, each [loss, grad_norm] of
# three steps as EXPECTED_TRAIN's are taken, from the reference package's
# make_train_step on the CPU, and each one's float32 spread as
# TRAIN_SPREAD's is measured.  mamba2-2.7b at full width cut to 2 layers
# (interop.seeded_params(seed=0), the weights of forward-256-L2), B 2 x 256:
# every layer's SSD through ssd_scan and its backward.  Recomputed by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \
#       tests/test_torch_backward_expected.py
EXPECTED_TRAIN_MAMBA2 = [
    [11.377680778503418, 9.774716258463426],
    [11.258695602416992, 7.6909804791063525],
    [11.333414077758789, 6.341254246917823],
]
TRAIN_SPREAD_MAMBA2 = [8.4e-8, 1.1e-6, 9.6e-6]
# smollm-135m at full width and depth on the weights of
# train/smollm-135m/held, B 1 x 2048: every layer's attention through the
# flash kernel and its backward (the reference: flash_attention_ref under
# jax.grad).  Recomputed by tests/test_torch_backward_s2048.py.
TRAIN_S2048_SEQ = 2048
EXPECTED_TRAIN_S2048 = [
    [10.913718223571777, 12.504095233706138],
    [10.919633865356445, 3.0842525241471477],
    [10.964717864990234, 2.023598864134197],
]
# at lr 1e-2 the second step's update moves every weight whose gradient
# rounding decides by the full lr, and over 2048 tokens the third step's
# gradient norm lands 1.1e-2 apart at one and at eight threads; measured by
#   PYTHONPATH=src python3 tools/train_spread.py \
#       --cell smollm-135m/held-S2048
TRAIN_SPREAD_S2048 = [6.3e-7, 6.7e-5, 1.1e-2]


def seeded_source(shape: tuple, seed: int = 0):
    """Source embeddings (a VLM's vision embeddings, an encoder-decoder
    model's frames) of ``shape``: float32 standard normals from
    ``default_rng([seed, 1])``, a stream apart from the weights'
    ``default_rng(seed)``.  The reference's stubs are zeros, under which
    every cross-attention adds nothing; the model cells feed these."""
    import numpy as np
    return np.random.default_rng([seed, 1]).standard_normal(
        shape, dtype=np.float32)


KERNELS = {
    "swap_select": dict(
        source="src/repro_torch/kernels/swap_gain/swap_select.cu",
        replaces="src/repro/kernels/swap_gain/kernel.py:126"),
    "torus_hop": dict(
        source="src/repro_torch/kernels/hop_dist/hop_dist.cu",
        replaces="src/repro/kernels/hop_dist/kernel.py:35"),
    "fattree_hop": dict(
        source="src/repro_torch/kernels/hop_dist/hop_dist.cu",
        replaces="src/repro/kernels/hop_dist/kernel.py:85"),
    "swap_gain": dict(
        source="src/repro_torch/kernels/swap_gain/swap_select.cu",
        replaces="src/repro/kernels/swap_gain/kernel.py:43"),
    "flash_attention": dict(
        source="src/repro_torch/kernels/flash_attention/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81"),
    "rmsnorm": dict(
        source="src/repro_torch/kernels/rmsnorm/rmsnorm.cu",
        replaces="src/repro/kernels/rmsnorm/kernel.py:24"),
    "ssd_scan": dict(
        source="src/repro_torch/kernels/ssd_scan/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:75"),
    # the backward kernels: gradients of the TPU kernels at `replaces`,
    # which define none (the reference trains through their plain versions)
    "flash_attention_bwd": dict(
        source="src/repro_torch/kernels/flash_attention/"
               "flash_attention_bwd.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:81",
        twin="none: the backward of the kernel at replaces"),
    "ssd_scan_bwd": dict(
        source="src/repro_torch/kernels/ssd_scan/ssd_scan_bwd.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:75",
        twin="none: the backward of the kernel at replaces"),
}


# every emitted line is also kept here in full, for runs whose standard
# output is kept only in part
LOG = OUT_DIR / "chip_smoke.jsonl"


def emit(obj) -> None:
    if "phase" in obj:                      # seconds since the run began
        obj = {**obj, "t": time.perf_counter() - T_START}
    line = json.dumps(obj)
    print(line, flush=True)
    if LOG.parent.is_dir():
        with LOG.open("a") as f:
            f.write(line + "\n")


def ptxas_report(logs: dict) -> list:
    """Registers and spill bytes of every kernel instance in ptxas's
    report (``nvcc -Xptxas -v``), by source; names demangled with
    ``c++filt`` where it is installed."""
    rows, cur = [], None
    for source, log in logs.items():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                cur = {"source": source, "kernel": m.group(1)}
                rows.append(cur)
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and cur is not None:
                cur["spill_store_bytes"] = int(m.group(1))
                cur["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur is not None:
                cur["registers"] = int(m.group(1))
    try:
        out = subprocess.run(["c++filt"], input="\n".join(
            r["kernel"] for r in rows), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    if len(out) == len(rows):
        for r, name in zip(rows, out):
            name = name.replace("(anonymous namespace)::", "")
            r["kernel"] = name.split("(")[0].removeprefix("void ")
    return rows


def flash_resources() -> list:
    """Dynamic shared memory, registers, local (spill) bytes a thread and
    blocks an SM holds, of every flash_attention instance on this card."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS,
                                                         kernel_resources)
    return [{"dtype": str(dt).removeprefix("torch."), "Dh": d,
             **kernel_resources(dt, d)}
            for dt in (torch.float32, torch.bfloat16) for d in HEAD_DIMS]


def flash_bwd_resources() -> list:
    """The same of each backward kernel (dQ, dK/dV) of every
    flash_attention_bwd instance."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (HEAD_DIMS,
                                                         bwd_kernel_resources)
    return [{"dtype": str(dt).removeprefix("torch."), "Dh": d,
             "kernel": name, **res}
            for dt in (torch.float32, torch.bfloat16) for d in HEAD_DIMS
            for name, res in bwd_kernel_resources(dt, d).items()]


def cuda_ms(fn, reps: int = 20, trials: int = 5, warmup: int = 3,
            strict: bool = True) -> tuple[float, float, bool]:
    """(device ms, host ms, queued ahead) per call of ``fn()``, medians of
    ``trials``.

    Device: CUDA events around ``reps`` back-to-back calls, enqueued
    behind a spin kernel (``torch.cuda._sleep``) that keeps the card busy
    until the host has queued all of them, so the events hold only the
    card's work, not the host's launch cost between calls.  With
    ``strict``, a trial whose first event the card reached before the
    host finished queueing is repeated with a spin twice as long; without
    it (a function that waits for the card itself, as the plain versions
    may) the trial is kept and the third value says whether every kept
    trial stayed ahead.  Host: wall time of queueing the ``reps`` calls,
    per call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, host, spin, all_ahead = [], [], 1 << 22, True
    while len(dev) < trials:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        queued = time.perf_counter() - t0
        ahead = not a.query()
        b.record()
        b.synchronize()
        if strict and not ahead:
            if spin >= 1 << 30:
                raise RuntimeError("the card caught up with the host "
                                   "however long the spin ahead of it")
            spin *= 2
            continue
        all_ahead &= ahead
        dev.append(a.elapsed_time(b) / reps)
        host.append(queued / reps * 1e3)
    return statistics.median(dev), statistics.median(host), all_ahead


def cold_ms(fn, trials: int = 25, warmup: int = 3,
            flush_bytes: int = 1 << 27) -> tuple[float, bool]:
    """(device ms, queued ahead) of one call of ``fn()`` that finds the L2
    cold, median of ``trials``.  Before each trial a write of
    ``flush_bytes`` (128 MB, over twice the 50 MB L2) evicts what the last
    call left there; then a spin kernel (as in ``cuda_ms``), and CUDA events
    around the one call alone.  A trial whose first event the card reached
    before the host had queued the call is repeated with a spin twice as
    long; the second value says whether every kept trial stayed ahead."""
    import torch
    flush = torch.empty(flush_bytes // 4, dtype=torch.float32,
                        device=torch.cuda.current_device())
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    dev, spin = [], 1 << 22
    while len(dev) < trials:
        flush.fill_(float(len(dev)))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        a.record()
        fn()
        ahead = not a.query()
        b.record()
        b.synchronize()
        if not ahead:
            if spin >= 1 << 30:
                return statistics.median(dev or [a.elapsed_time(b)]), False
            spin *= 2
            continue
        dev.append(a.elapsed_time(b))
    return statistics.median(dev), True


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------------ kernels
def _tdtype(name: str):
    import torch
    return {"float64": torch.float64, "float32": torch.float32,
            "bfloat16": torch.bfloat16}[name]


def check_swap_select(dev, dt: str, B: int, n: int, tag: str) -> dict:
    """swap_select against its plain version at (B, n, n): several mover
    sets, a padded n_valid with padding movers, and an all-reject case."""
    import numpy as np
    import torch
    from repro_torch.kernels.swap_gain.ops import swap_select
    from repro_torch.kernels.swap_gain.ref import swap_select_ref

    rng = np.random.default_rng(0)
    tdt, size = _tdtype(dt), (8 if dt == "float64" else 4)
    A = rng.integers(0, 7, (B, n, n))
    M = torch.tensor(A + A.transpose(0, 2, 1), dtype=tdt, device=dev)
    S = rng.integers(0, 5, (n, n)) * (rng.random((n, n)) < 0.3)
    G = torch.tensor(S + S.T, dtype=tdt, device=dev)
    contrib = (G[None] * M).sum(-1)
    nv_pad = max(1, n * 125 // 128)             # 1000 of 1024 live
    cases = [(M, G, contrib, torch.tensor(rng.integers(0, n, B)), n),
             (M, G, contrib, torch.tensor(rng.integers(0, n, B)), nv_pad)]
    one = torch.ones((n, n), dtype=tdt, device=dev) - torch.eye(
        n, dtype=tdt, device=dev)
    Mo = one.expand(B, n, n).contiguous()
    cases.append((Mo, one, (one[None] * Mo).sum(-1),
                  torch.arange(B) % n, n))
    exact, err = True, 0.0
    for k, (Mx, Gx, cx, i, nv) in enumerate(cases):
        i = i.to(dev)
        g_k, j_k = swap_select(Mx, Gx, cx, i, nv, impl="kernel")
        g_r, j_r = swap_select_ref(Mx, Gx, cx, i, nv)
        torch.cuda.synchronize()
        exact &= bool(torch.equal(j_k, j_r)) and bool(torch.equal(g_k, g_r))
        if k == 2:                               # every mover rejected
            exact &= bool(torch.equal(j_k, i))
        err = max(err, float((g_k - g_r).abs().max()))
    i = cases[0][3].to(dev)
    # n_valid as a device tensor, as the refine loop hands it over: an
    # int would cost a blocking host-to-device copy in every call
    nv = torch.tensor([n], dtype=torch.int32, device=dev)
    ms, host, _ = cuda_ms(lambda: swap_select(M, G, contrib, i, nv,
                                              impl="kernel"))
    plain, _, plain_ahead = cuda_ms(
        lambda: swap_select_ref(M, G, contrib, i, n), strict=False)
    nbytes = (B * n * n + n * n + B * n) * size + B * (8 + size + 8)
    bnd, by = bound_ms(nbytes, 4.0 * B * n * n, dt)
    rec = dict(max_abs_err=err, ms=ms, host_ms=host, plain_ms=plain,
               plain_queued_ahead=plain_ahead, bound_ms=bnd, bound_by=by)
    emit({"phase": tag, "kernel": "swap_select", "dtype": dt,
          "shape": [B, n, n], "exact": exact, **rec})
    if not exact:
        raise AssertionError(f"swap_select disagrees at {(B, n, dt)}")
    return rec


def check_hop(dev, kernel: str, dt: str, B: int, m: int, k: int,
              tag: str, dims=(32, 32, 16), arity: int = 32) -> dict:
    """torus_hop / fattree_hop against the plain version at (B, m, k)."""
    import numpy as np
    import torch
    from repro_torch.kernels.hop_dist import ops as hop_ops
    from repro_torch.kernels.hop_dist.ref import (fattree_hop_pairs_ref,
                                                  torus_hop_pairs_ref)

    rng = np.random.default_rng(1)
    tdt, size = _tdtype(dt), (8 if dt == "float64" else 4)
    if kernel == "torus_hop":
        ext = dims
        run = lambda a, b: hop_ops.torus_hop(a, b, dims, impl="kernel")
        ref = lambda a, b: torus_hop_pairs_ref(a, b, dims)
        ops_per = 5.0 * len(dims)
    else:
        ext = (arity, arity // 2, arity // 2)
        run = lambda a, b: hop_ops.fattree_hop(a, b, impl="kernel")
        ref = fattree_hop_pairs_ref
        ops_per = 9.0
    cu = torch.tensor(np.stack([rng.integers(0, e, (B, m)) for e in ext], -1),
                      dtype=tdt, device=dev)
    cv = torch.tensor(np.stack([rng.integers(0, e, (B, k)) for e in ext], -1),
                      dtype=tdt, device=dev)
    out_k, out_r = run(cu, cv), ref(cu, cv)
    torch.cuda.synchronize()
    exact = bool(torch.equal(out_k, out_r))
    err = float((out_k - out_r).abs().max())
    del out_k, out_r
    ms, host, _ = cuda_ms(lambda: run(cu, cv))
    plain, _, plain_ahead = cuda_ms(lambda: ref(cu, cv), strict=False)
    nbytes = (B * (m + k) * len(ext) + B * m * k) * size
    bnd, by = bound_ms(nbytes, ops_per * B * m * k, dt)
    rec = dict(max_abs_err=err, ms=ms, host_ms=host, plain_ms=plain,
               plain_queued_ahead=plain_ahead, bound_ms=bnd, bound_by=by,
               launch_floor_ms=LAUNCH_FLOOR_MS[0])
    emit({"phase": tag, "kernel": kernel, "dtype": dt, "shape": [B, m, k],
          "extents": list(ext), "exact": exact, **rec})
    if not exact:
        raise AssertionError(f"{kernel} disagrees at {(B, m, k, dt)}")
    return rec


# device ms of one empty kernel, timed as a kernel launch is (cuda_ms): the
# least a launch at any shape costs here; the latest reading
LAUNCH_FLOOR_MS = [None]


def launch_floor(tag: str) -> float:
    """Time ``torch.cuda._sleep(0)``, a one-thread kernel that returns at
    once, exactly as the kernels are timed, and emit it."""
    import torch
    ms, host, _ = cuda_ms(lambda: torch.cuda._sleep(0))
    LAUNCH_FLOOR_MS[0] = ms
    emit({"phase": tag, "launch_floor_ms": ms, "host_ms": host})
    return ms


# the implicit cells' shapes of 1024 ranks, cut to 512 in the placement
# phases for the script's time
HOP_USER_SHAPE = (2, 1024, 1024)


def kernel_phase(dev) -> None:
    """Each kernel against its plain version at the full shapes TOFA's
    16-candidate stack gives it, float64 and float32; the hop kernels also
    at the implicit cells' shape of 1024 ranks."""
    import torch
    launch_floor("kernels/launch-floor")
    for dt in ("float64", "float32"):
        check_swap_select(dev, dt, 16, 1024, "kernels")
        for name in ("torus_hop", "fattree_hop"):
            check_hop(dev, name, dt, 16, 1024, 1024, "kernels")
            check_hop(dev, name, dt, *HOP_USER_SHAPE, "kernels")
        torch.cuda.empty_cache()


def main_shape_phase(dev) -> dict:
    """Each kernel at the largest shape the main path handed it (float64,
    the main path's dtype); these numbers go into the summary line.  The
    hop kernels also at that shape in float32 and at the two shapes the
    path launched them at most often, in both dtypes."""
    launch_floor("kernels/main-shape/launch-floor")
    recs = {}
    for name in ("swap_select", "torus_hop", "fattree_hop"):
        shape = MAIN_PATH_SHAPES[name]
        if shape is None:
            continue
        if name == "swap_select":
            recs[name] = check_swap_select(dev, "float64", shape[0],
                                           shape[1], "kernels/main-shape")
            continue
        recs[name] = check_hop(dev, name, "float64", *shape,
                               "kernels/main-shape")
        check_hop(dev, name, "float32", *shape, "kernels/main-shape")
        for often, _ in MAIN_PATH_SHAPE_COUNTS[name].most_common(2):
            for dt in ("float64", "float32"):
                if often != tuple(shape):
                    check_hop(dev, name, dt, *often,
                              "kernels/frequent-shape")
    return recs


# --------------------------------------------------------------- placement
def _faults(n_nodes: int, count: int):
    import numpy as np
    p_f = np.zeros(n_nodes)
    bad = np.random.default_rng(7).choice(n_nodes, count, replace=False)
    p_f[bad] = 0.02
    return p_f


def place_phase(name: str, request, policies=("tofa",),
                need: tuple = (), profile: bool = False,
                warm: bool = True) -> None:
    """Cold then (with ``warm``) warm placement per policy on a fresh
    engine; checks the hop-bytes against the reference, that a warm
    placement repeats the cold one, and that ``need`` kernels ran.  With
    ``profile``, one more placement runs under ``torch.profiler`` to read
    the device's busy time (the per-op table goes to ``chiprun_out/``)."""
    import numpy as np
    import torch
    from repro_torch.core import mapping_torch
    from repro_torch.core.engine import PlacementEngine
    from repro_torch.kernels import (LAUNCHES, SHAPE_COUNTS, SHAPES,
                                     reset_launches)

    engine = PlacementEngine()                      # torch, cuda, float64
    for pol in policies:
        key = name if pol == "tofa" else f"{name}/{pol}"
        reset_launches()
        mapping_torch.reset_stats()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        plan = engine.place(request, policy=pol, rng=np.random.default_rng(0))
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        launches = dict(LAUNCHES)
        layer = {k: dict(v) for k, v in mapping_torch.STATS.items()
                 if v["calls"]}
        for k, v in launches.items():
            MAIN_PATH_LAUNCHES[k] += v
            keep_shape(k, SHAPES[k])
            MAIN_PATH_SHAPE_COUNTS[k].update(SHAPE_COUNTS[k])
        emit_launch_shapes(key, SHAPE_COUNTS)
        p = np.asarray(plan.placement)
        warm_s, repeats = None, True
        if warm:
            t0 = time.perf_counter()
            warm_plan = engine.place(request, policy=pol,
                                     rng=np.random.default_rng(0))
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
            repeats = np.array_equal(p, warm_plan.placement)
        valid = (p.dtype.kind == "i" and len(set(p.tolist())) == len(p)
                 and bool(np.isin(p, request.available_ids).all()))
        ok = (valid and repeats and plan.hop_bytes == EXPECTED[key]
              and all(launches[k] > 0 for k in need))
        row = {"phase": key, "policy": pol, "n_procs": request.n_procs,
               "n_nodes": request.n_nodes, "cold_s": cold, "warm_s": warm_s,
               "hop_bytes": plan.hop_bytes, "expected": EXPECTED[key],
               "launches": launches, "needs": list(need),
               "cold_layer": layer,
               "transfers": engine.backend.stats["transfers"],
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "ok": ok}
        if profile and pol == "tofa":
            row.update(profiled(lambda: engine.place(
                request, policy="tofa", rng=np.random.default_rng(0)), key))
        emit(row)
        if not ok:
            raise AssertionError(f"{key} failed its check")


def profiled(run, key: str, spans=()) -> dict:
    """``run()`` once more, warm, under torch.profiler: wall time, summed
    device time of every kernel and copy, and the device idle share.

    ``spans`` are (module, function name, label): each function is wrapped
    in ``record_function(label)`` for the run, and the device time of the
    kernels launched by the ops inside it is reported by label
    (``span_device_s``), beside the ``flash_attention`` kernel's and the
    matrix products' (kernels named ``*gemm*``).

    The sums are taken over the profiler's raw events
    (``kineto_results.events()``): ``key_averages()`` builds a Python
    event and its place in a parent tree for each of them, which cost up
    to 87 s a profile on an H100 (the storm's first 30 requests) where
    these sums take seconds."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def in_span(label, fn):
        def wrapper(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    labels = {label for *_, label in spans}
    torch.cuda.synchronize()
    t_in = time.perf_counter()
    with contextlib.ExitStack() as stack:
        for module, name, label in spans:
            stack.enter_context(patched(module, name,
                                        lambda f, lb=label: in_span(lb, f)))
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.name() not in PROFILER_OWN_EVENTS:
            (dev if e.device_type() == DeviceType.CUDA else host).append(e)
    # "Command Buffer Full" is CUPTI's record of the host waiting on a
    # full launch queue, not work on the card: kept apart from busy time;
    # so are the spans' own device-side ranges
    stall = "Command Buffer Full"
    work = [e for e in dev if e.name() != stall and e.name() not in labels]
    busy = sum(e.duration_ns() for e in work) / 1e9
    extra = {}
    if spans:
        extra["span_device_s"] = span_device_s(host, work, labels)
        for part, test in (("flash_attention", lambda k: "flash" in k),
                           ("gemm", lambda k: "gemm" in k.lower()),
                           ("flash_attention_bwd", lambda k: any(
                               n in k for n in FLASH_BWD_KERNEL_NAMES)),
                           ("ssd_scan_bwd", lambda k: any(
                               n in k for n in SSD_BWD_KERNEL_NAMES))):
            extra[f"{part}_device_s"] = sum(
                e.duration_ns() for e in work if test(e.name())) / 1e9
    OUT_DIR.mkdir(exist_ok=True)
    fname = OUT_DIR / ("profile_" + key.replace("/", "_") + ".txt")
    fname.write_text(event_table(work, "device kernels and copies")
                     + "\n" + event_table(host, "host ops (inclusive)"))
    return {"profiled_wall_s": wall, "device_busy_s": busy,
            # the profiler's own cost: tracing, stopping, the sums, tables
            "profiler_s": time.perf_counter() - t_in - wall,
            "device_idle_share": 1.0 - busy / wall,
            "device_ops": len(work),
            "command_buffer_full_s": sum(stall_s(e) for e in dev + host
                                         if e.name() == stall),
            **extra}


def stall_s(e) -> float:
    """A "Command Buffer Full" event's seconds, as ``key_averages()``
    counts them: the host records it with the CUDA time CUPTI gave it."""
    from torch.autograd import DeviceType
    if e.device_type() == DeviceType.CUDA:
        return e.duration_ns() / 1e9
    return max(e.cuda_elapsed_us(), 0) / 1e6


# events the profiler records about itself (torch's own tables skip them)
PROFILER_OWN_EVENTS = frozenset((
    "[memory]", "[OutOfMemory]", "profiler::_record_function_enter",
    "profiler::_record_function_enter_new",
    "profiler::_record_function_exit"))


def span_device_s(host: list, work: list, labels) -> dict:
    """Each label's device seconds: the device events (``work``) whose
    launching op began, on the span's thread, inside a ``label`` span;
    an op inside two nested spans of one label counts twice, as
    torch's ``key_averages()`` counts it."""
    import bisect
    spans = {label: [] for label in labels}
    for e in host:
        if e.name() in spans:
            spans[e.name()].append((e.start_ns(), e.end_ns(),
                                    e.start_thread_id()))
    starts, longest = {}, {}
    for label, ivs in spans.items():
        ivs.sort()
        starts[label] = [s for s, _, _ in ivs]
        longest[label] = max((end - s for s, end, _ in ivs), default=0)
    # the op (a host event linked to no other) each device event names
    ops = {e.correlation_id(): (e.start_ns(), e.start_thread_id())
           for e in host if e.linked_correlation_id() == 0}
    out = dict.fromkeys(labels, 0)
    for e in work:
        op = ops.get(e.linked_correlation_id())
        if op is None:
            continue
        t, thread = op
        for label, ivs in spans.items():
            i = bisect.bisect_right(starts[label], t) - 1
            while i >= 0 and ivs[i][0] >= t - longest[label]:
                s, end, th = ivs[i]
                if th == thread and t <= end:
                    out[label] += e.duration_ns()
                i -= 1
    return {label: out[label] / 1e9 for label in sorted(labels)}


def event_table(events: list, title: str, rows: int = 25) -> str:
    """The ``rows`` names with the most summed time among ``events``:
    calls, total ms, mean us and share of the total."""
    calls, total = {}, {}
    for e in events:
        name = e.name()
        calls[name] = calls.get(name, 0) + 1
        total[name] = total.get(name, 0) + e.duration_ns()
    whole = sum(total.values()) or 1
    top = sorted(total, key=total.get, reverse=True)[:rows]
    lines = [f"{title}: {len(events)} events, {whole / 1e6:.3f} ms",
             f"{'total ms':>12} {'share':>7} {'calls':>8} {'mean us':>10}"
             "  name"]
    lines += [f"{total[n] / 1e6:12.3f} {total[n] / whole:7.2%} "
              f"{calls[n]:8d} {total[n] / calls[n] / 1e3:10.3f}  {n[:160]}"
              for n in top]
    return "\n".join(lines) + "\n"


# the CUDA kernels each backward launches, by name in a profiler trace
FLASH_BWD_KERNEL_NAMES = ("dq_kernel", "dkdv_kernel")
SSD_BWD_KERNEL_NAMES = ("ssd_bwd_states_kernel", "ssd_bwd_pass_kernel",
                        "ssd_bwd_tile_kernel", "ssd_bwd_group_sum_kernel")


@contextlib.contextmanager
def patched(owner, name: str, wrap):
    """``owner.name`` replaced by ``wrap(owner.name)`` inside the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


# launches of each kernel on the path that needs it (the placement phases,
# the model phases, the rmsnorm and swap_gain entry-point phases), and the
# largest shape each was launched at there (see repro_torch.kernels.SHAPES)
MAIN_PATH_LAUNCHES = {name: 0 for name in KERNELS}
MAIN_PATH_SHAPES = {name: None for name in KERNELS}
# launches by shape of the placement phases (repro_torch.kernels.SHAPE_COUNTS)
MAIN_PATH_SHAPE_COUNTS = {name: Counter() for name in KERNELS}


def emit_launch_shapes(key: str, counts: dict, top: int = 8) -> None:
    """One line of the kernels a phase launched, each with its launches,
    its number of distinct shapes and its ``top`` most frequent shapes;
    every shape with its count goes to ``chiprun_out/launch_shapes.json``."""
    launched = {name: c for name, c in counts.items() if c}
    if not launched:
        return
    emit({"phase": f"{key}/launch-shapes", "kernels": {
        name: {"launches": sum(c.values()), "distinct": len(c),
               "top": [[list(shape), n] for shape, n in c.most_common(top)]}
        for name, c in launched.items()}})
    path = OUT_DIR / "launch_shapes.json"
    if path.parent.is_dir():
        every = json.loads(path.read_text()) if path.is_file() else {}
        every[key] = {name: [[list(shape), n] for shape, n in c.most_common()]
                      for name, c in launched.items()}
        path.write_text(json.dumps(every))


def keep_shape(name: str, shape) -> None:
    old = MAIN_PATH_SHAPES[name]
    if shape is not None and (old is None
                              or math.prod(shape) > math.prod(old)):
        MAIN_PATH_SHAPES[name] = shape


def placement_phases() -> None:
    from repro_torch.core.engine import PlacementRequest
    from repro_torch.core.fattree import FatTreeTopology
    from repro_torch.core.topology import TorusTopology
    from repro_torch.workloads.patterns import alltoall_heavy, npb_dt_like

    npb1024 = npb_dt_like(1024, seed=3).comm
    t16 = TorusTopology((16, 16, 16))
    yield lambda: place_phase(
        "place/torus-16x16x16/npb_dt-1024/healthy",
        PlacementRequest(comm=npb1024, topology=t16),
        policies=("tofa", "greedy"), profile=True)
    ft16 = FatTreeTopology(16)
    yield lambda: place_phase(
        "place/fattree-k16/npb_dt-256/faulty32",
        PlacementRequest(comm=npb_dt_like(256, seed=3).comm, topology=ft16,
                         p_f=_faults(ft16.n_nodes, 32)), profile=True)
    yield lambda: place_phase(
        "place/torus-16x16x16/alltoall-1024/healthy",
        PlacementRequest(comm=alltoall_heavy(1024).comm, topology=t16),
        need=("swap_select",), profile=True)
    # the implicit cells place 512 ranks: on an H100 1024 ranks took
    # 85-112 s on the torus and 38-51 s on the fat tree (eager launches of
    # the sparse refine), 512 ranks 31 and 14 s
    npb512 = npb_dt_like(512, seed=3).comm
    yield lambda: place_phase(
        "place/torus-32x32x16/npb_dt-512/implicit",
        PlacementRequest(comm=npb512, topology=TorusTopology((32, 32, 16))),
        need=("torus_hop",), warm=False)
    ft32 = FatTreeTopology(32)
    yield lambda: place_phase(
        "place/fattree-k32/npb_dt-512/faulty64",
        PlacementRequest(comm=npb512, topology=ft32,
                         p_f=_faults(ft32.n_nodes, 64)),
        need=("fattree_hop",), warm=False)


# -------------------------------------------------- the paper's experiment
PAPER_FIELDS = ("batch_completions", "aborted_attempts", "n_events")


def _without_wall_clock(x):
    """A preset's result without its wall-clock ``place_time_s`` fields."""
    if isinstance(x, dict):
        return {k: _without_wall_clock(v) for k, v in x.items()
                if k != "place_time_s"}
    if isinstance(x, (list, tuple)):
        return [_without_wall_clock(v) for v in x]
    return x


def host_eq1_seconds(run) -> tuple:
    """``run()``'s result, and the seconds and calls it spent in the
    host's Eq. 1 weight derivation: ``TorusTopology.weight_matrix`` (a
    full derivation) and ``weight_matrix_update`` (the row-wise refresh
    after a health change), timed by wrapping both for the call."""
    from repro_torch.core.topology import TorusTopology

    spent = {"weight_matrix": 0.0, "weight_matrix_update": 0.0}
    calls = dict.fromkeys(spent, 0)
    orig = {name: getattr(TorusTopology, name) for name in spent}

    def timed(name):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig[name](*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
                calls[name] += 1
        return wrapper

    for name in spent:
        setattr(TorusTopology, name, timed(name))
    try:
        out = run()
    finally:
        for name, fn in orig.items():
            setattr(TorusTopology, name, fn)
    return out, {"s": spent, "calls": calls}


def paper_cell(cell: str, device, **kw) -> None:
    """``paper-fig4-5`` for linear and tofa on ``device``, held bit for bit
    to ``EXPECTED_PAPER[cell]``; prints mean completions, the TOFA
    improvement beside the paper's, the mapper's seconds per policy, and
    the launches of each kernel (the preset's sparse guests on a dense
    512-node torus reach none), and the seconds and share of the cell's
    wall time spent in the host's Eq. 1 weight derivation."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.sim.scenarios import run_preset

    reset_launches()
    t0 = time.perf_counter()
    out, eq1 = host_eq1_seconds(lambda: run_preset(
        "paper-fig4-5", policies=("linear", "tofa"), seed=0, device=device,
        **kw))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = out["policies"]
    got = {pol: {k: rows[pol][k] for k in PAPER_FIELDS} for pol in rows}
    imp = 1.0 - rows["tofa"]["mean_completion"] \
        / rows["linear"]["mean_completion"]
    ok = got == EXPECTED_PAPER[cell]
    emit({"phase": f"paper/{cell}", "params": out["params"],
          "mean_completion": {p: r["mean_completion"]
                              for p, r in rows.items()},
          "aborted_attempts": {p: r["aborted_attempts"]
                               for p, r in rows.items()},
          "tofa_improvement": imp, "paper_improvement": PAPER_IMPROVEMENT[cell],
          "place_time_s": {p: r["place_time_s"] for p, r in rows.items()},
          "host_eq1": eq1, "host_eq1_share": sum(eq1["s"].values()) / wall,
          "wall_s": wall, "launches": dict(LAUNCHES), "ok": ok})
    if not ok:
        raise AssertionError(f"paper/{cell} differs from EXPECTED_PAPER")


def elastic_phase(device) -> None:
    """A scheduler on ``device`` places lammps_like(64) under tofa; the
    node under rank 10 dies and ``engine.replace`` re-places the job.
    Held to ``EXPECTED_ELASTIC``; the victim must be gone."""
    import numpy as np
    import torch
    from repro_torch.cluster.scheduler import Job, Scheduler
    from repro_torch.core.topology import TorusTopology
    from repro_torch.workloads.patterns import lammps_like

    t0 = time.perf_counter()
    sch = Scheduler(TorusTopology((8, 8, 8)), device=device)
    sch.heartbeat_round(np.ones(512, dtype=bool))
    rec = sch.submit(Job(lammps_like(64), distribution="tofa"))
    victim = int(rec.placement.placement[10])
    before = rec.placement.hop_bytes
    placed = rec.placement.placement.copy()
    affected = sch.handle_node_failure([victim])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    plan = rec.placement
    exp = EXPECTED_ELASTIC
    ok = (victim == exp["victim"] and before == exp["hop_bytes_before"]
          and len(affected) == 1 and rec.restarts == 1
          and victim not in set(plan.placement.tolist())
          and plan.placement.tolist() == exp["placement"]
          and plan.hop_bytes == exp["hop_bytes"]
          and plan.provenance == exp["provenance"])
    emit({"phase": "paper/elastic-replace", "victim": victim,
          "hop_bytes_before": before, "hop_bytes": plan.hop_bytes,
          "provenance": plan.provenance, "restarts": rec.restarts,
          "moved": int((plan.placement != placed).sum()),
          "place_time_s": sch.place_time_s, "wall_s": wall, "ok": ok})
    if not ok:
        raise AssertionError("paper/elastic-replace differs from "
                             "EXPECTED_ELASTIC")


def presets_phase(device) -> None:
    """The nine other presets at ``fast=True`` on ``device``, each held
    bit for bit (wall-clock fields excepted) to the same preset run by
    the port on the CPU."""
    import torch
    from repro_torch.sim.scenarios import SCENARIOS, run_preset

    bad = []
    for name in SCENARIOS:
        if name == "paper-fig4-5":
            continue
        t0 = time.perf_counter()
        got = run_preset(name, fast=True, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = run_preset(name, fast=True, device="cpu")
        cpu_wall = time.perf_counter() - t0
        ok = _without_wall_clock(got) == _without_wall_clock(want)
        emit({"phase": f"paper/preset/{name}", "wall_s": wall,
              "cpu_wall_s": cpu_wall, "ok": ok})
        if not ok:
            bad.append(name)
    if bad:
        raise AssertionError(f"presets differ between the card and the "
                             f"CPU: {bad}")


def paper_phase(device) -> None:
    """The paper's Section 5.2 experiment on the port's engine on
    ``device``: NPB-DT-85 at the full protocol, LAMMPS-64 at 3 batches,
    one more NPB-DT batch under ``torch.profiler``, the elastic
    re-placement, and the nine other presets at ``fast=True``."""
    from repro_torch.sim.scenarios import run_preset
    from repro_torch.workloads.patterns import lammps_like

    t0 = time.perf_counter()
    paper_cell("npb_dt-85", device)
    paper_cell("lammps-64", device, n_batches=3,
               wl_factory=lambda: lammps_like(64))
    emit({"phase": "paper/npb_dt-85/profiled-batch", **profiled(
        lambda: run_preset("paper-fig4-5", n_batches=1, device=device),
        "paper_npb_dt-85_batch0")})
    elastic_phase(device)
    presets_phase(device)
    emit({"phase": "paper/done", "s": time.perf_counter() - t0})


# ---------------------------------------------------- the placement service
# The reference's request storm (benchmarks/serve_storm.py, run_storm) at its
# full size and at its fast size: a torus, Poisson arrivals, one third
# interactive replica sets (2 replicas x 3 KV shards of 2e8 B, 60 s
# deadline slack), one third standard and one third best-effort elastic
# jobs from mixed_size_factory((8, 12, 18)); flaky nodes (belief 0.3)
# going down every 5 s, repaired 15 s later; drain interval 0.25 s,
# heartbeats every 0.5 s, belief jitter 0.3.
STORM_FULL = {"dims": (6, 6, 6), "n_req": 600, "rate": 10.0, "n_flaky": 24,
              "per_event": 4, "seed": 0}
STORM_FAST = {"dims": (4, 4, 4), "n_req": 150, "rate": 5.0, "n_flaky": 8,
              "per_event": 1, "seed": 0}
# a storm row's wall-clock fields, and the process-wide epoch counter (it
# counts every state minted in the process, so it depends on what ran
# before): every other field is simulated and held exactly
STORM_NOT_HELD = ("place_wall_s", "placements_per_sec", "wall_time_s",
                  "epoch")
STORM_MIN_HIT_RATE = 0.90
# requests of the storm's profiled slice: the profiler keeps every op, and
# its tables over the first 100 requests took minutes to build on a CPU
STORM_PROFILED = 30
# the reference's storm gate on placements per second (serve_storm.py
# MIN_PLACEMENTS_PER_SEC), set for its NumPy engine on a CPU: reported
# beside the card's figure, not applied to it
REFERENCE_CPU_FLOOR = 50.0
# Each policy's simulated row of the full storm, as the reference's
# PlacementService on its NumPy engine returns it; recomputed by
#   PYTHONPATH=src python -m pytest -q \
#     tests/test_torch_service.py::test_expected_storm_is_the_reference
EXPECTED_STORM = {
    "tofa": {
        "submitted": 600, "placed": 600, "completed": 600, "shed": 0,
        "rejected": 0, "failed": 0, "preempted": 0, "requeued": 0,
        "replaced": 0, "replace_skipped": 53, "resized": 0,
        "drain_ticks": 173, "failure_events": 23, "heartbeats": 260,
        "admission_p50_s": 0.18074382310902593, "admission_p99_s": 0.25,
        "admission_mean_s": 0.1645118102146179,
        "completion_p50_s": 0.48176722026708063,
        "completion_p99_s": 0.9175738666666664, "peak_queue_depth": 0,
        "mean_queue_depth": 0.0, "makespan_s": 130.0, "n_events": 1679,
        "hit_rate": 0.9774436090225563},
    "linear": {
        "submitted": 600, "placed": 600, "completed": 600, "shed": 0,
        "rejected": 0, "failed": 0, "preempted": 0, "requeued": 0,
        "replaced": 16, "replace_skipped": 53, "resized": 0,
        "drain_ticks": 173, "failure_events": 23, "heartbeats": 260,
        "admission_p50_s": 0.18074382310902593, "admission_p99_s": 0.25,
        "admission_mean_s": 0.1645118102146179,
        "completion_p50_s": 0.7221853407130325,
        "completion_p99_s": 1.8256507328242548, "peak_queue_depth": 0,
        "mean_queue_depth": 0.0, "makespan_s": 130.0, "n_events": 1695,
        "hit_rate": 0.961038961038961},
}
# tests/test_replicas.py's PINNED summary of run_replicas("fat-tree",
# n_replicas=32, fast=True): summary(B=1000, seed=0) of each policy and
# compare(B=1000, seed=0), held at rel 1e-9
PINNED_REPLICAS = {
    "tofa_mean": 0.90792345,
    "tofa_ci_low": 0.8037965361979167,
    "tofa_ci_high": 1.02415233,
    "linear_mean": 1.0694688874999998,
    "win_rate": 0.78125,
    "delta": 0.16154543749999997,
}
# compare_policies (every registered policy, request seed 0) and
# assign_devices(policy="tofa", rng=np.random.default_rng(0)) on
# Fabric(pod_dims=(4, 4), n_pods=2) with chips 5 and 21 DEGRADED at p_f
# 0.05: hop-bytes per policy, and the assignment's linear and placed
# hop-bytes, as the reference's NumPy engine returns them; recomputed by
#   PYTHONPATH=src python -m pytest -q \
#     tests/test_torch_placement.py::test_expected_fabric_is_the_reference
FABRIC_DEGRADED = (5, 21)
EXPECTED_FABRIC = {
    "alltoall-16": {
        "compare": {"linear": 1600000000.0, "random": 5562500000.0,
                    "greedy": 1600000000.0, "topo": 1600000000.0,
                    "tofa": 5200000000.0, "tofa-ml": 5200000000.0},
        "hop_bytes_linear": 1600000000.0, "hop_bytes_placed": 5200000000.0},
    "npb_dt-16": {
        "compare": {"linear": 1305600000.0, "random": 4403200000.0,
                    "greedy": 896000000.0, "topo": 704000000.0,
                    "tofa": 1369600000.0, "tofa-ml": 1369600000.0},
        "hop_bytes_linear": 1305600000.0, "hop_bytes_placed": 1369600000.0},
}


def build_stream(n_req: int, rate: float, seed: int,
                 deadline_slack: float = 60.0) -> list:
    """The storm's requests, built with the port's service: a copy of the
    reference's ``benchmarks/serve_storm.py`` ``build_stream``."""
    import numpy as np
    from repro_torch.service import (SLOClass, elastic_request,
                                     replica_request)
    from repro_torch.workloads.arrivals import (mixed_size_factory,
                                                poisson_stream)

    rng = np.random.default_rng(seed)
    specs = poisson_stream(mixed_size_factory((8, 12, 18)), rate, n_req,
                           rng, max_duration=None)
    reqs = []
    for i, spec in enumerate(specs):
        t = spec.submit_time
        if i % 3 == 0:
            reqs.append(replica_request(
                shard_bytes=2e8, n_replicas=2, shards_per_replica=3,
                slo=SLOClass.INTERACTIVE, submit_time=t,
                deadline=t + deadline_slack))
        elif i % 3 == 1:
            reqs.append(elastic_request(spec.workload,
                                        slo=SLOClass.STANDARD,
                                        submit_time=t))
        else:
            reqs.append(elastic_request(spec.workload,
                                        slo=SLOClass.BEST_EFFORT,
                                        submit_time=t))
    return reqs


def build_churn(topo, n_flaky: int, seed: int, horizon: float,
                churn_every: float, repair_after: float,
                per_event: int = 1):
    """Flaky nodes (from the busiest half of the id range), their belief
    vector, and the failure / recovery schedule: a copy of the reference's
    ``benchmarks/serve_storm.py`` ``build_churn``."""
    import numpy as np

    rng = np.random.default_rng(seed * 211 + 7)
    flaky = np.sort(rng.choice(topo.n_nodes // 2, n_flaky, replace=False))
    belief = np.zeros(topo.n_nodes)
    belief[flaky] = 0.3
    failures, recoveries = [], []
    t = churn_every
    k = 0
    while t < horizon:
        victims = [int(flaky[(k + j) % len(flaky)])
                   for j in range(per_event)]
        failures.append((t, victims))
        recoveries.append((t + repair_after, victims))
        t += churn_every
        k += per_event
    return flaky, belief, failures, recoveries


def run_storm(cfg: dict, device, policies=("tofa", "linear"),
              n_first=None) -> dict:
    """The storm ``cfg`` through the port's ``PlacementService`` with its
    engine on ``device``, one fresh service per policy on identical
    streams and churn: ``{policy: ServiceResult}``.  ``n_first`` keeps
    only the stream's first requests (the churn stays the full run's)."""
    from repro_torch.core.topology import TorusTopology
    from repro_torch.service import PlacementService

    topo = TorusTopology(cfg["dims"])
    _, belief, failures, recoveries = build_churn(
        topo, n_flaky=cfg["n_flaky"], seed=cfg["seed"],
        horizon=cfg["n_req"] / cfg["rate"] + 60.0, churn_every=5.0,
        repair_after=15.0, per_event=cfg["per_event"])
    out = {}
    for policy in policies:
        svc = PlacementService(topo, policy=policy, seed=cfg["seed"],
                               drain_interval=0.25, restart_delay=1.0,
                               device=device)
        reqs = build_stream(cfg["n_req"], cfg["rate"], cfg["seed"])
        out[policy] = svc.run(reqs[:n_first], failures=failures,
                              recoveries=recoveries, heartbeat_interval=0.5,
                              belief=belief, belief_jitter=0.3)
    return out


def simulated(row: dict) -> dict:
    """A storm row without its wall-clock fields and epoch counter."""
    return {k: v for k, v in row.items() if k not in STORM_NOT_HELD}


def storm_phase(device) -> None:
    """The reference's full storm on the port's service with the engine on
    ``device``: every simulated field of each policy's row equal to
    ``EXPECTED_STORM``, tofa's cache hit rate at least 0.90 and its p99
    completion below linear's.  Reports each policy's placements per
    second beside the reference's CPU floor, and tofa on the first
    ``STORM_PROFILED`` requests once more under ``torch.profiler`` for the
    device's idle share."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches

    reset_launches()
    t0 = time.perf_counter()
    results = run_storm(STORM_FULL, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    rows = {p: r.row for p, r in results.items()}
    held = {p: simulated(r) == EXPECTED_STORM[p] for p, r in rows.items()}
    hit_ok = rows["tofa"]["hit_rate"] >= STORM_MIN_HIT_RATE
    p99_ok = (rows["tofa"]["completion_p99_s"]
              < rows["linear"]["completion_p99_s"])
    pps = {p: r["placements_per_sec"] for p, r in rows.items()}
    prof = profiled(lambda: run_storm(STORM_FULL, device, policies=("tofa",),
                                      n_first=STORM_PROFILED),
                    f"service_storm_first{STORM_PROFILED}")
    ok = all(held.values()) and hit_ok and p99_ok
    emit({"phase": "service/storm", "dims": STORM_FULL["dims"],
          "n_requests": STORM_FULL["n_req"], "held": held,
          "hit_rate": {p: r["hit_rate"] for p, r in rows.items()},
          "completion_p99_s": {p: r["completion_p99_s"]
                               for p, r in rows.items()},
          "placed": {p: r["placed"] for p, r in rows.items()},
          "replaced": {p: r["replaced"] for p, r in rows.items()},
          "place_wall_s": {p: r["place_wall_s"] for p, r in rows.items()},
          "placements_per_sec": pps,
          "reference_cpu_floor": REFERENCE_CPU_FLOOR,
          "tofa_at_reference_cpu_floor": pps["tofa"] >= REFERENCE_CPU_FLOOR,
          "run_wall_s": {p: r["wall_time_s"] for p, r in rows.items()},
          "wall_s": wall, "launches": launches,
          "profiled_tofa": {"n_first": STORM_PROFILED, **prof}, "ok": ok})
    if not ok:
        bad = {p: {k: (v, EXPECTED_STORM[p].get(k))
                   for k, v in simulated(r).items()
                   if v != EXPECTED_STORM[p].get(k)}
               for p, r in rows.items()}
        raise AssertionError(f"service/storm failed: held={held} "
                             f"hit={hit_ok} p99={p99_ok} diff={bad}")


def replicas_phase(device) -> None:
    """``run_replicas("fat-tree", n_replicas=32, fast=True)`` on
    ``device``: its summary statistics held to ``PINNED_REPLICAS`` at rel
    1e-9, replicas 0 and 31 to standalone ``run_preset`` calls; then four
    ``paper-fig4-5`` replicas, vectorized, held to the event path."""
    import os

    import numpy as np
    import torch
    from repro_torch.core.backend import resolve_device
    from repro_torch.sim.replicas import (_flat_policy_rows, choose_executor,
                                          run_replicas)
    from repro_torch.sim.scenarios import run_preset

    n = 32
    executor = choose_executor("auto", resolve_device(device),
                               os.cpu_count() or 1, n)
    t0 = time.perf_counter()
    rs = run_replicas("fat-tree", n_replicas=n, fast=True, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s_tofa = rs.summary("tofa", B=1000, seed=0)
    s_lin = rs.summary("linear", B=1000, seed=0)
    cmp = rs.compare(B=1000, seed=0)
    got = {"tofa_mean": s_tofa.mean, "tofa_ci_low": s_tofa.ci_low,
           "tofa_ci_high": s_tofa.ci_high, "linear_mean": s_lin.mean,
           "win_rate": cmp.win_rate, "delta": cmp.delta}
    pinned_ok = all(math.isclose(got[k], v, rel_tol=1e-9)
                    for k, v in PINNED_REPLICAS.items())
    standalone_ok = True
    for k in (0, n - 1):
        rows = _flat_policy_rows(run_preset("fat-tree", seed=k, fast=True,
                                            device=device))
        standalone_ok &= all(rs.metrics[pol][m][k] == v
                             for pol, row in rows.items()
                             for m, v in row.items() if m != "place_time_s")
    t1 = time.perf_counter()
    vec = run_replicas("paper-fig4-5", n_replicas=4, fast=True,
                       device=device)
    t2 = time.perf_counter()
    evt = run_replicas("paper-fig4-5", n_replicas=4, fast=True,
                       device=device, vectorize="never")
    t3 = time.perf_counter()
    vector_ok = all(np.array_equal(vec.metrics[pol][m], evt.metrics[pol][m])
                    for pol in vec.metrics for m in vec.metrics[pol]
                    if m != "place_time_s")
    ok = pinned_ok and standalone_ok and vector_ok
    emit({"phase": "service/replicas", "preset": "fat-tree", "n_replicas": n,
          "executor": executor, "wall_s": wall, "summary": got,
          "pinned_ok": pinned_ok, "standalone_ok": standalone_ok,
          "paper_vectorized_s": t2 - t1, "paper_event_s": t3 - t2,
          "vector_ok": vector_ok, "ok": ok})
    if not ok:
        raise AssertionError("service/replicas failed its check")


def fabric_phase(device) -> None:
    """``compare_policies`` and ``assign_devices(policy="tofa")`` on a
    two-pod fabric with two DEGRADED chips, for a dense guest (all-to-all:
    the ``swap_select`` branch) and a sparse one (NPB-DT): hop-bytes equal
    to ``EXPECTED_FABRIC``; ``swap_select`` must have launched on the
    dense cell, and its launches count towards the main path."""
    import numpy as np
    import torch
    from repro_torch.core.placement import (Fabric, assign_devices,
                                            compare_policies)
    from repro_torch.core.state import ClusterState, NodeHealth
    from repro_torch.kernels import reset_launches
    from repro_torch.workloads.patterns import alltoall_heavy, npb_dt_like

    fabric = Fabric(pod_dims=(4, 4), n_pods=2)
    p_f = np.zeros(fabric.n_chips)
    p_f[list(FABRIC_DEGRADED)] = 0.05
    state = ClusterState.healthy(fabric.n_chips).with_health(
        list(FABRIC_DEGRADED), NodeHealth.DEGRADED).with_outage(p_f)
    bad = []
    for cell, wl, need in (("alltoall-16", alltoall_heavy(16), True),
                           ("npb_dt-16", npb_dt_like(16, seed=3), False)):
        exp = EXPECTED_FABRIC[cell]
        reset_launches()
        t0 = time.perf_counter()
        report = compare_policies(wl.comm, fabric, state=state,
                                  device=device)
        assignment = assign_devices(wl.comm, fabric, policy="tofa",
                                    state=state,
                                    rng=np.random.default_rng(0),
                                    device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _count_path(("swap_select",))
        got = {pol: r["hop_bytes"] for pol, r in report.items()}
        perm = assignment.permutation
        ok = (got == exp["compare"]
              and assignment.hop_bytes_linear == exp["hop_bytes_linear"]
              and assignment.hop_bytes_placed == exp["hop_bytes_placed"]
              and len(set(perm.tolist())) == len(perm)
              and 0 <= perm.min() and perm.max() < fabric.n_chips
              and (launches["swap_select"] > 0 or not need))
        emit({"phase": f"service/fabric/{cell}", "compare": got,
              "hop_bytes_linear": assignment.hop_bytes_linear,
              "hop_bytes_placed": assignment.hop_bytes_placed,
              "improvement": assignment.improvement,
              "faulty_nodes_used": assignment.plan.faulty_nodes_used,
              "launches": launches, "needs_swap_select": need,
              "wall_s": wall, "ok": ok})
        if not ok:
            bad.append(cell)
    if bad:
        raise AssertionError(f"service/fabric failed: {bad}")


SERVICE_CELLS = (("storm", storm_phase), ("replicas", replicas_phase),
                 ("fabric", fabric_phase))


# ------------------------------------------------------ model-stack kernels
# the reference's kernel-test tolerances (tests/test_kernels.py TOL)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# q (B, H, Sq, Dh), k/v (B, Hkv, Sk, Dh) of smollm-135m's 2048-token
# forward, which the model phase hands the flash kernel
FLASH_MAIN = (2, 9, 3, 2048, 2048, 64)
# the shared block of zamba2-7b (32 heads of 112) and the MLA prefill of
# minicpm3-4b (40 heads, q/k of 64 + 32, V padded from 64 to 96) at B 2 x
# 2048, which their full-depth forwards hand the flash kernel
FLASH_ZAMBA2 = (2, 32, 32, 2048, 2048, 112)
FLASH_MINICPM3 = (2, 40, 40, 2048, 2048, 96)
# phi3.5-moe-42b's GQA (32 heads of 128 over 8 KV heads) and the MLA
# prefill of deepseek-v2-lite-16b (16 heads, q/k of 128 + 64, V padded
# from 128 to 192) at B 2 x 2048
FLASH_PHI35 = (2, 32, 8, 2048, 2048, 128)
FLASH_DSV2 = (2, 16, 16, 2048, 2048, 192)
# seamless-m4t-large-v2's decoder self-attention (16 heads of 64) at B 2 x
# 2048; llama-3.2-vision-11b's self layers run phi3.5's shape above
FLASH_SEAMLESS = (2, 16, 16, 2048, 2048, 64)
# starcoder2-7b's GQA (36 heads of 128 over 4 KV heads: 9 a KV head) and
# nemotron-4-340b's (96 heads of 192 over 8: 12 a KV head) at B 2 x 2048
FLASH_STARCODER2 = (2, 36, 4, 2048, 2048, 128)
FLASH_NEMOTRON = (2, 96, 8, 2048, 2048, 192)
# phi3.5-moe-42b's depth on one card.  The whole model (32 layers of
# 1.300 B parameters, 167.5 GB in float32) needs several cards; 12 layers
# (63.5 GB) fit one.  But at its full width float32 rounding compounds
# with depth past the forward's 1e-4 hold: two plain forwards that differ
# only in the attention's summation order reach 0.61 / 0.70 / 0.96 of the
# allowance at 6 / 8 / 12 layers, the kernel's forward against the plain
# one 0.83 / 1.04 / 1.32 (tools/forward_drift.py).  6 layers (7.80 B
# parameters, 31.2 GB) is the deepest cut where that noise floor stays
# under two thirds of the allowance.
PHI35_DEPTH = 6
RMSNORM_MAIN = (2 * 2048, 576)           # (rows, D): smollm's activations
SWAP_GAIN_N = 1024
# the largest dense guest: every node of the 16^3 torus at lazy_threshold
SWAP_GAIN_LARGE = 4096


def _record(max_abs_err, ms, host, plain, plain_ahead, library, nbytes,
            ops, dt) -> dict:
    bnd, by = bound_ms(nbytes, ops, dt)
    return dict(max_abs_err=max_abs_err, ms=ms, host_ms=host, plain_ms=plain,
                plain_queued_ahead=plain_ahead, library_ms=library,
                bound_ms=bnd, bound_by=by)


def check_flash(dev, dt: str, shape: tuple, tag: str,
                f64: bool = False) -> dict:
    """flash_attention (causal) against its plain version at ``shape``,
    timed beside F.scaled_dot_product_attention on the same inputs.

    float32 records carry two bounds: ``bound_ms`` (= ``bound_tc_ms``), the
    3xTF32 work at the TF32 tensor-core rate, which the kernel runs, and
    ``bound_cuda_core_ms``, the same operations at the CUDA cores' float32
    rate, so a time below the latter reads as expected.  With ``f64`` the
    kernel and the float32 plain version are both held to the plain
    version run in float64: the kernel's largest error may be at most
    twice the float32 plain version's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, H, Hkv, Sq, Sk, Dh = shape
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(_tdtype(dt))
               for s in ((B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh)))
    got = flash_attention(q, k, v, causal=True, impl="kernel")
    want = flash_attention_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), atol=TOL[dt],
                             rtol=TOL[dt]))
    errs64 = {}
    if f64:
        exact = flash_attention_ref(q.double(), k.double(), v.double(),
                                    causal=True)
        errs64 = {"kernel": float((got.double() - exact).abs().max()),
                  "plain": float((want.double() - exact).abs().max())}
        del exact
    del got, want
    ms, host, _ = cuda_ms(lambda: flash_attention(q, k, v, causal=True,
                                                  impl="kernel"))
    plain, _, plain_ahead = cuda_ms(
        lambda: flash_attention_ref(q, k, v, causal=True), strict=False)
    library, _, _ = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    size = q.element_size()
    # the (query, key) pairs the causal mask leaves visible, each a Dh-long
    # dot product for the score and a Dh-long update of the output
    pairs = sum(max(0, min(Sk, i + 1 + Sk - Sq)) for i in range(Sq))
    nbytes = (2 * B * H * Sq * Dh + 2 * B * Hkv * Sk * Dh) * size
    ops = 4.0 * Dh * pairs * B * H
    rec = _record(err, ms, host, plain, plain_ahead, library, nbytes, ops,
                  dt)
    if dt == "float32":
        rec["bound_cuda_core_ms"] = rec["bound_ms"]
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 3 * ops, "tf32")
        rec["bound_tc_ms"] = rec["bound_ms"]
    rec["ms_over_library"] = ms / library
    if errs64:
        rec["max_abs_err_f64"] = errs64
    emit({"phase": tag, "kernel": "flash_attention", "dtype": dt,
          "shape": list(shape), "causal": True, "tol": TOL[dt], "ok": ok,
          **rec})
    if not ok:
        raise AssertionError(f"flash_attention disagrees at {shape} {dt}")
    if errs64 and errs64["kernel"] > 2 * errs64["plain"]:
        raise AssertionError(
            f"flash_attention at {shape} {dt}: error {errs64['kernel']:.3g} "
            f"from the float64 plain version, more than twice the float32 "
            f"plain version's {errs64['plain']:.3g}")
    return rec


def check_rmsnorm(dev, dt: str, rows: int, D: int, tag: str) -> dict:
    """rmsnorm against the model's plain rmsnorm, timed beside
    F.rms_norm."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((rows, D), generator=g, device=dev).to(_tdtype(dt))
    w = (torch.randn(D, generator=g, device=dev) + 1.0).to(_tdtype(dt))
    got, want = rmsnorm(x, w, impl="kernel"), rmsnorm_ref(x, w)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), atol=TOL[dt],
                             rtol=TOL[dt]))
    ms, host, _ = cuda_ms(lambda: rmsnorm(x, w, impl="kernel"))
    plain, _, plain_ahead = cuda_ms(lambda: rmsnorm_ref(x, w), strict=False)
    library, _, _ = cuda_ms(lambda: F.rms_norm(x, (D,), w, eps=1e-6))
    size = x.element_size()
    rec = _record(err, ms, host, plain, plain_ahead, library,
                  (2 * rows * D + D) * size, 4.0 * rows * D, dt)
    emit({"phase": tag, "kernel": "rmsnorm", "dtype": dt,
          "shape": [rows, D], "tol": TOL[dt], "ok": ok, **rec})
    if not ok:
        raise AssertionError(f"rmsnorm disagrees at {(rows, D)} {dt}")
    return rec


def check_swap_gain(dev, dt: str, n: int, tag: str,
                    cold: bool = False) -> dict:
    """swap_gain against its plain version at (n, n), integer-valued
    inputs, several movers: exact equality.  Timed L2-hot (``cuda_ms``),
    or with ``cold`` L2-cold (``cold_ms``), the plain version the same way;
    the record carries the empty launch's time and the byte bound beside
    it.  No single PyTorch call computes the gains row (library_ms null)."""
    import numpy as np
    import torch
    from repro_torch.kernels.swap_gain.ops import swap_gain
    from repro_torch.kernels.swap_gain.ref import swap_gain_ref

    rng = np.random.default_rng(0)
    tdt = _tdtype(dt)
    A = rng.integers(0, 7, (n, n))
    M = torch.tensor(A + A.T, dtype=tdt, device=dev)
    S = rng.integers(0, 5, (n, n)) * (rng.random((n, n)) < 0.3)
    G = torch.tensor(S + S.T, dtype=tdt, device=dev)
    contrib = (G * M).sum(-1)
    exact, err = True, 0.0
    for i in (0, n // 3, n - 1):
        iv = torch.tensor([i], device=dev)
        got = swap_gain(M, G, contrib, iv, impl="kernel")
        want = swap_gain_ref(M[None], G, contrib[None], iv)[0]
        torch.cuda.synchronize()
        exact &= bool(torch.equal(got, want))
        err = max(err, float((got - want).abs().max()))
    iv = torch.tensor([n // 3], device=dev)
    run = lambda: swap_gain(M, G, contrib, iv, impl="kernel")
    ref = lambda: swap_gain_ref(M[None], G, contrib[None], iv)
    if cold:
        ms, _ = cold_ms(run)
        plain, plain_ahead = cold_ms(ref)
        _, host, _ = cuda_ms(run)
    else:
        ms, host, _ = cuda_ms(run)
        plain, _, plain_ahead = cuda_ms(ref, strict=False)
    size = M.element_size()
    rec = _record(err, ms, host, plain, plain_ahead, None,
                  (2 * n * n + 2 * n) * size + 8, 4.0 * n * n, dt)
    rec.update(launch_floor_ms=LAUNCH_FLOOR_MS[0],
               l2="cold" if cold else "hot")
    if cold:        # one empty kernel between events, as the call is timed
        rec["launch_floor_cold_ms"] = cold_ms(
            lambda: torch.cuda._sleep(0))[0]
    emit({"phase": tag, "kernel": "swap_gain", "dtype": dt, "shape": [n, n],
          "exact": exact, **rec})
    if not exact:
        raise AssertionError(f"swap_gain disagrees at n={n} {dt}")
    return rec


# the reference's SSD kernel-test tolerances (tests/test_kernels.py)
SSD_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
# (B, H, G, S, P, N, chunk): the reference's three kernel-test shapes, the
# reduced mamba2's, and mamba2-2.7b's B 2 x 2048 prefill (the main path's,
# chunk 64) also at the entry point's default chunk of 128
SSD_SHAPES = [(1, 2, 1, 64, 16, 16, 16), (2, 4, 2, 128, 32, 32, 32),
              (1, 8, 1, 96, 64, 128, 32), (2, 8, 1, 64, 16, 16, 8)]
SSD_MAIN = (2, 80, 1, 2048, 64, 128, 64)
SSD_MAIN_128 = SSD_MAIN[:6] + (128,)
# zamba2-7b's mamba2 layers at B 2 x 2048: 112 heads of 64, d_state 64
# (the kernel's generic instance, padded to P = N = 128)
SSD_ZAMBA2 = (2, 112, 1, 2048, 64, 64, 64)


def ssd_ops(B, H, G, S, P, N) -> float:
    """The least operations of the SSD scan at this shape.  The chunked
    form at a tile of Q rows does, per (b, group, tile), the lower
    triangle of C B^T (the heads of a group share it, N each) and, per
    (b, h, tile), its product with xdt (P each), the carry-in product and
    the state update (Q P N each) and the state's decay (P N); two
    operations per multiply-add.  The result does not depend on the tile,
    so the least count over the tiles 1 (the one-token recurrence) to 64
    (the kernel's) that divide S is taken."""
    def at(Q):
        n, tri = S // Q, Q * (Q + 1) // 2
        return 2.0 * B * G * n * tri * N \
            + B * H * n * (2.0 * tri * P + 4 * Q * P * N + P * N)
    return min(at(Q) for Q in (1, 2, 4, 8, 16, 32, 64) if S % Q == 0)


def check_ssd(dev, dt: str, shape: tuple, tag: str, timed: bool) -> dict:
    """ssd_scan against the exact recurrence (ssd_scan_ref) in both types
    and against the chunked algorithm (``impl="ref"``) in float32, on the
    reference's kernel-test distribution; with ``timed``, the kernel, both
    plain versions and the bound.  No PyTorch call computes the SSD scan
    (library_ms null)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan.ops import (ssd_scan_kernel,
                                                  workspace_bytes)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_ref

    B, H, G, S, P, N, chunk = shape
    g = torch.Generator(device=dev).manual_seed(1)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)
    tdt = _tdtype(dt)
    xdt = (rand(B, H, S, P) * 0.5).to(tdt)
    dA = (-F.softplus(rand(B, H, S)) * 0.5).to(tdt)
    Bm, Cm = ((rand(B, G, S, N) * 0.5).to(tdt) for _ in range(2))
    run = lambda: ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk,
                                  impl="kernel")
    chunked = lambda: ssd_scan_kernel(xdt, dA, Bm, Cm, chunk=chunk,
                                      impl="ref")
    exact = lambda: ssd_scan_ref(xdt, dA, Bm, Cm, chunk)
    y, st = run()
    wants = {"exact": exact()}
    if dt == "float32":
        wants["chunked"] = chunked()
    torch.cuda.synchronize()
    tol, errs, ok = SSD_TOL[dt], {}, True
    for name, (y_r, st_r) in wants.items():
        errs[name] = max(float((y.float() - y_r.float()).abs().max()),
                         float((st - st_r).abs().max()))
        ok &= bool(torch.allclose(y.float(), y_r.float(), atol=tol, rtol=tol)
                   and torch.allclose(st, st_r, atol=tol, rtol=tol))
    del y, st, wants
    rec = {"max_abs_err": max(errs.values()),
           "workspace_bytes": workspace_bytes(B, H, S, P, N, chunk)}
    if timed:
        ms, host, _ = cuda_ms(run)
        plain, _, plain_ahead = cuda_ms(chunked, strict=False)
        exact_ms, _, _ = cuda_ms(exact, reps=1, trials=3, warmup=1,
                                 strict=False)
        size = xdt.element_size()
        nbytes = (2 * B * H * S * P + 2 * B * G * S * N) * size \
            + B * H * S * dA.element_size() + B * H * P * N * 4
        rec.update(_record(rec["max_abs_err"], ms, host, plain, plain_ahead,
                           None, nbytes, ssd_ops(B, H, G, S, P, N), dt))
        rec["exact_ms"] = exact_ms
    emit({"phase": tag, "kernel": "ssd_scan", "dtype": dt,
          "shape": list(shape), "tol": tol, "max_abs_err_vs": errs,
          "ok": ok, **rec})
    if not ok:
        raise AssertionError(f"ssd_scan disagrees at {shape} {dt}")
    return rec


# the backward kernels' phases: flash_attention_bwd at smollm-135m's B 2 x
# 4096 (the summary line's record) and the five model shapes at B 2 x 2048
# (smollm, minicpm3, zamba2, phi3.5, deepseek: every model head dim) in
# float32 and bfloat16; ssd_scan_bwd at mamba2's and zamba2's B 2 x 2048
# in both types
FLASH_S4096 = (2, 9, 3, 4096, 4096, 64)    # train/smollm-135m/S4096's
FLASH_BWD_SHAPES = {"float32": (FLASH_S4096, FLASH_MAIN, FLASH_MINICPM3,
                                FLASH_ZAMBA2, FLASH_PHI35, FLASH_DSV2),
                    "bfloat16": (FLASH_MAIN, FLASH_MINICPM3, FLASH_ZAMBA2,
                                 FLASH_PHI35, FLASH_DSV2)}
# the CUDA-core design's device ms at those shapes (chip_smoke.py's
# kernel/flash_attention_bwd records, NVIDIA H100 80GB HBM3, 700 W), the
# `was_ms` of each record; none where it was not timed
FLASH_BWD_WAS_MS = {("float32", FLASH_S4096): 9.713,
                    ("float32", FLASH_MAIN): 3.491,
                    ("float32", FLASH_MINICPM3): 17.05,
                    ("float32", FLASH_ZAMBA2): 16.65,
                    ("float32", FLASH_PHI35): 18.49,
                    ("float32", FLASH_DSV2): 18.34,
                    ("bfloat16", FLASH_MAIN): 3.434,
                    ("bfloat16", FLASH_PHI35): 18.30}
SSD_BWD_SHAPES = (SSD_MAIN, SSD_ZAMBA2)
# the CUDA-core design's device ms at those shapes (chip_smoke.py's
# kernel/ssd_scan_bwd records of that design, NVIDIA H100 80GB HBM3,
# 700 W), the `was_ms` of each record
SSD_BWD_WAS_MS = {("float32", SSD_MAIN): 3.546,
                  ("float32", SSD_ZAMBA2): 2.869,
                  ("bfloat16", SSD_MAIN): 3.853,
                  ("bfloat16", SSD_ZAMBA2): 3.103}


def grad_errors(got, plain, exact, names) -> dict:
    """Each gradient's largest error against ``exact`` (float64), as a
    share of that gradient's largest magnitude, for the kernel (``got``)
    and the same-dtype plain version (``plain``)."""
    out = {}
    for name, g, p, e in zip(names, got, plain, exact):
        scale = float(e.abs().max()) or 1.0
        out[name] = {"kernel": float((g.double() - e).abs().max()) / scale,
                     "plain": float((p.double() - e).abs().max()) / scale}
    return out


def within_twice_plain(errs: dict) -> bool:
    """The backward's accuracy rule: every gradient's error at most twice
    the same-dtype plain version's (the f32 forward's rule in check_flash)."""
    return all(e["kernel"] <= 2 * e["plain"] for e in errs.values())


def backward_ms(run) -> float:
    """Device ms of ``run()``, a backward over a retained graph."""
    return cuda_ms(run, reps=5, trials=3, warmup=1, strict=False)[0]


def kernel_split_ms(run, names, reps: int = 5) -> dict:
    """Device ms of each kernel in ``names`` (launched once a call) in
    ``reps`` more calls of ``run()`` under torch.profiler: the mean of
    each name's events, summed over the raw events as ``profiled`` does.
    Taken after the flash backward's records, a profile lost its first
    three device events on an H100, so a name is averaged over the events
    that arrived; one with none reads 0."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    total, count = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0)
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            for n in names:
                if n in e.name():
                    total[n] += e.duration_ns() / 1e6
                    count[n] += 1
    return {n: total[n] / count[n] if count[n] else 0.0 for n in names}


def check_flash_bwd(dev, dt: str, shape: tuple, tag: str) -> dict:
    """flash_attention's backward kernels (causal) at ``shape``: dq, dk and
    dv against the plain version's autograd gradients run in float64, each
    at most twice as far from them as the same-dtype plain version's; two
    backwards bit-identical; the backward alone timed (the kernels on the
    forward's saved tensors) beside the plain version's backward and
    F.scaled_dot_product_attention's (one forward with its graph
    retained, the backward timed), and beside the previous design's time
    at that shape (``was_ms``, ``FLASH_BWD_WAS_MS``).  The work is 2.5x
    the causal forward's products; float32 records carry two bounds, as
    the forward's do: ``bound_ms`` (= ``bound_tc_ms``) at 3xTF32 on the
    tensor cores, which the kernel runs, and ``bound_cuda_core_ms`` at the
    CUDA cores' float32 rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    B, H, Hkv, Sq, Sk, Dh = shape
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(s, generator=g, device=dev).to(_tdtype(dt))
               for s in ((B, H, Sq, Dh), (B, Hkv, Sk, Dh), (B, Hkv, Sk, Dh)))
    dout = torch.randn((B, H, Sq, Dh), generator=g, device=dev).to(q.dtype)

    def grads(fn, *ins):
        leaves = [t.detach().requires_grad_(True) for t in ins]
        out = fn(*leaves)
        return out, leaves, torch.autograd.grad(out, leaves,
                                                dout.to(out.dtype),
                                                retain_graph=True)

    kernel = lambda *t: ops.flash_attention(*t, causal=True, impl="kernel")
    plain = lambda *t: flash_attention_ref(*t, causal=True)
    _, _, got = grads(kernel, q, k, v)
    _, _, again = grads(kernel, q, k, v)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del again
    _, _, want = grads(plain, q, k, v)
    _, _, exact = grads(plain, q.double(), k.double(), v.double())
    torch.cuda.synchronize()
    errs = grad_errors(got, want, exact, ("dq", "dk", "dv"))
    del got, want, exact
    torch.cuda.empty_cache()

    with torch.no_grad():
        _, lse = ops._forward(q, k, v, True, with_lse=True)
    ms, host, _ = cuda_ms(lambda: ops._backward(q, k, v, lse, dout, True),
                          reps=5, trials=3)
    del lse
    o_p, leaves, _ = grads(plain, q, k, v)
    plain_ms = backward_ms(lambda: torch.autograd.grad(
        o_p, leaves, dout, retain_graph=True))
    del o_p, leaves
    torch.cuda.empty_cache()
    o_l, leaves, _ = grads(lambda *t: F.scaled_dot_product_attention(
        *t, is_causal=True, enable_gqa=True), q, k, v)
    library = backward_ms(lambda: torch.autograd.grad(
        o_l, leaves, dout, retain_graph=True))
    del o_l, leaves
    torch.cuda.empty_cache()
    pairs = sum(max(0, min(Sk, i + 1 + Sk - Sq)) for i in range(Sq))
    size = q.element_size()
    # q, dO, dq and k, v, dk, dv once each, and the log-sum-exp
    nbytes = (3 * B * H * Sq * Dh + 4 * B * Hkv * Sk * Dh) * size \
        + B * H * Sq * 4
    ops_n = 2.5 * 4.0 * Dh * pairs * B * H
    rec = _record(max(e["kernel"] for e in errs.values()), ms, host,
                  plain_ms, False, library, nbytes, ops_n, dt)
    rec["bound_cuda_core_ms"] = bound_ms(nbytes, ops_n, "float32")[0]
    if dt == "float32":
        # as the forward's (check_flash): float32-accurate products as
        # 3xTF32 on the tensor cores are the least time the card could take
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, 3 * ops_n,
                                                    "tf32")
        rec["bound_tc_ms"] = rec["bound_ms"]
    rec["ms_over_library"] = ms / library
    rec["was_ms"] = FLASH_BWD_WAS_MS.get((dt, shape))
    rec["shape"] = list(shape)
    ok = within_twice_plain(errs) and same
    emit({"phase": tag, "kernel": "flash_attention_bwd", "dtype": dt,
          "causal": True, "rel_err_f64": errs, "bit_identical": same,
          "ok": ok, **rec})
    if not ok:
        raise AssertionError(f"flash_attention_bwd at {shape} {dt}: "
                             f"errors {errs}, bit-identical {same}")
    return rec


def ssd_bwd_ops(B, H, G, S, P, N) -> float:
    """The least operations of the SSD scan's gradient at this shape, as
    ``ssd_ops`` counts the forward's: per (b, group, tile) the lower
    triangle of C B^T (N each), per (b, h, tile) dy x^T, dx's and dB's
    and dC's in-tile products (the triangle, P or N each), the four state
    products g B^T, x g, dy h and the state gradient's update (Q P N each)
    with its decay (P N), and the forward's chunk states again (Q P N);
    two operations per multiply-add, the least over the tiles 1 to 64
    that divide S."""
    def at(Q):
        n, tri = S // Q, Q * (Q + 1) // 2
        return 2.0 * B * G * n * tri * N \
            + B * H * n * (2.0 * tri * (2 * P + 2 * N) + 10 * Q * P * N
                           + 2 * P * N)
    return min(at(Q) for Q in (1, 2, 4, 8, 16, 32, 64) if S % Q == 0)


def check_ssd_bwd(dev, dt: str, shape: tuple, tag: str) -> dict:
    """ssd_scan's backward kernels at ``shape``: the gradients of xdt, dA,
    B and C, with a nonzero gradient of the final state, against the
    chunked plain version's autograd run in float64, each at most twice
    as far from it as the same-dtype plain version's; two backwards
    bit-identical; the backward alone timed beside the plain version's
    and the previous design's (``was_ms``, ``SSD_BWD_WAS_MS``), and each of
    its launches' device ms in five more calls under the profiler
    (``split_ms``, by kernel name, ``kernel_split_ms``).  No PyTorch call computes it
    (library_ms null).  float32 records carry two bounds, as the flash
    backward's do: ``bound_ms`` (= ``bound_tc_ms``) at 3xTF32 on the tensor
    cores, which the kernels run, and ``bound_cuda_core_ms`` at the CUDA
    cores' float32 rate."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_chunked_folded

    B, H, G, S, P, N, chunk = shape
    g = torch.Generator(device=dev).manual_seed(4)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)
    tdt = _tdtype(dt)
    xdt = (rand(B, H, S, P) * 0.5).to(tdt)
    dA = (-F.softplus(rand(B, H, S)) * 0.5).to(tdt)
    Bm, Cm = ((rand(B, G, S, N) * 0.5).to(tdt) for _ in range(2))
    dy = rand(B, H, S, P).to(tdt)
    dst = rand(B, H, P, N)
    ins = (xdt, dA, Bm, Cm)

    def grads(fn, *args):
        leaves = [t.detach().requires_grad_(True) for t in args]
        y, st = fn(*leaves)
        return (y, st), leaves, torch.autograd.grad(
            (y, st), leaves, (dy.to(y.dtype), dst.to(st.dtype)),
            retain_graph=True)

    kernel = lambda *t: ops.ssd_scan_kernel(*t, chunk=chunk, impl="kernel")
    plain = lambda *t: ssd_chunked_folded(*t, chunk)
    _, _, got = grads(kernel, *ins)
    _, _, again = grads(kernel, *ins)
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del again
    _, _, want = grads(plain, *ins)
    _, _, exact = grads(plain, *(t.double() for t in ins))
    torch.cuda.synchronize()
    errs = grad_errors(got, want, exact, ("dxdt", "ddA", "dB", "dC"))
    del got, want, exact
    torch.cuda.empty_cache()

    ms, host, _ = cuda_ms(lambda: ops._backward(*ins, dy, dst, chunk),
                          reps=5, trials=3)
    split = kernel_split_ms(lambda: ops._backward(*ins, dy, dst, chunk),
                            SSD_BWD_KERNEL_NAMES)
    outs, leaves, _ = grads(plain, *ins)
    plain_ms = backward_ms(lambda: torch.autograd.grad(
        outs, leaves, (dy, dst), retain_graph=True))
    del outs, leaves
    torch.cuda.empty_cache()
    size = xdt.element_size()
    # xdt, dy and dxdt; B, C, dB and dC; dA and ddA; the final state's
    # gradient (float32), each once
    nbytes = (3 * B * H * S * P + 4 * B * G * S * N) * size \
        + 2 * B * H * S * dA.element_size() + B * H * P * N * 4
    rec = _record(max(e["kernel"] for e in errs.values()), ms, host,
                  plain_ms, False, None, nbytes,
                  ssd_bwd_ops(B, H, G, S, P, N), dt)
    rec["bound_cuda_core_ms"] = bound_ms(
        nbytes, ssd_bwd_ops(B, H, G, S, P, N), "float32")[0]
    if dt == "float32":
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            nbytes, 3 * ssd_bwd_ops(B, H, G, S, P, N), "tf32")
        rec["bound_tc_ms"] = rec["bound_ms"]
    rec["was_ms"] = SSD_BWD_WAS_MS.get((dt, shape))
    rec["split_ms"] = split
    rec["shape"] = list(shape)
    ok = within_twice_plain(errs) and same
    emit({"phase": tag, "kernel": "ssd_scan_bwd", "dtype": dt,
          "rel_err_f64": errs, "bit_identical": same, "ok": ok, **rec})
    if not ok:
        raise AssertionError(f"ssd_scan_bwd at {shape} {dt}: errors "
                             f"{errs}, bit-identical {same}")
    return rec


def backward_kernel_phase(dev) -> dict:
    """kernel/flash_attention_bwd and kernel/ssd_scan_bwd.  Returns the
    float32 records by kernel and shape, for the summary line."""
    import torch
    recs = {"flash_attention_bwd": {}, "ssd_scan_bwd": {}}
    for dt, shapes in FLASH_BWD_SHAPES.items():
        for shape in shapes:
            rec = check_flash_bwd(dev, dt, shape,
                                  "kernel/flash_attention_bwd")
            if dt == "float32":
                recs["flash_attention_bwd"][shape] = rec
            torch.cuda.empty_cache()
    for dt in ("float32", "bfloat16"):
        for shape in SSD_BWD_SHAPES:
            rec = check_ssd_bwd(dev, dt, shape, "kernel/ssd_scan_bwd")
            if dt == "float32":
                recs["ssd_scan_bwd"][shape] = rec
            torch.cuda.empty_cache()
    return recs


def model_kernel_phase(dev) -> dict:
    """The model-stack kernels against their plain versions.  Returns the
    float32 records (the model phases run float32) by kernel and shape;
    the one at the largest shape the main path gave a kernel goes into
    the summary line."""
    import torch
    recs = {name: {} for name in ("flash_attention", "rmsnorm",
                                  "swap_gain", "ssd_scan")}
    for shape in (FLASH_MAIN, FLASH_ZAMBA2, FLASH_MINICPM3, FLASH_PHI35,
                  FLASH_DSV2, FLASH_SEAMLESS, FLASH_STARCODER2,
                  FLASH_NEMOTRON):
        for dt in ("float32", "bfloat16"):
            rec = check_flash(dev, dt, shape, "kernels/model",
                              f64=dt == "float32")
            if dt == "float32":
                recs["flash_attention"][shape] = rec
            torch.cuda.empty_cache()
    check_flash(dev, "bfloat16", (1, 16, 16, 1024, 1024, 192),
                "kernels/model")
    for dt in ("float32", "bfloat16"):
        rec = check_rmsnorm(dev, dt, *RMSNORM_MAIN, "kernels/model")
        if dt == "float32":
            recs["rmsnorm"][RMSNORM_MAIN] = rec
    for dt in ("float64", "float32"):
        rec = check_swap_gain(dev, dt, SWAP_GAIN_N, "kernels/model")
        if dt == "float64":          # the refiner's default dtype
            recs["swap_gain"][(SWAP_GAIN_N,)] = rec
        check_swap_gain(dev, dt, SWAP_GAIN_N, "kernels/model", cold=True)
        check_swap_gain(dev, dt, SWAP_GAIN_LARGE, "kernels/model")
        torch.cuda.empty_cache()
    for dt in ("float32", "bfloat16"):
        for shape in SSD_SHAPES:
            check_ssd(dev, dt, shape, "kernels/model", timed=False)
        for shape in (SSD_MAIN, SSD_MAIN_128, SSD_ZAMBA2):
            rec = check_ssd(dev, dt, shape, "kernels/model", timed=True)
            if dt == "float32":
                recs["ssd_scan"][shape] = rec
        torch.cuda.empty_cache()
    return recs


def main_shape_record(recs: dict, name: str) -> dict:
    """The record of ``name`` at the largest shape the main path gave it,
    or, where that shape was not checked, at the first shape that was."""
    by_shape = recs.get(name, {})
    shape = MAIN_PATH_SHAPES[name]
    if shape is not None and tuple(shape) in by_shape:
        return by_shape[tuple(shape)]
    return next(iter(by_shape.values()), {})


def _count_path(names) -> dict:
    """Add this run's launches of ``names`` to the main-path counts."""
    from repro_torch.kernels import LAUNCHES, SHAPES
    for name in names:
        MAIN_PATH_LAUNCHES[name] += LAUNCHES[name]
        keep_shape(name, SHAPES[name])
    return {name: LAUNCHES[name] for name in names}


def entry_point_phase(dev) -> None:
    """rmsnorm and swap_gain driven once each through their entry points
    (``impl="auto"`` on CUDA tensors), launch counts zeroed just before."""
    import torch
    from repro_torch.kernels import reset_launches
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.swap_gain.ops import swap_gain

    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn(RMSNORM_MAIN, generator=g, device=dev)
    w = torch.ones(RMSNORM_MAIN[1], device=dev)
    M = torch.rand((SWAP_GAIN_N, SWAP_GAIN_N), generator=g, device=dev,
                   dtype=torch.float64)
    M = M + M.T
    contrib = (M * M).sum(-1)
    i = torch.tensor([5], device=dev)
    reset_launches()
    out = rmsnorm(x, w)
    gains = swap_gain(M, M, contrib, i)
    torch.cuda.synchronize()
    launches = _count_path(("rmsnorm", "swap_gain"))
    ok = (bool(torch.isfinite(out).all()) and bool(torch.isfinite(gains)
                                                   .all())
          and all(n == 1 for n in launches.values()))
    emit({"phase": "entry/rmsnorm+swap_gain", "launches": launches,
          "ok": ok})
    if not ok:
        raise AssertionError("an entry point did not launch its kernel")


# --------------------------------------------------- MoE routing records
# A MoE forward through the kernels may send a token to other experts than
# the plain versions' forward does where two of its router probabilities
# tie within rounding (a "flip").  A flip is a near-tie when, in the run
# it is held to, the gap from the token's k-th to its (k+1)-th probability
# is at most this share of the k-th.
MOE_NEAR_TIE = 1e-4


def recording_routes(calls: list):
    """A context in which every ``repro_torch.models.moe.route`` call also
    appends to ``calls``, for its T tokens: (the ids in ascending order (T,
    k), the k-th probability (T,), the gap from the k-th to the (k+1)-th
    probability (T,))."""
    import torch
    from repro_torch.models import moe

    def wrap(route):
        def recorded(logits, top_k):
            out = route(logits, top_k)
            top = torch.topk(torch.softmax(logits.float(), dim=-1),
                             top_k + 1, dim=-1).values
            calls.append((out[1].sort(dim=-1).values, top[:, top_k - 1],
                          top[:, top_k - 1] - top[:, top_k]))
            return out
        return recorded
    return patched(moe, "route", wrap)


def counting_host_syncs(counter: list):
    """A context in which each MoE layer's read of its group offsets to the
    host appends to ``counter``."""
    from repro_torch.models import moe

    def wrap(read):
        def counted(offsets):
            counter.append(1)
            return read(offsets)
        return counted
    return patched(moe, "_host_offsets", wrap)


def moe_spans() -> tuple:
    """The profiler spans of a MoE forward: routing (softmax, top-k, sort,
    gather) and the expert products."""
    from repro_torch.models import moe
    return ((moe, "route", "moe/routing"),
            (moe, "_sort_by_expert", "moe/routing"),
            (moe, "_expert_mlp_sorted", "moe/experts"))


def by_position(calls: list, B: int) -> list:
    """A forward's route records (B·S tokens a call, one call a MoE layer)
    as (B, S, ...) per layer."""
    return [tuple(t.reshape(B, -1, *t.shape[1:]) for t in c) for c in calls]


def by_step(calls: list, n_layers: int) -> list:
    """Decode steps' route records (B tokens a call, ``n_layers`` calls a
    step) as (B, steps, ...) per layer."""
    import torch
    return [tuple(torch.stack(parts, dim=1)
                  for parts in zip(*calls[layer::n_layers]))
            for layer in range(n_layers)]


def routing_verdict(got_routes, want_routes, got, want,
                    first_layer: int) -> dict:
    """The routing rule of the MoE cells.  ``got_routes``/``want_routes``:
    per MoE layer (ids (B, S, k), k-th probability (B, S), gap (B, S)) of
    the run under test and of the run it is held to; ``got``/``want``:
    their logits (B, S, V).

    A flip is a token whose set of experts differs.  Causal attention
    carries a flip at (layer, row, position) to the same and later
    positions of that row in later layers, which may flip there in turn.
    Every flip that no earlier layer's flip reaches must be a near-tie in
    the held run (``MOE_NEAR_TIE``), and the logits must agree within 1e-4
    at every position of each row before the row's first flip.  Without
    flips that is ``allclose`` over every position."""
    import torch

    B, S = got.shape[:2]
    flips, roots = [], []
    reach = [S] * B          # each row's first flip in the layers so far
    for layer, ((g_ids, _, _), (w_ids, w_kth, w_gap)) in enumerate(
            zip(got_routes, want_routes)):
        rel = (w_gap / w_kth).cpu()
        here = list(reach)
        for b, pos in (g_ids != w_ids).any(-1).nonzero().tolist():
            flip = {"layer": first_layer + layer, "row": b, "pos": pos,
                    "gap_rel": float(rel[b, pos])}
            flips.append(flip)
            if pos < reach[b]:
                roots.append(flip)
            here[b] = min(here[b], pos)
        reach = here
    held_ok, held_err = True, 0.0
    for b, n in enumerate(reach):
        if n:
            held_ok &= bool(torch.allclose(got[b, :n], want[b, :n],
                                           atol=1e-4, rtol=1e-4))
            held_err = max(held_err,
                           float((got[b, :n] - want[b, :n]).abs().max()))
    gaps = torch.cat([(w_gap / w_kth).flatten()
                      for _, w_kth, w_gap in want_routes])
    return {"route_calls": len(got_routes), "flips": len(flips),
            "root_flips": len(roots), "flipped": flips[:24],
            "min_flip_gap_rel": min((f["gap_rel"] for f in flips),
                                    default=None),
            "max_root_gap_rel": max((f["gap_rel"] for f in roots),
                                    default=None),
            "min_gap_rel": float(gaps.min()), "first_flip_pos": reach,
            "max_abs_err_before_flips": held_err,
            "ok": (len(got_routes) == len(want_routes) and held_ok
                   and all(f["gap_rel"] <= MOE_NEAR_TIE for f in roots))}


# The 1e-4 hold of a forward against its plain-version forward is below
# float32's own noise at llama-3.2-vision-11b's full depth: two plain
# forwards that differ only in the flash plain version's blocking reach
# 0.45 / 0.64 / 0.80 / 0.91 / 1.12 / 1.29 of the allclose allowance at 5 /
# 10 / 15 / 20 / 30 / 40 layers (tools/forward_drift.py).  So the VLM is
# held to the 1e-4 rule at VLM_HELD_DEPTH layers, the deepest where that
# noise stays under two thirds of the allowance (as PHI35_DEPTH), and its
# 40-layer forward and decode steps by the noise-floor rule
# (``floor_verdict``; the decode steps against the floor the forward
# measured: their logits reach 1.5e-4 of the forward's at 40 layers).
VLM_HELD_DEPTH = 10
# the noise-floor rule's factor: the kernel forward may be at most this
# many times as far from the plain forward as the reblocked plain forward
# is (the f32 flash kernel's own rule against the float64 plain version)
FLOOR_FACTOR = 2.0


def reblocked_flash(q, k, v, causal=True, impl="auto"):
    """The flash plain version summed in another order: query blocks of
    256 and key blocks of 512 instead of 512 and 1024."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    return flash_attention_ref(q, k, v, causal=causal, q_block=256,
                               kv_block=512)


def allowance_ratio(got, want) -> float:
    """The largest ratio of a logit's difference to the allclose(atol =
    rtol = 1e-4) allowance there: at most 1 is the 1e-4 hold."""
    return float(((got - want).abs() / (1e-4 + 1e-4 * want.abs())).max())


def floor_verdict(got, want, floor: float) -> dict:
    """The noise-floor rule of logits too deep for the 1e-4 hold: ``got``
    may be at most ``FLOOR_FACTOR`` times ``floor`` from ``want`` in
    ``allowance_ratio``, where ``floor`` is how far the plain versions'
    forward summed in another order (``reblocked_flash``) is from the
    plain forward; and its argmax ids must equal ``want``'s wherever
    ``want``'s top-2 gap exceeds 1e-3."""
    import torch
    ratio = allowance_ratio(got, want)
    top2 = torch.topk(want, 2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3
    ids_ok = bool((got.argmax(-1) == want.argmax(-1))[clear].all())
    return {"ratio_to_allowance": ratio, "floor_ratio": floor,
            "factor": FLOOR_FACTOR, "argmax_ok": ids_ok,
            "ok": ratio <= FLOOR_FACTOR * floor and ids_ok}


def run_forward(model, toks, launches: dict, key: str,
                source: dict | None = None, floor: bool = False):
    """The forward of ``model`` on ``toks`` (and ``source``, a VLM's
    ``vision_embed`` or an encoder-decoder model's ``enc_embed``) cold,
    warm, once more under the profiler, and through the plain versions
    (``impl="ref"``), held within 1e-4 of each other.  ``launches`` maps
    each kernel the forward must go through to its launches per forward;
    the counts are zeroed just before the cold forward and read just
    after it.

    A MoE model's cold and plain forwards record their routes, the cold
    forward counts its host syncs, and the two forwards are held to each
    other by ``routing_verdict``.  With ``floor`` the plain versions run
    once more with ``reblocked_flash`` and the forwards are held by
    ``floor_verdict`` instead of the 1e-4 rule.  Returns (logits, record, the cold
    forward's routes by position or None)."""
    import torch
    from repro_torch.kernels import LAUNCHES, reset_launches

    names = tuple(launches)
    source, extra = source or {}, {}
    moe = model.cfg.family == "moe"
    got_routes, want_routes, syncs = [], [], []

    def recording(calls):
        stack = contextlib.ExitStack()
        if moe:
            stack.enter_context(recording_routes(calls))
            stack.enter_context(counting_host_syncs(syncs))
        return stack

    with torch.inference_mode():
        reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recording(got_routes):
            logits = model(toks, **source)
            torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        got = _count_path(names)
        peak = torch.cuda.max_memory_allocated()
        n_syncs = len(syncs)
        t0 = time.perf_counter()
        model(toks, **source)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        prof = profiled(lambda: model(toks, **source), key,
                        spans=moe_spans() if moe else ())
        total = {name: LAUNCHES[name] for name in names}
        with recording(want_routes):
            plain = model(toks, impl="ref", **source)
            torch.cuda.synchronize()
        if floor:
            from repro_torch.models import layers
            with patched(layers, "flash_attention",
                         lambda f: reblocked_flash):
                extra["noise_floor"] = floor_verdict(
                    logits, plain, allowance_ratio(
                        model(toks, impl="ref", **source), plain))
    err, close = close_in_slices(logits, plain)
    routes = None
    if moe:
        routes = by_position(got_routes, toks.shape[0])
        extra["routing"] = routing_verdict(
            routes, by_position(want_routes, toks.shape[0]), logits, plain,
            model.cfg.moe.first_dense)
        extra["host_syncs_per_forward"] = n_syncs
        plain_ok = extra["routing"]["ok"]
    elif floor:
        plain_ok = extra["noise_floor"]["ok"]
    else:
        plain_ok = close
    del plain, want_routes
    B, S = toks.shape
    n = model.cfg.n_layers
    extra.update({f"{k}_len": v.shape[1] for k, v in source.items()})
    if model.cfg.family == "encdec":
        extra["enc_layers"] = model.cfg.n_enc_layers
    rec = {"phase": key, "dtype": str(logits.dtype).replace("torch.", ""),
           "batch": B, "seq": S, "layers": n, "cold_s": cold,
           "warm_s": warm, "prefill_tok_per_s": B * S / warm,
           "peak_mem_mb": peak / 2**20,
           "launches_per_forward": got,
           "launches_in_three_forwards": total,
           "max_abs_err_vs_plain": err, "plain_ok": plain_ok, **extra,
           **prof, "finite": bool(torch.isfinite(logits).all()),
           "shape_ok": tuple(logits.shape) == (B, S, model.cfg.vocab)}
    rec["ok"] = (got == launches
                 and total == {k: 3 * v for k, v in launches.items()}
                 and plain_ok and rec["finite"] and rec["shape_ok"])
    return logits, rec, routes


def close_in_slices(got, want, rows: int = 256) -> tuple[float, bool]:
    """(the largest absolute difference, ``allclose(atol=rtol=1e-4)``) of
    two (B, S, V) logits, ``rows`` positions of a row at a time: the
    temporaries of one slice, not of the whole (nemotron-4-340b's logits
    are 4.2 GB a forward)."""
    import torch
    err, ok = 0.0, True
    for b in range(got.shape[0]):
        for s in range(0, got.shape[1], rows):
            g, w = got[b, s:s + rows], want[b, s:s + rows]
            err = max(err, float((g - w).abs().max()))
            ok &= bool(torch.allclose(g, w, atol=1e-4, rtol=1e-4))
    return err, ok


def held_to_reference(logits, positions, expected) -> dict:
    """``forward_summary`` of ``logits`` at ``positions`` against the
    reference's ``expected`` under ``forward_agrees``' rule."""
    summary = forward_summary(logits[:, list(positions)].float().cpu()
                              .numpy())
    return {"summary": summary,
            "max_sum_rel_err_vs_reference": max(
                abs(s[1] - e[1]) / abs(e[1])
                for s, e in zip(summary, expected)),
            "reference_ok": forward_agrees(summary, expected)}


def model_phase(dev):
    """smollm-135m, full width and depth, float32, NumPy-seeded weights:
    the 2048-token forward through the flash kernel, held to the plain
    version's forward and to the reference's logits.  Returns (model,
    tokens, logits of the first 8 positions) for the decode phase."""
    import torch
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.train.data import SyntheticDataset

    cfg = get_arch("smollm-135m")
    t0 = time.perf_counter()
    model = interop.model_params(cfg, interop.seeded_params(cfg, seed=0),
                                 device=dev)
    toks = SyntheticDataset(cfg.vocab, 2048, 2, seed=0).batch(0)["tokens"]
    toks = toks.to(dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    logits, rec, _ = run_forward(model, toks,
                                 {"flash_attention": cfg.n_layers},
                                 "model/smollm-135m/forward-2048")
    rec.update(load_s=load_s, **held_to_reference(logits, HELD_POSITIONS,
                                                  EXPECTED_FORWARD))
    rec["ok"] = rec["ok"] and rec["reference_ok"]
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the smollm-135m forward failed its checks")
    return model, toks, logits[:, :8].clone()


def per_forward_launches(cfg, S: int) -> dict:
    """The kernel launches one forward of ``cfg`` on S tokens makes: one
    ``ssd_scan`` per mamba2 layer, one ``flash_attention`` per causal
    self-attention application when S reaches the flash branch
    (``FLASH_MIN_SEQ``): a VLM's G·k self layers, not its cross layers;
    an encoder-decoder model's decoder layers, not its encoder's."""
    from repro_torch.models.layers import FLASH_MIN_SEQ
    from repro_torch.models.model import _hybrid_split, _vlm_split

    if cfg.family == "ssm":
        return {"ssd_scan": cfg.n_layers}
    out = {}
    attn = cfg.n_layers
    if cfg.family == "hybrid":
        G, k, trail = _hybrid_split(cfg)
        out["ssd_scan"] = G * k + trail
        attn = G
    if cfg.family == "vlm":
        G, k = _vlm_split(cfg)
        attn = G * k
    if S >= FLASH_MIN_SEQ:
        out["flash_attention"] = attn
    return out


def source_inputs(cfg, B: int, S: int, dev) -> dict:
    """A VLM's ``vision_embed`` (B, n_vision_tokens, d_model) or an
    encoder-decoder model's ``enc_embed`` (B, n_audio_frames or S,
    d_model, as the reference's stubs are sized), drawn by
    ``seeded_source(seed=0)`` and put on ``dev``; {} for other models."""
    import torch
    if cfg.family == "vlm":
        key, n = "vision_embed", cfg.n_vision_tokens
    elif cfg.family == "encdec":
        key, n = "enc_embed", cfg.n_audio_frames or S
    else:
        return {}
    return {key: torch.from_numpy(seeded_source((B, n, cfg.d_model)))
            .to(dev)}


def _depth_tag(over: dict) -> str:
    """``L<n_layers>``, with ``-E<n_enc_layers>`` where the cut sets it."""
    tag = f"L{over['n_layers']}"
    return tag + (f"-E{over['n_enc_layers']}" if "n_enc_layers" in over
                  else "")


def cut_depth_phase(dev, arch: str, over: dict, B: int, S: int,
                    positions, expected) -> None:
    """``arch`` at full width with its depth cut as ``over`` says
    (``n_layers``, and an encoder-decoder model's ``n_enc_layers``),
    float32, NumPy-seeded weights (``interop.seeded_params(seed=0)``): a
    B x S forward on ``SyntheticDataset(seed=0)`` tokens (and seeded
    source embeddings, ``source_inputs``) through the kernels, held to
    the reference's logits ``expected`` at ``positions``."""
    import dataclasses
    import torch
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import reset_launches
    from repro_torch.train.data import SyntheticDataset

    cfg = dataclasses.replace(get_arch(arch), **over)
    t0 = time.perf_counter()
    model = interop.model_params(cfg, interop.seeded_params(cfg, seed=0),
                                 device=dev)
    toks = SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]
    toks = toks.to(dev)
    source = source_inputs(cfg, B, S, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want = per_forward_launches(cfg, S)
    with torch.inference_mode():
        reset_launches()
        t0 = time.perf_counter()
        logits = model(toks, **source)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _count_path(("ssd_scan", "flash_attention"))
    rec = held_to_reference(logits, positions, expected)
    ok = (launches == {k: want.get(k, 0) for k in launches}
          and rec["reference_ok"] and bool(torch.isfinite(logits).all())
          and tuple(logits.shape) == (B, S, cfg.vocab))
    emit({"phase": f"model/{arch}/forward-{S}-{_depth_tag(over)}",
          "dtype": "float32", "batch": B, "seq": S, **over,
          "load_s": load_s, "cold_s": wall, "launches": launches, **rec,
          "ok": ok})
    if not ok:
        raise AssertionError(f"the cut-depth {arch} forward failed its "
                             f"checks")


def full_depth_phase(dev, arch: str, depth: int | None = None,
                     floor: bool = False):
    """``arch`` at full width and depth (or its depth cut to ``depth``
    layers), float32, weights drawn on the card from seed 0: the B 2 x
    2048 forward through the kernels (``run_forward``), held to the plain
    versions' forward (by ``floor_verdict`` with ``floor``).  Returns (model, tokens, logits of the first 8
    positions, a MoE model's routes there or None, the source inputs, and
    with ``floor`` the reblocked plain forward's ``allowance_ratio``) for
    the decode phase."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.train.data import SyntheticDataset

    cfg = get_arch(arch)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    t0 = time.perf_counter()
    model = M.init(cfg, seed=0, device=dev)
    toks = SyntheticDataset(cfg.vocab, 2048, 2, seed=0).batch(0)["tokens"]
    toks = toks.to(dev)
    source = source_inputs(cfg, 2, 2048, dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    logits, rec, routes = run_forward(
        model, toks, per_forward_launches(cfg, 2048),
        f"model/{arch}/forward-2048" + (f"-L{depth}" if depth else ""),
        source, floor)
    rec["load_s"] = load_s
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the {arch} forward failed its checks")
    if routes is not None:
        routes = [tuple(t[:, :8].clone() for t in c) for c in routes]
    floor_ratio = rec["noise_floor"]["floor_ratio"] if floor else None
    return model, toks, logits[:, :8].clone(), routes, source, floor_ratio


def model_family_phase(dev, arch: str, cut: tuple | None = None,
                       depth: int | None = None, serve: bool = True,
                       held_depth: int | None = None, tag: str = "") -> None:
    """The cut-depth forward held to the reference (``cut``: the depth
    overrides, B, S, held positions, expected summary; None skips it),
    with ``held_depth`` a forward at that depth and 8 decode steps held to
    its plain-version forward within 1e-4, then the forward at full depth
    (or at ``depth`` layers), 8 decode steps held to it (both by the
    noise-floor rule when ``held_depth`` is given; ``tag`` ends the decode
    phase's key) and, with ``serve``, the serve driver; each model is
    freed before the next."""
    import torch
    if cut is not None:
        cut_depth_phase(dev, arch, *cut)
        torch.cuda.empty_cache()
    if held_depth is not None:
        model, toks, fwd_logits, _, source, _ = full_depth_phase(
            dev, arch, held_depth)
        decode_phase(model, toks, fwd_logits, source=source,
                     tag=f"-L{held_depth}")
        del model, toks, fwd_logits, source
        torch.cuda.empty_cache()
    model, toks, fwd_logits, fwd_routes, source, floor = full_depth_phase(
        dev, arch, depth, floor=held_depth is not None)
    decode_phase(model, toks, fwd_logits, fwd_routes, source=source,
                 floor=floor, tag=tag)
    del model, toks, fwd_logits, fwd_routes, source
    torch.cuda.empty_cache()
    if serve:
        serve_phase(arch)


def cross_cache(model, source: dict):
    """A VLM's or an encoder-decoder model's frozen cross cache from its
    source inputs (after ``encode`` for the latter), as the serve driver
    builds it; None for other models."""
    from repro_torch.serve.decode import encode, prefill_cross_cache
    if "vision_embed" in source:
        return prefill_cross_cache(model, source["vision_embed"])
    if "enc_embed" in source:
        return prefill_cross_cache(model, encode(model, source["enc_embed"]),
                                   which="decoder")
    return None


def decode_phase(model, toks, fwd_logits, fwd_routes=None,
                 steps: int = 8, source: dict | None = None,
                 floor: float | None = None, tag: str = "") -> None:
    """``steps`` decode steps from empty caches (a VLM's or an
    encoder-decoder model's cross cache built once from ``source``, the
    forward's source inputs, and timed apart), each held to the forward's
    logits at the same position (atol = rtol = 1e-4; a MoE model's by
    ``routing_verdict`` against the forward's routes ``fwd_routes``; with
    ``floor``, the reblocked plain forward's ``allowance_ratio``, by
    ``floor_verdict``); then the same steps
    again from empty self caches, timed without the checks, and once more
    under the profiler.  ``tag`` ends the phase's key."""
    import torch
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    B = toks.shape[0]
    source = source or {}
    src_len = (source["enc_embed"].shape[1] if "enc_embed" in source
               else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cross = cross_cache(model, source)
    torch.cuda.synchronize()
    cross_s = time.perf_counter() - t0

    def empty_caches():
        c = init_cache(model.cfg, B, steps, device=model.device,
                       src_len=src_len)
        if cross is not None:
            c["cross"] = cross
        return c

    caches = empty_caches()
    calls, outs = [], []
    with (recording_routes(calls) if fwd_routes is not None
          else contextlib.nullcontext()):
        for t in range(steps):
            got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
            outs.append(got[:, 0])
    got, want = torch.stack(outs, dim=1), fwd_logits[:, :steps]
    err, extra = float((got - want).abs().max()), {}
    if floor is not None:
        extra["noise_floor"] = floor_verdict(got, want, floor)
        ok = extra["noise_floor"]["ok"]
    elif fwd_routes is None:
        ok = bool(torch.allclose(got, want, atol=1e-4, rtol=1e-4))
    else:
        extra["routing"] = routing_verdict(
            by_step(calls, len(model.blocks)),
            [tuple(t[:, :steps] for t in c) for c in fwd_routes], got, want,
            model.cfg.moe.first_dense)
        ok = extra["routing"]["ok"]

    def run():
        c = empty_caches()
        for t in range(steps):
            decode_step(model, c, toks[:, t:t + 1], t)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    key = f"model/{model.cfg.name}/decode-{steps}{tag}"
    if cross is not None:
        extra["cross_cache_s"] = cross_s
    emit({"phase": key, "batch": B, "steps": steps, "s": wall,
          "ms_per_step": wall / steps * 1e3, **profiled(run, key),
          "max_abs_err_vs_forward": err, **extra, "ok": ok})
    if not ok:
        raise AssertionError("decode disagrees with the forward")


def serve_phase(arch: str = "smollm-135m") -> None:
    """The port's serve driver with the reference's default arguments, on
    ``cuda``: it must return 0; its printed times are read back."""
    import contextlib
    import io
    import re
    from repro_torch.launch import serve

    argv = ["--arch", arch, "--batch", "4", "--prompt-len", "32",
            "--gen", "16"]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = serve.main(argv)
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    secs = [float(x) for x in re.findall(r"in ([0-9.]+)s", out)]
    ok = rc == 0 and len(secs) == 2 and len(out.splitlines()) == 3
    emit({"phase": f"serve/{arch}", "argv": argv, "rc": rc,
          "wall_s": wall, "prefill_s": secs[0] if ok else None,
          "decode_s": secs[1] if ok else None,
          "prefill_tok_per_s": 32 * 4 / secs[0] if ok and secs[0] else None,
          "decode_tok_per_s": 16 * 4 / secs[1] if ok and secs[1] else None,
          "output": out.splitlines(), "ok": ok})
    if not ok:
        raise AssertionError("the serve driver failed")


# ---------------------------------------------------------------- training
# the throughput cell (train/smollm-135m/B8-S1024): B 8 x 1024 tokens,
# below FLASH_MIN_SEQ, fresh batches, AdamW at the reference optimizer's
# default lr (3e-4) with launch/train.py's 10 warmup steps; the resume
# check saves after TRAIN_RESUME_AT steps.  At launch/train.py's lr of
# 3e-3 this model's loss rises over 20 steps, with a spike in the
# gradient norm as the warmup ends; at full vocab the
# Markov stream gives 20 steps little to learn beyond flattening the
# initial logits, so the loss is held to fall from the mean of the first
# five steps to the mean of the last five
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_RESUME_AT = 8, 1024, 20, 10
TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 10}
# the MoE / MLA cell (train/deepseek-v2-lite-16b/L2): 2 layers at full
# width, B 2 x 1024, launch/train.py's AdamW (lr 3e-3, 10 warmup
# steps)
DSV2_TRAIN_B, DSV2_TRAIN_S, DSV2_TRAIN_STEPS = 2, 1024, 5
DSV2_TRAIN_OPT = {"lr": 3e-3, "warmup_steps": 10}
# The cells through the backward kernels.  mamba2-2.7b at full width, cut
# to 16 of its 64 layers (0.90 B parameters): parameters, gradients and
# the two AdamW moments take 14.4 GB and each layer's activations about
# 0.4 GB a sequence, so all 64 layers at B 1 would need about 71 GB of the
# card's 80.  smollm-135m at the reference's train_4k sequence (4096
# tokens; its global batch of 256 sequences is a pod's) at B 2.
MAMBA2_TRAIN_DEPTH = 16
TRAIN_4K_BATCH = 2


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms (and the cuBLAS workspace setting they
    ask for) inside the block only."""
    import os
    import torch
    old_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    old = torch.are_deterministic_algorithms_enabled()
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old)
        if old_env is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_env


def host_syncs(run) -> int:
    """Synchronising CUDA operations (reads to the host, blocking copies)
    that ``run()`` makes, counted by PyTorch's sync debug mode."""
    import warnings
    import torch
    old = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(old)
    return sum("synchroniz" in str(w.message) for w in caught)


def train_spans() -> tuple:
    """The profiler spans of a train step: the forward with its loss, and
    the AdamW update (the backward is what the step spends outside
    them)."""
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import AdamW
    return ((train_step, "loss_fn", "train/forward"),
            (AdamW, "update", "train/adamw"))


def train_flops(cfg, B: int, S: int) -> float:
    """Operations of one train step: 6 N per token for the parameters'
    products (N = ``cfg.n_params``), plus the plain attention's score
    and value products over the whole S x S square it computes before
    masking, forward (4 B H S^2 Dh a layer) and backward (twice that)."""
    return 6.0 * cfg.n_params * B * S \
        + 12.0 * B * cfg.n_heads * S * S * cfg.head_dim_ * cfg.n_layers


def backward_device_s(run) -> dict:
    """``run()`` once more with each backward's ``_backward`` between two
    CUDA events; the device seconds between them, summed over the run by
    kernel: the backward kernels and all else ``_backward`` launches, the
    ``ssd_scan`` states recomputed by the forward's stages 1-2 among it.
    The step runs on one stream, so nothing else lies between the two."""
    import torch
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    events = {"flash_attention_bwd": [], "ssd_scan_bwd": []}

    def between_events(name, fn):
        def wrapper(*args, **kwargs):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            events[name].append((a, b))
            return out
        return wrapper

    with patched(flash_ops, "_backward",
                 lambda f: between_events("flash_attention_bwd", f)), \
            patched(ssd_ops, "_backward",
                    lambda f: between_events("ssd_scan_bwd", f)):
        run()
        torch.cuda.synchronize()
    return {name: sum(a.elapsed_time(b) for a, b in pairs) / 1e3
            for name, pairs in events.items()}


def timed_steps(step, model, state, batches):
    """``step`` on each batch; returns (state, metrics of each step, wall
    s of each step, each ending in a device synchronise)."""
    import torch
    metrics, secs = [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, m = step(model, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append(m)
    return state, metrics, secs


def train_held_cell(dev, arch: str, over: dict, batch: int, seq: int,
                    expected, spread, tag: str = "") -> None:
    """train/<arch>/held<tag>: ``arch`` at full width (its depth cut as
    ``over`` says) on ``interop.seeded_params(seed=0)`` weights, the held
    steps at ``batch`` x ``seq`` on the card, each step's loss and
    grad_norm held to ``expected`` (the reference's) by ``train_agrees``
    with ``spread``, the float32 spread measured on the CPU; each step's
    forward and backward launch every kernel the forward reaches (its
    backward too) once a layer."""
    import dataclasses
    from repro_torch import interop
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import reset_launches

    cfg = dataclasses.replace(get_arch(arch), **over)
    key = f"train/{arch}/held{tag}"
    model = interop.model_params(cfg, interop.seeded_params(cfg, seed=0),
                                 device=dev)
    want = train_launches(cfg, seq, len(expected))
    reset_launches()
    t0 = time.perf_counter()
    got = held_train_steps(model, batch, seq, len(expected))
    wall = time.perf_counter() - t0
    launches = _count_path(tuple(want)) if want else {}
    ok = train_agrees(got, expected, spread) and launches == want
    emit({"phase": key, "batch": batch, "seq": seq,
          "layers": cfg.n_layers, "opt": TRAIN_HELD_OPT, "s": wall,
          "got": got, "expected": expected,
          "rel_err": [[abs(g - e) / abs(e) for g, e in zip(gs, es)]
                      for gs, es in zip(got, expected)],
          "allowed_rtol": [max(1e-4, FLOOR_FACTOR * x) for x in spread],
          "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"the held {arch} train steps disagree with "
                             f"the reference or missed a kernel")


def train_launches(cfg, S: int, steps: int) -> dict:
    """Launches ``steps`` train steps of ``cfg`` on S tokens make: each
    forward's (``per_forward_launches``), and one backward launch for each
    forward one."""
    fwd = per_forward_launches(cfg, S)
    return {**{k: n * steps for k, n in fwd.items()},
            **{f"{k}_bwd": n * steps for k, n in fwd.items()}}


@contextlib.contextmanager
def plain_versions():
    """Every model forward inside the block runs the kernels' plain
    versions (``impl="ref"``), also under a train step that does not pass
    ``impl``."""
    from repro_torch.models import model as M
    with patched(M.Transformer, "forward",
                 lambda f: lambda self, *a, **kw: f(self, *a, **kw,
                                                    impl="ref")):
        yield


def train_kernel_cell(dev, arch: str, over: dict, B: int, S: int,
                      steps: int, opt_kw: dict, tag: str) -> None:
    """train/<arch>/<tag>: ``arch`` at full width (depth cut as ``over``
    says), weights drawn on the card, ``steps`` train steps at B x S
    through the kernels' forwards and backwards.  Held: every step's
    launches of each kernel the forward reaches and of its backward (one
    a layer), finite losses and gradient norms, a falling loss (the mean
    of the last five steps below that of the first five; the last below
    the first with fewer than ten steps), and step 1 to the same step on
    the same weights with the plain versions on the card
    (``train_agrees``, rtol 1e-4).  Recorded: step ms, tokens/s, peak
    memory, and one more step profiled for the device's idle share and the
    backward kernels' share of its busy time (``bwd_kernel_share``); then
    one more with each ``_backward`` between CUDA events
    (``backward_device_s``), its device time over that busy time
    (``bwd_share``), the ``ssd_scan`` states' recompute included."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import reset_launches
    from repro_torch.models import model as M
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_arch(arch), **over)
    key = f"train/{arch}/{tag}"
    ds = SyntheticDataset(cfg.vocab, S, B, seed=0)
    batches = [ds.batch(i) for i in range(steps + 1)]
    opt = AdamW(**opt_kw)
    step = make_train_step(cfg, opt)
    model = M.init(cfg, seed=0, device=dev)
    with plain_versions():
        _, m = step(model, opt.init(model), batches[0])
    plain1 = [float(m["loss"]), float(m["grad_norm"])]
    del model, m
    torch.cuda.empty_cache()

    model = M.init(cfg, seed=0, device=dev)
    state = opt.init(model)
    want = train_launches(cfg, S, steps)
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, secs = timed_steps(step, model, state, batches[:steps])
    peak = torch.cuda.max_memory_allocated()
    launches = _count_path(tuple(want))
    losses = [float(x["loss"]) for x in metrics]
    norms = [float(x["grad_norm"]) for x in metrics]
    prof = profiled(lambda: step(model, state, batches[steps]), key,
                    spans=train_spans())
    bwd_s = backward_device_s(lambda: step(model, state, batches[steps]))
    del model, state
    warm = statistics.median(secs[1:])
    busy = prof["device_busy_s"]
    got1 = [losses[0], norms[0]]
    falls = (statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
             if steps >= 10 else losses[-1] < losses[0])
    rec = {"phase": key, "batch": B, "seq": S, "layers": cfg.n_layers,
           "params": cfg.n_params, "opt": opt_kw, "steps": steps,
           "losses": losses, "grad_norms": norms,
           "step1": got1, "step1_plain": plain1,
           "step1_rel_err": [abs(g - e) / abs(e)
                             for g, e in zip(got1, plain1)],
           "first_step_s": secs[0], "step_ms": warm * 1e3,
           "step_ms_all": [x * 1e3 for x in secs],
           "tokens_per_s": B * S / warm, "peak_mem_mb": peak / 2**20,
           **prof,
           "bwd_kernel_share": {
               k: prof[f"{k}_device_s"] / busy if busy else None
               for k in ("flash_attention_bwd", "ssd_scan_bwd")},
           "bwd_device_s": bwd_s,
           "bwd_share": {k: t / busy if busy else None
                         for k, t in bwd_s.items()},
           "launches": launches, "launches_expected": want}
    rec["ok"] = (all(math.isfinite(x) for x in losses + norms) and falls
                 and launches == want
                 and train_agrees([got1], [plain1], [0.0]))
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"the {key} training cell failed its checks")


def train_throughput_phase(dev) -> None:
    """train/smollm-135m/B8-S1024: the full model, weights drawn on the
    card, ``TRAIN_STEPS`` steps at B 8 x 1024 (the mean loss of the last
    five must be below that of the first five), one more
    under the profiler and one counting its host syncs; then the resume
    check: after ``TRAIN_RESUME_AT`` steps a checkpoint is saved, the
    next step runs under deterministic algorithms, and the same step on a
    fresh model and AdamW state restored from the checkpoint must give
    the same loss and parameters, bit for bit."""
    import shutil
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model as M
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    cfg = get_arch("smollm-135m")
    key = f"train/{cfg.name}/B{TRAIN_B}-S{TRAIN_S}"
    model = M.init(cfg, seed=0, device=dev)
    reset_launches()
    opt = AdamW(**TRAIN_OPT)
    step, state = make_train_step(cfg, opt), opt.init(model)
    ds = SyntheticDataset(cfg.vocab, TRAIN_S, TRAIN_B, seed=0)
    batches = [ds.batch(i) for i in range(TRAIN_STEPS + 2)]
    ckpt_dir = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, secs = timed_steps(step, model, state,
                                       batches[:TRAIN_RESUME_AT])
    t0 = time.perf_counter()
    path = save_checkpoint(str(ckpt_dir), TRAIN_RESUME_AT, model, state)
    save_s = time.perf_counter() - t0
    with deterministic():
        state, m, s = timed_steps(step, model, state,
                                  [batches[TRAIN_RESUME_AT]])
    metrics += m
    secs += s
    after = {k: t.detach().clone() for k, t in model.named_parameters()}
    state, m, s = timed_steps(step, model, state,
                              batches[TRAIN_RESUME_AT + 1:TRAIN_STEPS])
    metrics += m
    secs += s
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x["loss"]) for x in metrics]
    norms = [float(x["grad_norm"]) for x in metrics]
    prof = profiled(lambda: step(model, state, batches[TRAIN_STEPS]), key,
                    spans=train_spans())
    syncs = host_syncs(lambda: step(model, state, batches[TRAIN_STEPS + 1]))
    torch.cuda.synchronize()

    fresh = M.Transformer(cfg, device=dev)
    t0 = time.perf_counter()
    restored = restore_checkpoint(path, fresh, opt.init(fresh))
    restore_s = time.perf_counter() - t0
    with deterministic():
        _, m, _ = timed_steps(step, fresh, restored["opt"],
                              [batches[TRAIN_RESUME_AT]])
    same_loss = bool(torch.equal(m[0]["loss"],
                                 metrics[TRAIN_RESUME_AT]["loss"]))
    same_params = all(torch.equal(t, after[k])
                      for k, t in fresh.named_parameters())
    del fresh, restored, after
    shutil.rmtree(ckpt_dir, ignore_errors=True)

    warm = statistics.median(secs[1:])
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    busy = prof["device_busy_s"]
    rec = {"phase": key, "batch": TRAIN_B, "seq": TRAIN_S,
           "layers": cfg.n_layers, "opt": TRAIN_OPT, "steps": TRAIN_STEPS,
           "losses": losses, "grad_norms": norms,
           "first_step_s": secs[0], "step_ms": warm * 1e3,
           "step_ms_all": [x * 1e3 for x in secs],
           "tokens_per_s": TRAIN_B * TRAIN_S / warm,
           "peak_mem_mb": peak / 2**20, "flops_per_step": flops,
           "tflops": flops / warm / 1e12, **prof,
           "gemm_share": prof["gemm_device_s"] / busy if busy else None,
           "host_syncs_per_step": syncs, "launches": dict(LAUNCHES),
           "checkpoint_save_s": save_s, "checkpoint_restore_s": restore_s,
           "resume": {"at": TRAIN_RESUME_AT, "deterministic": True,
                      "same_loss": same_loss, "same_params": same_params}}
    falls = statistics.mean(losses[-5:]) < statistics.mean(losses[:5])
    rec["ok"] = (all(math.isfinite(x) for x in losses + norms) and falls
                 and same_loss and same_params)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the smollm-135m training cell failed its "
                             "checks")


def train_launch_phase() -> None:
    """train/launch: ``launch/train.py`` on the full smollm-135m on
    ``cuda``, 20 steps with a checkpoint every 10, then ``--resume`` to
    30; the second run must resume at step 20 and run 10 steps."""
    import io
    import shutil
    from repro_torch.launch import train

    ckpt_dir = ROOT / "build" / "chip_smoke_launch_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    common = ["--checkpoint-dir", str(ckpt_dir), "--checkpoint-every", "10"]
    runs = []
    for argv in (["--steps", "20"] + common,
                 ["--steps", "30", "--resume"] + common):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = train.main(argv)
        runs.append({"argv": argv, "rc": rc,
                     "wall_s": time.perf_counter() - t0,
                     "output": buf.getvalue().splitlines()})
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    first, second = runs
    want = f"resumed from {ckpt_dir / 'step_00000020'} at step 20"
    ok = (first["rc"] == 0 and second["rc"] == 0
          and second["output"][0] == want
          and second["output"][-1].startswith("done: 10 steps in ")
          and any(x.startswith("step    30 loss ")
                  for x in second["output"]))
    emit({"phase": "train/launch", "runs": runs, "ok": ok})
    if not ok:
        raise AssertionError("the training driver did not resume")


def train_dsv2_phase(dev) -> None:
    """train/deepseek-v2-lite-16b/L2: the MoE and MLA paths under grad,
    full width, 2 layers (one dense, one MoE), weights drawn on the card,
    ``DSV2_TRAIN_STEPS`` steps at B 2 x 1024: every step's gradient norm
    (a sum over every gradient element) finite, the loss falling, the
    parameters finite; one more step profiled, one counting its host
    syncs and its MoE offset reads."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import model as M
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b"), n_layers=2)
    key = f"train/{cfg.name}/L2"
    model = M.init(cfg, seed=0, device=dev)
    reset_launches()
    opt = AdamW(**DSV2_TRAIN_OPT)
    step, state = make_train_step(cfg, opt), opt.init(model)
    ds = SyntheticDataset(cfg.vocab, DSV2_TRAIN_S, DSV2_TRAIN_B, seed=0)
    batches = [ds.batch(i) for i in range(DSV2_TRAIN_STEPS + 2)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, metrics, secs = timed_steps(step, model, state,
                                       batches[:DSV2_TRAIN_STEPS])
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x["loss"]) for x in metrics]
    norms = [float(x["grad_norm"]) for x in metrics]
    prof = profiled(lambda: step(model, state, batches[DSV2_TRAIN_STEPS]),
                    key, spans=train_spans() + moe_spans())
    offsets = []
    with counting_host_syncs(offsets):
        syncs = host_syncs(
            lambda: step(model, state, batches[DSV2_TRAIN_STEPS + 1]))
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    warm = statistics.median(secs[1:])
    busy = prof["device_busy_s"]
    rec = {"phase": key, "batch": DSV2_TRAIN_B, "seq": DSV2_TRAIN_S,
           "layers": cfg.n_layers, "params": cfg.n_params,
           "opt": DSV2_TRAIN_OPT, "losses": losses, "grad_norms": norms,
           "first_step_s": secs[0], "step_ms": warm * 1e3,
           "step_ms_all": [x * 1e3 for x in secs],
           "tokens_per_s": DSV2_TRAIN_B * DSV2_TRAIN_S / warm,
           "peak_mem_mb": peak / 2**20, **prof,
           "gemm_share": prof["gemm_device_s"] / busy if busy else None,
           "host_syncs_per_step": syncs,
           "moe_offset_reads_per_step": len(offsets),
           "params_finite": finite, "launches": dict(LAUNCHES)}
    rec["ok"] = (all(math.isfinite(x) for x in losses + norms) and finite
                 and losses[-1] < losses[0])
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the deepseek-v2-lite training cell failed "
                             "its checks")


TRAIN_PHASES = (
    ("held", lambda dev: train_held_cell(
        dev, "smollm-135m", {}, TRAIN_HELD_BATCH, TRAIN_HELD_SEQ,
        EXPECTED_TRAIN, TRAIN_SPREAD)),
    ("B8-S1024", train_throughput_phase),
    ("launch", lambda dev: train_launch_phase()),
    ("deepseek-v2-lite-16b", train_dsv2_phase),
    ("mamba2-2.7b/held-L2", lambda dev: train_held_cell(
        dev, "mamba2-2.7b", {"n_layers": 2}, TRAIN_HELD_BATCH,
        TRAIN_HELD_SEQ, EXPECTED_TRAIN_MAMBA2, TRAIN_SPREAD_MAMBA2,
        "-L2")),
    ("smollm-135m/held-S2048", lambda dev: train_held_cell(
        dev, "smollm-135m", {}, 1, TRAIN_S2048_SEQ, EXPECTED_TRAIN_S2048,
        TRAIN_SPREAD_S2048, f"-S{TRAIN_S2048_SEQ}")),
    ("mamba2-2.7b/L16", lambda dev: train_kernel_cell(
        dev, "mamba2-2.7b", {"n_layers": MAMBA2_TRAIN_DEPTH}, 2, 2048, 10,
        TRAIN_OPT, f"L{MAMBA2_TRAIN_DEPTH}")),
    ("zamba2-7b/L7-S2048", lambda dev: train_kernel_cell(
        dev, "zamba2-7b", {"n_layers": 7}, 1, 2048, 5, DSV2_TRAIN_OPT,
        "L7-S2048")),
    ("smollm-135m/S4096", lambda dev: train_kernel_cell(
        dev, "smollm-135m", {}, TRAIN_4K_BATCH, 4096, 10, TRAIN_OPT,
        "S4096")))


# ----------------------------------------------------------------- parallel
# The sharding layer (repro_torch.parallel.sharding) at world size 1: an
# nccl group of this process alone and a 1 x 1 (data x model) DeviceMesh
# on the card.  parallel/train: smollm-135m at full width, B 2 x 2048, two
# sharded steps (DTensor parameters, each block under activation
# checkpointing, the flash kernels through local_map) against two steps
# of the unsharded model on the same weights and batches.
PARALLEL_TRAIN_B, PARALLEL_TRAIN_S, PARALLEL_TRAIN_STEPS = 2, 2048, 2
PARALLEL_DECODE = (2, 2048, 8)          # B, cache length, decode steps
PARALLEL_REFINE = "place/torus-16x16x16/npb_dt-1024/healthy"
CARD = []


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    if not CARD:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        CARD.append(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
                    else "nvidia-smi: no output")
    return CARD[0]


def parallel_train_cell(dev, mesh, steps: int = PARALLEL_TRAIN_STEPS,
                        phase: str = "parallel/train/smollm-135m") -> None:
    """parallel/train/smollm-135m: ``steps`` sharded steps held to the
    unsharded ones bit for bit, or by ``train_agrees`` (rtol 1e-4) where
    DTensor reorders a sum (``bit_equal`` says which); each step's wall,
    the host ms the DTensor step adds to the warm step, and the flash
    forward and backward launches under the mesh (one forward and its
    recompute, and one backward, a layer and step)."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import reset_launches
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    cfg = get_arch("smollm-135m")
    B, S = PARALLEL_TRAIN_B, PARALLEL_TRAIN_S
    ds = SyntheticDataset(cfg.vocab, S, B, seed=0)
    batches = [ds.batch(i) for i in range(steps)]
    opt = AdamW(**TRAIN_OPT)
    model = M.init(cfg, seed=0, device=dev)
    _, plain, plain_s = timed_steps(make_train_step(cfg, opt), model,
                                    opt.init(model), batches)
    del model
    ctx = ShardingCtx(mesh=mesh)
    model = ctx.distribute(M.init(cfg, seed=0, device=dev))
    reset_launches()
    torch.cuda.synchronize()
    _, sharded, sharded_s = timed_steps(make_train_step(cfg, opt, ctx),
                                        model, opt.init(model), batches)
    launches = _count_path(("flash_attention", "flash_attention_bwd"))
    del model
    got = [[float(m["loss"]), float(m["grad_norm"])] for m in sharded]
    want = [[float(m["loss"]), float(m["grad_norm"])] for m in plain]
    want_launches = {"flash_attention": 2 * cfg.n_layers * steps,
                     "flash_attention_bwd": cfg.n_layers * steps}
    bit_equal = got == want
    rec = {"phase": phase, "card": card(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "ranks": mesh.mesh.tolist(),
           "batch": B, "seq": S, "steps": got, "plain_steps": want,
           "bit_equal": bit_equal,
           "sharded_step_ms": [s * 1e3 for s in sharded_s],
           "unsharded_step_ms": [s * 1e3 for s in plain_s],
           "dtensor_host_ms": (sharded_s[-1] - plain_s[-1]) * 1e3,
           "launches": launches, "launches_expected": want_launches}
    rec["ok"] = ((bit_equal or train_agrees(got, want, [0.0] * steps))
                 and launches == want_launches)
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("the sharded steps are not the unsharded ones")


def parallel_moe_cell(dev, mesh) -> None:
    """parallel/moe/deepseek-v2-lite-16b: ``moe_ffn_ep`` and
    ``moe_ffn_a2a`` called on the model axis's process group (one rank:
    every expert is its own; the a2a capacity drops nothing) on the MoE
    layer of deepseek-v2-lite-16b cut to 2 layers at full width, B 1 x
    2048 seeded activations, each held to ``moe_ffn_local`` by
    ``routing_verdict``."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.models.moe import moe_ffn_a2a, moe_ffn_ep, moe_ffn_local

    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b"), n_layers=2)
    layer = M.init(cfg, seed=0, device=dev).blocks[0]
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((1, 2048, cfg.d_model), generator=g, device=dev)
    group = mesh.get_group("model")
    rec = {"phase": "parallel/moe/deepseek-v2-lite-16b", "card": card()}
    ok = True
    with torch.no_grad():
        runs = {}
        for name, body in (("local", lambda: moe_ffn_local(layer, x, cfg)),
                           ("ep", lambda: moe_ffn_ep(layer, x, cfg, group)),
                           ("a2a", lambda: moe_ffn_a2a(layer, x, cfg,
                                                       group))):
            calls = []
            with recording_routes(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = body()
                torch.cuda.synchronize()
            runs[name] = (out, by_position(calls, 1))
            rec[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        want, want_routes = runs["local"]
        for name in ("ep", "a2a"):
            got, routes = runs[name]
            v = routing_verdict(routes, want_routes, got, want, 0)
            v["max_abs_err"] = float((got - want).abs().max())
            rec[name] = v
            ok &= v["ok"]
    del layer
    rec["ok"] = ok
    emit(rec)
    if not ok:
        raise AssertionError("a parallel MoE body is not the local one")


def parallel_decode_cell(dev, mesh) -> None:
    """parallel/decode/smollm-135m: ``decode_step`` with ``flash_decode``
    on the mesh (the cache placed by the context, each step's attention by
    ``flash_decode_gqa``) against the plain decode, full width, B 2, cache
    2048, 8 steps from seeded tokens, each step's logits within 1e-5."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import model as M
    from repro_torch.parallel.sharding import ShardingCtx
    from repro_torch.serve.decode import decode_step
    from repro_torch.serve.kvcache import init_cache

    cfg = get_arch("smollm-135m")
    B, S, steps = PARALLEL_DECODE
    ctx = ShardingCtx(mesh=mesh, flash_decode=True)
    plain = M.init(cfg, seed=0, device=dev)
    sharded = ctx.distribute(M.init(cfg, seed=0, device=dev))
    caches = init_cache(cfg, B, S, device=dev)
    sharded_caches = init_cache(cfg, B, S, device=dev, ctx=ctx)
    g = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, cfg.vocab, (B, steps), generator=g, device=dev)
    errs, ms, plain_ms = [], [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, caches = decode_step(plain, caches, toks[:, i:i + 1], i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        got, sharded_caches = decode_step(sharded, sharded_caches,
                                          toks[:, i:i + 1], i, ctx=ctx)
        got = got.full_tensor()
        torch.cuda.synchronize()
        plain_ms.append((t1 - t0) * 1e3)
        ms.append((time.perf_counter() - t1) * 1e3)
        errs.append(float((got - want).abs().max()))
    del plain, sharded, caches, sharded_caches
    rec = {"phase": "parallel/decode/smollm-135m", "card": card(),
           "batch": B, "cache": S, "max_abs_err": errs,
           "flash_decode_ms": ms, "plain_decode_ms": plain_ms,
           "ok": all(math.isfinite(e) and e <= 1e-5 for e in errs)}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError("flash decode is not the plain decode")


def parallel_refine_cell() -> None:
    """parallel/refine: the tofa placement of ``PARALLEL_REFINE`` through
    a ``TorchBackend`` whose devices are ``["cuda:0", "cuda:0"]`` (the
    candidate stack split in two and refined side by side) against the
    one-device backend, each on a fresh engine: the same placement, the
    reference's hop-bytes, ``sharded_dispatches`` > 0; then one sharded
    ``refine_many`` of 4 candidates of a 64-rank all-to-all guest on the
    implicit 8x8x8 torus, bit-equal to the one-device dispatch, which
    launches ``swap_select`` and ``torus_hop``."""
    import numpy as np
    import torch
    from repro_torch.core import backend, mapping_torch
    from repro_torch.core.engine import PlacementEngine, PlacementRequest
    from repro_torch.core.topology import TorusTopology
    from repro_torch.kernels import reset_launches
    from repro_torch.workloads.patterns import alltoall_heavy, npb_dt_like

    request = PlacementRequest(comm=npb_dt_like(1024, seed=3).comm,
                               topology=TorusTopology((16, 16, 16)))
    one = backend.TorchBackend(device="cuda")
    two = backend.TorchBackend(device="cuda", devices=["cuda:0"] * 2)
    rec = {"phase": "parallel/refine", "card": card(),
           "request": PARALLEL_REFINE}
    plans = {}
    for name, be in (("one", one), ("two", two)):
        with backend.use(be):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans[name] = PlacementEngine(backend=None).place(
                request, policy="tofa", rng=np.random.default_rng(0))
            torch.cuda.synchronize()
            rec[f"{name}_device_s"] = time.perf_counter() - t0
    rec["hop_bytes"] = plans["two"].hop_bytes
    rec["sharded_dispatches"] = two.stats.get("sharded_dispatches", 0)
    same = np.array_equal(plans["one"].placement, plans["two"].placement)
    ok = (same and rec["sharded_dispatches"] > 0
          and plans["one"].hop_bytes == plans["two"].hop_bytes
          == EXPECTED[PARALLEL_REFINE])

    G = alltoall_heavy(64).comm.G_v
    torus = TorusTopology((8, 8, 8))
    D = torus.lazy_distance()
    rng = np.random.default_rng(0)
    P = np.stack([rng.permutation(torus.n_nodes)[:64] for _ in range(4)])
    with backend.use(one):
        single = mapping_torch.refine_many(G, D, P)
    before = two.stats["sharded_dispatches"]
    reset_launches()
    with backend.use(two):
        sharded = mapping_torch.refine_many(G, D, P)
        torch.cuda.synchronize()
    launches = _count_path(("swap_select", "torus_hop"))
    rec.update({"same_placement": same, "refine_launches": launches,
                "refine_bit_equal": bool(np.array_equal(single, sharded))})
    ok &= (rec["refine_bit_equal"] and two.stats["sharded_dispatches"]
           == before + 1 and all(n > 0 for n in launches.values()))
    rec["ok"] = bool(ok)
    emit(rec)
    if not ok:
        raise AssertionError("the sharded refine is not the one-device one")


@contextlib.contextmanager
def nccl_group_of_one():
    """This process as the one rank of an nccl group (a file rendezvous
    under ``build/``), destroyed on exit."""
    import datetime
    import torch.distributed as dist

    store = ROOT / "build" / "chip_smoke_rendezvous"
    store.parent.mkdir(exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        yield
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def parallel_phase(dev) -> None:
    """The parallel cells on an nccl group of its own, destroyed at the
    end, then the sharded refine."""
    from repro_torch.parallel.sharding import make_mesh

    with nccl_group_of_one():
        mesh = make_mesh("cuda", (1, 1))
        for cell in (parallel_train_cell, parallel_moe_cell,
                     parallel_decode_cell):
            t0 = time.perf_counter()
            cell(dev, mesh)
            emit({"phase": f"{cell.__name__}/done",
                  "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    parallel_refine_cell()
    emit({"phase": "parallel_refine_cell/done",
          "s": time.perf_counter() - t0})


# The dry run (repro_torch.launch.dryrun) on the card machine: each cell
# traced on a fake process group of 256 or 512 ranks in a process of its
# own (the group is process-wide), the placement analysis on the card.
DRYRUN_CELLS = (("smollm-135m", "train_4k", "off"),
                ("starcoder2-7b", "train_4k", "off"),
                ("deepseek-v2-lite-16b", "decode_32k", "on"),
                ("llama-3.2-vision-11b", "decode_32k", "off"))
# every model family reduced on a fake 2 x 8 mesh, at a train step, a
# prefill and a decode step (tools/dryrun_families.py), in three processes
# beside the cells: the paths the full cells above do not take
DRYRUN_FAMILY_SPLITS = (
    ("zamba2-7b", "llama-3.2-vision-11b"),
    ("mamba2-2.7b", "smollm-135m", "phi3.5-moe-42b"),
    ("starcoder2-7b", "nemotron-4-340b", "deepseek-v2-lite-16b",
     "minicpm3-4b", "seamless-m4t-large-v2"))
DRYRUN_TIMEOUT_S = 600
DRYRUN_MESH_SEQ = 256
PLACEMENT_KERNELS = ("swap_select", "swap_gain", "torus_hop", "fattree_hop")


def dryrun_cells(device: str) -> list:
    """dryrun/<arch>/<shape>: ``python -m repro_torch.launch.dryrun`` for
    each of ``DRYRUN_CELLS``, side by side, the placement analysis on
    ``device``, each writing its row and guest graph under
    ``chiprun_out/dryrun/``; each row printed with the launches of each
    placement kernel in it by name.  Beside them, dryrun/families: the
    reduced families of ``DRYRUN_FAMILY_SPLITS``, every trace run to its
    end and none over more than a rank's own heads.  Returns the guest
    graphs' paths."""
    import os
    import shutil

    out = OUT_DIR / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    families = []
    for i, archs in enumerate(DRYRUN_FAMILY_SPLITS):
        log = (out / f"families_{i}.log").open("w")
        families.append((out / f"families_{i}.json", log, subprocess.Popen(
            [sys.executable, str(ROOT / "tools" / "dryrun_families.py"),
             "--out", str(out / f"families_{i}.json"), "--archs", *archs],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)))
    runs = []
    for arch, shape, pod in DRYRUN_CELLS:
        tag = f"{arch}__{shape}"
        log = (out / f"{tag}.log").open("w")
        runs.append((arch, shape, out / f"{tag}.jsonl", log, subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--multi-pod", pod, "--out",
             str(out / f"{tag}.jsonl"), "--comm-out", str(out),
             "--device", device],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)))
    t0 = time.perf_counter()
    bad = []
    for arch, shape, rows, log, proc in runs:
        try:
            rc = proc.wait(max(1.0, DRYRUN_TIMEOUT_S
                               - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        log.close()
        row = (json.loads(rows.read_text().splitlines()[-1])
               if rows.exists() else {})
        place = row.get("placement", {})
        ok = (rc == 0 and row.get("ok") is True
              and {"linear", "tofa"} <= set(place)
              and row.get("devices") in (256, 512))
        rec = {"phase": f"dryrun/{arch}/{shape}", "card": card(), "rc": rc,
               "s": time.perf_counter() - t0,
               "launches": row.get("placement_launches"), "row": row}
        if shape == "train_4k":             # the step must fit a card
            ok = ok and row.get("fits_hbm") is True
            rec.update(total_bytes_per_dev=row.get("total_bytes_per_dev"),
                       fits_hbm=row.get("fits_hbm"))
        emit({**rec, "ok": ok})
        if not ok:
            bad.append(f"{arch}/{shape}")
    traces, rcs = {}, []
    for path, log, proc in families:
        try:
            rcs.append(proc.wait(max(1.0, DRYRUN_TIMEOUT_S
                                     - (time.perf_counter() - t0))))
        except subprocess.TimeoutExpired:
            proc.kill()
            rcs.append(proc.wait())
        log.close()
        traces.update(json.loads(path.read_text()) if path.exists() else {})
    failed = sorted(k for k, r in traces.items() if r["error"])
    all_heads = sorted(k for k, r in traces.items() if r["heads"])
    want = sum(map(len, DRYRUN_FAMILY_SPLITS)) * 3
    ok = rcs == [0] * len(rcs) and len(traces) == want \
        and not failed and not all_heads
    emit({"phase": "dryrun/families", "card": card(), "rcs": rcs,
          "s": time.perf_counter() - t0, "traces": len(traces),
          "failed": failed, "all_heads": all_heads, "ok": ok})
    if not ok:
        bad.append("families")
    if bad:
        raise AssertionError(f"dry-run cells failed: {bad} "
                             f"(logs in {out})")
    return sorted(out.glob("*.npz"))


def dryrun_tofa_cell(path, device: str) -> None:
    """dryrun/tofa/<cell>: a dry-run cell's guest graph placed by ``tofa``
    on the H100 fabric by the engine on ``device`` (the card; float64) and
    by the NumPy engine: the same permutation and hop-bytes, bit for
    bit."""
    import numpy as np
    import torch
    from repro_torch.core.comm_graph import CommGraph
    from repro_torch.core.engine import PlacementEngine
    from repro_torch.core.placement import assign_devices
    from repro_torch.kernels import reset_launches
    from repro_torch.launch.roofline import production_fabric

    g = np.load(path)
    comm = CommGraph(g["G_v"].shape[0], g["G_v"], g["G_m"])
    fabric = production_fabric(comm.n)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = assign_devices(comm, fabric,
                             engine=PlacementEngine(device=device),
                             rng=np.random.default_rng(0))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = _count_path(PLACEMENT_KERNELS)
    t0 = time.perf_counter()
    host = assign_devices(comm, fabric,
                          engine=PlacementEngine(backend="numpy"),
                          rng=np.random.default_rng(0))
    same = bool(np.array_equal(on_card.permutation, host.permutation))
    rec = {"phase": f"dryrun/tofa/{path.stem}", "card": card(),
           "n": comm.n, "edges": int((comm.G_v > 0).sum()),
           "hop_bytes_linear": on_card.hop_bytes_linear,
           "hop_bytes_placed": on_card.hop_bytes_placed,
           "numpy_hop_bytes_placed": host.hop_bytes_placed,
           "bit_identical": same, "card_s": card_s,
           "numpy_s": time.perf_counter() - t0, "launches": launches,
           "ok": same and on_card.hop_bytes_placed == host.hop_bytes_placed}
    emit(rec)
    if not rec["ok"]:
        raise AssertionError(f"{rec['phase']}: the card's placement is not "
                             f"the NumPy engine's")


def dryrun_mesh_cell(dev) -> None:
    """dryrun/tofa-mesh: at world size 1 on an nccl group, the smollm-135m
    train step profiled on fake CPU tensors at B 2 x ``DRYRUN_MESH_SEQ``
    (one rank runs no collective at any length; the short trace keeps the
    phase short), ``make_tofa_mesh`` on that profile for a 1 x 1 mesh on
    the card, and one ``parallel_train_cell`` step on the mesh it
    builds."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.profiler import fake_mode, profile_torch
    from repro_torch.launch.mesh import make_tofa_mesh
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    cfg = get_arch("smollm-135m")
    B, S = PARALLEL_TRAIN_B, DRYRUN_MESH_SEQ
    t0 = time.perf_counter()
    with fake_mode():
        model = M.Transformer(cfg, device="cpu")
        opt = AdamW(**TRAIN_OPT)
        toks = torch.zeros((B, S), dtype=torch.int32)
        args = (model, opt.init(model), {"tokens": toks, "labels": toks})
    prof = profile_torch(make_train_step(cfg, opt), *args)
    trace_s = time.perf_counter() - t0
    with nccl_group_of_one():
        mesh, assignment = make_tofa_mesh(
            prof, shape=(1, 1), axes=("data", "model"), device=dev,
            device_type=dev.type)
        ok = (mesh.mesh.tolist() == [[0]]
              and assignment.permutation.tolist() == [0])
        emit({"phase": "dryrun/tofa-mesh", "card": card(),
              "trace_s": trace_s, "flops": prof.flops,
              "collectives": len(prof.collectives),
              "permutation": assignment.permutation.tolist(),
              "ranks": mesh.mesh.tolist(), "ok": ok})
        if not ok:
            raise AssertionError("make_tofa_mesh built another mesh")
        parallel_train_cell(dev, mesh, steps=1,
                            phase="dryrun/tofa-mesh/train/smollm-135m")


def dryrun_phase(dev) -> None:
    """The dry-run cells, TOFA on their guest graphs held to the NumPy
    engine, and a TOFA mesh at world size 1."""
    for path in dryrun_cells(dev.type):
        t0 = time.perf_counter()
        dryrun_tofa_cell(path, dev.type)
        emit({"phase": f"dryrun/tofa/{path.stem}/done",
              "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    dryrun_mesh_cell(dev)
    emit({"phase": "dryrun/tofa-mesh/done", "s": time.perf_counter() - t0})


# -------------------------------------------------------------------- main
def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    OUT_DIR.mkdir(exist_ok=True)
    LOG.write_text("")
    (OUT_DIR / "launch_shapes.json").unlink(missing_ok=True)
    (OUT_DIR / "ptxas.txt").write_text("".join(
        f"== {name}\n{log}\n" for name, log in _build.BUILD_LOGS.items()))
    emit({"phase": "build", "s": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values())})
    emit({"phase": "build/ptxas",
          "instances": ptxas_report(_build.BUILD_LOGS)})
    emit({"phase": "build/flash_resources",
          "instances": flash_resources()})
    emit({"phase": "build/flash_bwd_resources",
          "instances": flash_bwd_resources()})

    failed = []
    try:
        t0 = time.perf_counter()
        kernel_phase(dev)
        emit({"phase": "kernels/done", "s": time.perf_counter() - t0,
              "checked": ["swap_select", "torus_hop", "fattree_hop"]})
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels")
    model_recs = {}
    try:
        t0 = time.perf_counter()
        model_recs = model_kernel_phase(dev)
        entry_point_phase(dev)
        emit({"phase": "kernels/model/done", "s": time.perf_counter() - t0})
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels/model")
    torch.cuda.empty_cache()
    try:
        model, toks, fwd_logits = model_phase(dev)
        decode_phase(model, toks, fwd_logits)
        del model, toks, fwd_logits
        torch.cuda.empty_cache()
        serve_phase()
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("model")
    torch.cuda.empty_cache()
    for arch, kw in (
            ("starcoder2-7b", dict()),
            # one layer at full width; no serve step: the driver would
            # build all 96 layers
            ("nemotron-4-340b", dict(depth=1, serve=False, tag="-L1")),
            ("mamba2-2.7b", dict(cut=(dict(n_layers=2), 2, 256,
                                      MAMBA2_HELD_POSITIONS,
                                      EXPECTED_MAMBA2))),
            ("zamba2-7b", dict(cut=(dict(n_layers=7), 2, 256,
                                    ZAMBA2_HELD_POSITIONS,
                                    EXPECTED_ZAMBA2))),
            ("minicpm3-4b", dict(cut=(dict(n_layers=2), 1, 2048,
                                      MINICPM3_HELD_POSITIONS,
                                      EXPECTED_MINICPM3))),
            ("deepseek-v2-lite-16b", dict(cut=(dict(n_layers=2), 1, 2048,
                                               DSV2_HELD_POSITIONS,
                                               EXPECTED_DSV2))),
            # no serve step: the driver would build all 32 layers
            ("phi3.5-moe-42b", dict(depth=PHI35_DEPTH, serve=False)),
            ("llama-3.2-vision-11b", dict(cut=(dict(n_layers=5), 1, 2048,
                                               VLM_HELD_POSITIONS,
                                               EXPECTED_VLM),
                                          held_depth=VLM_HELD_DEPTH)),
            ("seamless-m4t-large-v2", dict(cut=(
                dict(n_enc_layers=2, n_layers=2), 1, 2048,
                SEAMLESS_HELD_POSITIONS, EXPECTED_SEAMLESS)))):
        t0 = time.perf_counter()
        try:
            model_family_phase(dev, arch, **kw)
        except Exception:                   # reported, and the run fails
            traceback.print_exc()
            failed.append(arch)
        torch.cuda.empty_cache()
        emit({"phase": f"model/{arch}/done", "s": time.perf_counter() - t0})
    try:
        t0 = time.perf_counter()
        model_recs.update(backward_kernel_phase(dev))
        emit({"phase": "kernel/backward/done", "s": time.perf_counter() - t0})
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernel/backward")
    torch.cuda.empty_cache()
    for name, phase in TRAIN_PHASES:
        t0 = time.perf_counter()
        try:
            phase(dev)
        except Exception:                   # reported, and the run fails
            traceback.print_exc()
            failed.append(f"train/{name}")
        torch.cuda.empty_cache()
        emit({"phase": f"train/{name}/done", "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    try:
        parallel_phase(dev)
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("parallel")
    torch.cuda.empty_cache()
    emit({"phase": "parallel/done", "s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    try:
        dryrun_phase(dev)
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("dryrun")
    torch.cuda.empty_cache()
    emit({"phase": "dryrun/done", "s": time.perf_counter() - t0})
    for run in placement_phases():
        try:
            run()
        except Exception:                   # reported, and the run fails
            traceback.print_exc()
            failed.append("place")
    try:
        paper_phase("cuda")
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("paper")
    t0 = time.perf_counter()
    for name, cell in SERVICE_CELLS:
        try:
            cell("cuda")
        except Exception:                   # reported, and the run fails
            traceback.print_exc()
            failed.append(f"service/{name}")
    emit({"phase": "service/done", "s": time.perf_counter() - t0})
    for name, n in MAIN_PATH_LAUNCHES.items():
        if n == 0:
            failed.append(f"{name} never launched on the main path")
    records = {}
    try:
        records = main_shape_phase(dev)
    except Exception:                       # reported, and the run fails
        traceback.print_exc()
        failed.append("kernels/main-shape")

    emit({"phase": "total", "s": time.perf_counter() - t_start})
    summary = []
    for name, meta in KERNELS.items():
        rec = records.get(name) or main_shape_record(model_recs, name)
        summary.append({"name": name, "route": "cuda", **meta,
                        "launches": MAIN_PATH_LAUNCHES[name],
                        # the timed record's shape where it has one (the
                        # backward kernels'), else the path's largest
                        "shape": rec.get("shape", MAIN_PATH_SHAPES[name]),
                        "max_abs_err": rec.get("max_abs_err"),
                        "ms": rec.get("ms"), "host_ms": rec.get("host_ms"),
                        "plain_ms": rec.get("plain_ms"),
                        "bound_ms": rec.get("bound_ms"),
                        "bound_by": rec.get("bound_by"),
                        **{k: rec[k] for k in ("bound_tc_ms",
                                               "bound_cuda_core_ms")
                           if k in rec},
                        "library_ms": rec.get("library_ms")})
    emit({"kernels": summary})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        failed.append("nvidia-smi")
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: no output", flush=True)
    if failed:
        print(f"chip_smoke: FAILED: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
