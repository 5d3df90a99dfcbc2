"""The hop kernels' map of ``hop_dist.cu``, replayed on the CPU.

The CUDA source cannot be compiled or run here, so its launcher's choices
(the tile of TX columns by TY rows, the rows R a thread, the grid) and its
kernel's walk (a block's tile, the tile's row coordinates staged in shared
memory where a thread has more than one row, a thread's column and rows,
one store a row) are replayed in NumPy, with the constants read from the
source.  Over ragged shapes and several SM counts, the replay asserts that
every output element is written exactly once, that nothing outside the
output is written or read outside the coordinate tables or the staging
buffer, and that the values equal ``torus_hop_pairs_np`` /
``fattree_hop_pairs_np``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from repro_torch.kernels.hop_dist.ops import (fattree_hop_np,
                                              fattree_hop_pairs_np,
                                              torus_hop_np,
                                              torus_hop_pairs_np)

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "hop_dist" / "hop_dist.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


BLOCK = _constant("kBlock")
LOG2_BLOCK = _constant("kLog2Block")
ROWS = _constant("kRows")
MAX_TILE_ROWS = _constant("kMaxTileRows")
MIN_BLOCKS_PER_SM = _constant("kMinBlocksPerSM")
MAX_GRID_YZ = _constant("kMaxGridYZ")


def plan(B, m, k, sms):
    """``launch`` of hop_dist.cu: the tile, the rows a thread, the grid."""
    log2tx = 0
    while log2tx < LOG2_BLOCK and (1 << log2tx) < k:
        log2tx += 1
    ty = BLOCK >> log2tx
    nct = -(-k // (1 << log2tx))
    R = ROWS
    while R > 1 and ty * R > MAX_TILE_ROWS:
        R //= 2
    while True:
        nrt = -(-m // (ty * R))
        if R == 1 or B * nrt * nct >= MIN_BLOCKS_PER_SM * sms:
            break
        R //= 2
    return dict(log2tx=log2tx, ty=ty, nct=nct, nrt=nrt, R=R,
                grid=(nct, nrt, B))


def replay(cu, cv, metric, sms, out_offset=3):
    """Run ``hop_kernel`` over its grid of (column tiles, row tiles, B)
    blocks; returns (memory, writes, plan), the output ``out_offset``
    elements into ``memory``."""
    B, m, nd = cu.shape
    k = cv.shape[1]
    p = plan(B, m, k, sms)
    R, ty_n = p["R"], p["ty"]
    mem = np.full(out_offset + B * m * k + 16, np.nan)
    writes = np.zeros(mem.shape, dtype=np.int64)
    lane = np.arange(BLOCK)
    tx, ty = lane & ((1 << p["log2tx"]) - 1), lane >> p["log2tx"]
    for ct, rt, b in np.ndindex(*p["grid"]):
        r0 = rt * ty_n * R
        first_row = (b * m + r0) * nd
        if R > 1:                           # staged: inside cu and the
            n = min(ty_n * R, m - r0) * nd  # buffer of TY * R rows
            assert 0 < n <= min(ty_n * R, MAX_TILE_ROWS) * nd
            assert first_row + n <= cu.size
        c = (ct << p["log2tx"]) + tx
        live = c < k
        c, tyl = c[live], ty[live]
        assert c.size == 0 or ((b * k + c.max()) * nd + nd <= cv.size)
        # a thread's trip count: its rows below R * TY and m - r0
        mine = (m - r0 - tyl + ty_n - 1) >> (LOG2_BLOCK - p["log2tx"])
        n = np.minimum(mine, R)
        for i in range(R):
            on = i < n
            lr = tyl[on] + i * ty_n
            assert np.all(r0 + lr < m)
            assert np.all(first_row + lr * nd + nd <= cu.size)
            addr = out_offset + (b * m + r0 + lr) * k + c[on]
            np.add.at(writes, addr, 1)
            mem[addr] = metric(cu[b, r0 + lr], cv[b, c[on]])
    return mem, writes, p


SHAPES = [(1, 1, 1), (2, 3, 1), (1, 5, 2), (3, 7, 3), (2, 1, 37), (1, 9, 6),
          (2, 30, 10), (1, 2, 256), (4, 3, 130), (1, 4, 4), (1, 8, 8),
          (1, 17, 17), (2, 64, 64), (1, 33, 129), (3, 50, 44),
          (1, 300, 1), (2, 40, 200)]


@pytest.mark.parametrize("sms", [132, 3, 1])
@pytest.mark.parametrize("kind", ["torus", "fattree"])
@pytest.mark.parametrize("B,m,k", SHAPES)
def test_every_element_written_once_with_its_value(B, m, k, kind, sms):
    rng = np.random.default_rng(B * 1000 + m * 37 + k)
    ext = (5, 7, 4) if kind == "torus" else (2, 3, 2)
    cu, cv = (np.stack([rng.integers(0, e, (B, n)) for e in ext], -1)
              for n in (m, k))
    if kind == "torus":
        metric = lambda u, v: torus_hop_np(u, v, ext)
        want = np.stack([torus_hop_pairs_np(cu[b], cv[b], ext)
                         for b in range(B)])
    else:
        metric = fattree_hop_np
        want = np.stack([fattree_hop_pairs_np(cu[b], cv[b])
                         for b in range(B)])
    mem, writes, p = replay(cu, cv, metric, sms)
    out = slice(3, 3 + B * m * k)
    assert np.all(writes[out] == 1), p
    assert not writes[:out.start].any() and not writes[out.stop:].any()
    np.testing.assert_array_equal(mem[out].reshape(B, m, k), want)


@pytest.mark.parametrize("B,m,k", [(2, 512, 512), (1, 4, 4), (1, 8, 8),
                                   (1, 16, 16), (1, 37, 37),
                                   (2, 1024, 1024), (16, 1024, 1024),
                                   (1, 100000, 1), (64, 4096, 3)])
def test_the_launcher_fills_the_card(B, m, k):
    """At the path's shapes and at extremes: a block an SM or one row a
    thread already, a staging buffer within its bound, no row or column
    left out, and the chunk refines' shapes on the unstaged R = 1."""
    p = plan(B, m, k, 132)
    blocks = np.prod(p["grid"])
    assert p["R"] == 1 or blocks >= MIN_BLOCKS_PER_SM * 132
    assert max(p["grid"][1:]) <= MAX_GRID_YZ
    assert p["ty"] * p["R"] <= max(MAX_TILE_ROWS, p["ty"])
    assert p["nrt"] * p["ty"] * p["R"] >= m
    assert p["nct"] * (1 << p["log2tx"]) >= k
    if m * k <= 16 * 16:
        assert p["R"] == 1
    if (B, m, k) == (2, 512, 512):
        assert p["R"] == ROWS and blocks == 256


def test_the_torus_identity_is_exact():
    """min(x, D - x) = D/2 - |x - D/2| for every distance x a coordinate
    pair can have, even and odd D, in float32 and float64: what lets the
    kernel sum three adds a dimension and still equal the plain version
    bit for bit."""
    for dt in (np.float32, np.float64):
        for D in range(1, 40):
            x = np.arange(0, D + 1, dtype=dt)
            half = dt(D) / dt(2)
            np.testing.assert_array_equal(np.minimum(x, dt(D) - x),
                                          half - np.abs(x - half))
