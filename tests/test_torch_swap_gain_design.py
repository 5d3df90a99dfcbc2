"""The gains-row kernel's map of ``swap_select.cu``, replayed on the CPU.

The CUDA source cannot be compiled or run here, so its launcher's choices
(the rows R a block, the grid, the 16-byte path or the one-value path from
n and the operands' addresses) and its kernel's walk (a thread's loads of
the mover's rows and of its block's R rows, U loads at a time; one sum a
row; the warp butterflies; the warps' partials through shared memory; one
store a row) are replayed in NumPy, with the constants read from the source.  Over ragged n, both
dtypes, aligned and unaligned operands and several SM counts, the replay
asserts that every output is written exactly once, that no read falls
outside M, G, ``contrib``, the mover index or the shared partials (and
none of those before it was written), that every 16-byte load is
aligned, and that the values equal ``swap_gain_ref``: exactly on
integer-valued inputs, within the reference's tolerances (f32 2e-5, f64
1e-12 of the row's largest magnitude) on real-valued ones.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.swap_gain.ref import swap_gain_ref

SOURCE = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "kernels" / "swap_gain" / "swap_select.cu").read_text()


def _constant(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


THREADS = _constant("kGainThreads")
MAX_ROWS = _constant("kGainMaxRows")
MIN_BLOCKS_PER_SM = _constant("kGainMinBlocksPerSM")
LOADS = _constant("kGainLoads")
WARPS = THREADS // 32
TOL = {np.float32: 2e-5, np.float64: 1e-12}
# byte addresses of the two operands in the replay's memory: far apart,
# each on a 256-byte boundary before its offset
M_BASE, G_BASE = 1 << 20, 1 << 34


def plan(n, size, m_addr, g_addr, sms):
    """``launch_gain`` of swap_select.cu: rows a block, the grid, values a
    load, loads of a row a thread has in flight at once."""
    R = MAX_ROWS
    while R > 1 and -(-n // R) < MIN_BLOCKS_PER_SM * sms:
        R //= 2
    vw = 16 // size
    if not (n % vw == 0 and m_addr % 16 == 0 and g_addr % 16 == 0):
        vw = 1
    return dict(R=R, blocks=-(-n // R), vw=vw,
                U=1 if R == 1 else max(1, LOADS // (2 * (R + 1))))


def _butterfly(x):
    """warp_sum over the last axis (32 lanes): every lane ends with the
    warp's sum, added in the butterfly's order."""
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        x = x + x[..., lane ^ off]
    return x


def replay(M, G, contrib, i, sms, offsets=(0, 0)):
    """Run the launcher's kernel over its grid with M and G ``offsets``
    values past a 16-byte boundary; returns (out, writes, plan)."""
    n = M.shape[0]
    dt = M.dtype.type
    size = M.dtype.itemsize
    m_addr, g_addr = M_BASE + offsets[0] * size, G_BASE + offsets[1] * size
    p = plan(n, size, m_addr, g_addr, sms)
    assert 0 <= i < n                            # the mover index, iv[0]
    R, U, vw, B = p["R"], p["U"], p["vw"], p["blocks"]
    nv = n // vw
    assert nv * vw == n
    Mf, Gf = M.reshape(-1), G.reshape(-1)
    rows_in = np.arange(B)[:, None] * R + np.arange(R)   # (B, R)
    live = rows_in < n
    rows = np.where(live, rows_in, n - 1)        # past n: row n - 1 again
    t = np.arange(THREADS)
    e = np.arange(vw)

    def load(flat, addr, row, v):
        """One load a thread of ``vw`` values at vector ``v`` of ``row``:
        in bounds, aligned to its width."""
        first = row * n + v * vw                 # element index
        assert first.min() >= 0 and (first + vw).max() <= n * n
        assert np.all((addr + first * size) % (vw * size) == 0)
        return flat[first[..., None] + e]

    acc = np.zeros((B, THREADS, R), dt)
    for v0 in range(0, nv, U * THREADS):
        mi, gi, m, g = [], [], [], []
        for u in range(U):
            v = v0 + u * THREADS + t             # (T,)
            on = v < nv
            vs = np.where(on, v, 0)
            zero = lambda x: np.where(on[..., None], x, dt(0))
            mi.append(zero(load(Mf, m_addr, np.int64(i), vs)))
            gi.append(zero(load(Gf, g_addr, np.int64(i), vs)))
            rv = (rows[:, None, :], vs[None, :, None])       # (B, T, R)
            m.append(np.where(on[None, :, None, None],
                              load(Mf, m_addr, *rv), dt(0)))
            g.append(np.where(on[None, :, None, None],
                              load(Gf, g_addr, *rv), dt(0)))
        for u in range(U):
            for k in range(R):
                for j in range(vw):              # dot_acc: in order
                    acc[:, :, k] += m[u][:, :, k, j] * gi[u][None, :, j]
                for j in range(vw):
                    acc[:, :, k] += g[u][:, :, k, j] * mi[u][None, :, j]
    x = _butterfly(acc.reshape(B, WARPS, 32, R).transpose(0, 1, 3, 2))
    part = np.full((B, WARPS, R), np.nan, dt)
    part[:, :, :] = x[:, :, :, 0]                # lane 0 of each warp
    # after the barrier thread k < R sums row k's partials, w = 0 .. W-1
    assert not np.isnan(part).any()
    s = part[:, 0, :].copy()
    for w in range(1, WARPS):
        s = s + part[:, w, :]
    out = np.full(n + 8, np.nan, dt)            # 4 guard values each side
    writes = np.zeros(n + 8, np.int64)
    c = rows_in[live]
    assert c.max() < n and c.min() >= 0
    mic = Mf[i * n + c]
    gic = Gf[i * n + c]
    out[4 + c] = (contrib[i] + contrib[c] - dt(2) * gic * mic) - s[live]
    np.add.at(writes, 4 + c, 1)
    return out, writes, p


@functools.lru_cache(maxsize=4)
def _case(n, integer, dtype):
    """Inputs (seeded by n) and ``swap_gain_ref``'s row for each mover."""
    rng = np.random.default_rng(n)
    if integer:
        A = rng.integers(0, 7, (n, n)).astype(np.float64)
        S = (rng.integers(0, 5, (n, n))
             * (rng.random((n, n)) < 0.3)).astype(np.float64)
    else:
        A, S = rng.random((n, n)), rng.random((n, n)) * (
            rng.random((n, n)) < 0.2)
    M, G = (A + A.T).astype(dtype), (S + S.T).astype(dtype)
    contrib = (G * M).sum(1, dtype=dtype)
    want = {i: swap_gain_ref(torch.from_numpy(M)[None], torch.from_numpy(G),
                             torch.from_numpy(contrib)[None],
                             torch.tensor([i]))[0].numpy()
            for i in sorted({0, n // 3, n - 1})}
    return M, G, contrib, want


NS = [1, 2, 3, 5, 8, 33, 64, 128, 129, 200, 257, 1023, 1024, 1025]


@pytest.mark.parametrize("sms", [132, 3, 1])
@pytest.mark.parametrize("offsets", [(0, 0), (1, 0), (0, 1)])
@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", NS)
def test_every_entry_written_once_with_its_value(n, dtype, integer,
                                                 offsets, sms):
    M, G, contrib, wants = _case(n, integer, dtype)
    tol = TOL[dtype]
    for i, want in wants.items():
        out, writes, p = replay(M, G, contrib, i, sms, offsets)
        assert np.all(writes[4:4 + n] == 1), p
        assert not writes[:4].any() and not writes[4 + n:].any()
        got = out[4:4 + n]
        if integer:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=tol,
                                       atol=tol * np.abs(want).max())


@pytest.mark.parametrize("n", [1, 3, 33, 128, 129, 1023, 1024, 1025, 4096,
                               100000])
@pytest.mark.parametrize("size", [4, 8])
def test_the_launcher_fills_the_card(n, size):
    """At the path's shapes and at extremes: R halves until the grid gives
    every SM its blocks (or R is 1), every row has its block, and the
    16-byte path is taken exactly when n and both operands allow it."""
    p = plan(n, size, M_BASE, G_BASE, 132)
    assert p["R"] == 1 or p["blocks"] >= MIN_BLOCKS_PER_SM * 132
    assert p["R"] == MAX_ROWS or -(-n // (2 * p["R"])) < \
        MIN_BLOCKS_PER_SM * 132
    assert p["blocks"] * p["R"] >= n > (p["blocks"] - 1) * p["R"]
    assert p["vw"] == (16 // size if n % (16 // size) == 0 else 1)
    assert plan(n, size, M_BASE + size, G_BASE, 132)["vw"] == 1
    assert plan(n, size, M_BASE, G_BASE + size, 132)["vw"] == 1
    # a thread's loads in flight stay within the budget, or one a row
    assert 2 * p["U"] * (p["R"] + 1) <= max(LOADS, 2 * (p["R"] + 1))
    if n == 1024:
        assert p["blocks"] >= MIN_BLOCKS_PER_SM * 132
    if n == 4096:
        assert p["R"] == MAX_ROWS

