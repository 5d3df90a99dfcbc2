"""ssd_scan — the Mamba2 SSD entry point, dispatched by tensor device (see
:mod:`repro_torch.kernels` for ``impl``).

:func:`ssd_scan` takes the model's layout, folds ``dt`` into ``xdt = x *
dt`` and ``dA = dt * A`` as the reference's entry point does, and runs the
CUDA kernel (``ssd_scan.cu``) for tensors on a GPU and the chunked
algorithm (:func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_folded`,
the reference model's own arithmetic) for tensors on the CPU.
:func:`ssd_scan_kernel` is the same entry point on the kernel's layout.
For inputs that require grad (with grad enabled) the GPU path goes through
:class:`_SSDScan`, an ``autograd.Function`` whose backward launches the
backward kernels (``ssd_scan_bwd.cu``, on the tensor cores: bfloat16
``mma.sync`` in bfloat16, 3xTF32 in float32): each tile's own state and
state gradient, the passes that turn them into the state entering and the
gradient of the state leaving each tile (the states recomputed from the
inputs in their own type), the tile gradients with a group's heads four to
a block, and the group sums.  Their bound at mamba2-2.7b's B 2 x 2048:
in float32 operations, 28.7 GFLOP, 0.174 ms as 3xTF32; in bfloat16 its
0.041 ms of bytes (the operations 0.029 ms).  The float32 scratch they
stream (the states twice
and the blocks' dB and dC partials, about 1.5 GB there) floors them near
0.45 ms in both types.  The tile-gradient launch takes 153.5 KB of shared
memory a block at mamba2's widths in float32 (105.5 KB in bfloat16, and
at zamba2's in float32, where two blocks share an SM).  The TPU kernel has
no backward; the reference trains through its plain ``ssd_chunked``,
which is what the CPU path here differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build, count_launch, launch, tagged, use_kernel
from .ref import ssd_chunked_folded

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
# the largest head dim (P) and state size (N) the kernel takes
MAX_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    if not hasattr(lib, "_typed"):
        for name in ("ssd_scan_f32", "ssd_scan_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 7 + [_I64] * 7 + [ctypes.c_int, _P]
            fn.restype = ctypes.c_int
        lib.ssd_scan_workspace_floats.argtypes = [_I64] * 6
        lib.ssd_scan_workspace_floats.restype = _I64
        lib._typed = True
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan_bwd")
    if not hasattr(lib, "_typed"):
        for name in ("ssd_scan_bwd_f32", "ssd_scan_bwd_bf16"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 11 + [_I64] * 7 + [_P]
            fn.restype = ctypes.c_int
        lib.ssd_scan_bwd_scratch_floats.argtypes = [_I64] * 7
        lib.ssd_scan_bwd_scratch_floats.restype = _I64
        lib._typed = True
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             impl: str = "auto"):
    """Model layout: x (B, S, H, P), dt (B, S, H), A (H,), B/C (B, S, G, N)
    -> y (B, S, H, P) in x's dtype, final_state (B, H, P, N) float32.

    ``chunk`` is capped at S, as the reference's kernel caps it; S must be
    a multiple of it (``ValueError`` otherwise)."""
    xdt = (x * dt[..., None]).transpose(1, 2).contiguous()  # (B, H, S, P)
    dA = (dt * A).transpose(1, 2).contiguous()              # (B, H, S)
    y, st = ssd_scan_kernel(xdt, dA, B.transpose(1, 2).contiguous(),
                            C.transpose(1, 2).contiguous(), chunk=chunk,
                            impl=impl)
    return y.transpose(1, 2), st


def ssd_scan_kernel(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, chunk: int = 128,
                    impl: str = "auto"):
    """Kernel layout: xdt (B, H, S, P), dA (B, H, S), B/C (B, G, S, N),
    contiguous -> y (B, H, S, P) in xdt's dtype, final_state (B, H, P, N)
    float32.

    xdt, B and C share float32 or bfloat16; dA is float32 or their dtype
    (read as float32 either way).  On the CPU, or with ``impl="ref"``, it
    runs :func:`~repro_torch.kernels.ssd_scan.ref.ssd_chunked_folded`."""
    chunk = min(chunk, xdt.shape[2])
    if not use_kernel(impl, xdt):
        return tagged("ssd", ssd_chunked_folded, xdt, dA, B, C, chunk)
    _check(xdt, dA, B, C, chunk)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (xdt, dA, B, C)):
        return _SSDScan.apply(xdt, dA, B, C, chunk)
    return _forward(xdt, dA, B, C, chunk)


def _forward(xdt, dA, B, C, chunk: int):
    """The scan's three launches on checked inputs: (y, final state)."""
    y, st, _ = _run(xdt, dA, B, C, chunk, stages=3)
    b, H, S, P = xdt.shape
    count_launch("ssd_scan", (b, H, B.shape[1], S, P, B.shape[3], chunk))
    return y, st


def _backward(xdt, dA, B, C, dy, dst, chunk: int):
    """The backward on the forward's inputs, y's gradient ``dy`` and the
    final state's ``dst`` (or None): four launches that recompute the
    states entering each tile from the inputs in their own type and form
    the gradients.  Returns (dxdt, ddA, dB, dC) in the inputs' dtypes."""
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    dy = torch.zeros_like(xdt) if dy is None else \
        dy.to(xdt.dtype).contiguous()
    gT = None if dst is None else dst.float().contiguous()
    # the kernels read the inputs in 16-byte pieces: a view that starts off
    # a 16-byte boundary is copied to fresh memory first
    xdt, B, C, dy = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (xdt, B, C, dy))
    lib = _bwd_lib()
    scratch = torch.empty(lib.ssd_scan_bwd_scratch_floats(b, H, G, S, P, N,
                                                          chunk),
                          dtype=torch.float32, device=xdt.device)
    dxdt, dB, dC = torch.empty_like(xdt), torch.empty_like(B), \
        torch.empty_like(C)
    ddA = torch.empty((b, H, S), dtype=torch.float32, device=xdt.device)
    fn = (lib.ssd_scan_bwd_f32 if xdt.dtype == torch.float32
          else lib.ssd_scan_bwd_bf16)
    dA32 = dA.float()                # exact for a bfloat16 dA
    launch(lib, fn, "ssd_scan_bwd", xdt.device, xdt.data_ptr(),
           dA32.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
           0 if gT is None else gT.data_ptr(), scratch.data_ptr(),
           dxdt.data_ptr(), ddA.data_ptr(), dB.data_ptr(), dC.data_ptr(), b,
           H, G, S, P, N, chunk)
    count_launch("ssd_scan_bwd", (b, H, G, S, P, N, chunk))
    return dxdt, ddA.to(dA.dtype), dB, dC


class _SSDScan(torch.autograd.Function):
    """The scan's forward, keeping only its inputs (xdt, dA, B, C): the
    backward recomputes the states entering each tile rather than keep the
    forward's workspace (168 MB a layer at mamba2-2.7b's B 2 x 2048).  The
    gradients of y and of the final state may each be None; ``chunk`` gets
    no gradient."""

    @staticmethod
    def forward(ctx, xdt, dA, B, C, chunk):
        ctx.set_materialize_grads(False)
        y, st = _forward(xdt, dA, B, C, chunk)
        ctx.save_for_backward(xdt, dA, B, C)
        ctx.chunk = chunk
        return y, st

    @staticmethod
    def backward(ctx, dy, dst):
        xdt, dA, B, C = ctx.saved_tensors
        return (*_backward(xdt, dA, B, C, dy, dst, ctx.chunk), None)


def _check(xdt, dA, B, C, chunk: int) -> None:
    """Raise on inputs the kernel does not take."""
    if xdt.ndim != 4 or dA.ndim != 3 or B.ndim != 4 or C.shape != B.shape:
        raise ValueError(f"xdt must be (B, H, S, P), dA (B, H, S) and B, C "
                         f"(B, G, S, N), got {tuple(xdt.shape)}, "
                         f"{tuple(dA.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    if dA.shape != (b, H, S) or B.shape[0] != b or B.shape[2] != S:
        raise ValueError(f"dA {tuple(dA.shape)} and B {tuple(B.shape)} do "
                         f"not fit xdt {tuple(xdt.shape)}")
    if G == 0 or H % G:
        raise ValueError(f"the groups G = {G} must divide the heads H = {H}")
    if not (1 <= P <= MAX_DIM and 1 <= N <= MAX_DIM):
        raise ValueError(f"the kernel takes head dim P and state N from 1 "
                         f"to {MAX_DIM}, got P = {P}, N = {N}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"seq {S} not divisible by chunk {chunk}")
    if xdt.dtype not in (torch.float32, torch.bfloat16) \
            or B.dtype != xdt.dtype or C.dtype != xdt.dtype \
            or dA.dtype not in (torch.float32, xdt.dtype):
        raise TypeError(f"xdt, B, C must share float32|bfloat16 and dA be "
                        f"float32 or theirs, got {xdt.dtype}, {B.dtype}, "
                        f"{C.dtype}, {dA.dtype}")
    if any(t.device != xdt.device for t in (dA, B, C)):
        raise ValueError(f"xdt, dA, B, C on {xdt.device}, {dA.device}, "
                         f"{B.device}, {C.device}")
    if not all(t.is_contiguous() for t in (xdt, dA, B, C)):
        raise ValueError("the kernel takes contiguous xdt, dA, B, C")


def _run(xdt, dA, B, C, chunk: int, stages: int):
    """Launch the kernel's first ``stages`` stages on checked inputs;
    (y, final state, workspace)."""
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    dA = dA.float()                  # exact for a bfloat16 dA
    # the kernel reads xdt, B and C in 8- and 16-byte pieces: a view that
    # starts off a 16-byte boundary is copied to fresh memory first
    xdt, B, C = (t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (xdt, B, C))
    y = torch.empty_like(xdt)
    st = torch.empty((b, H, P, N), dtype=torch.float32, device=xdt.device)
    lib = _lib()
    ws = torch.empty(workspace_bytes(b, H, S, P, N, chunk) // 4,
                     dtype=torch.float32, device=xdt.device)
    fn = lib.ssd_scan_f32 if xdt.dtype == torch.float32 else lib.ssd_scan_bf16
    launch(lib, fn, "ssd_scan", xdt.device, xdt.data_ptr(), dA.data_ptr(),
           B.data_ptr(), C.data_ptr(), y.data_ptr(), st.data_ptr(),
           ws.data_ptr(), b, H, G, S, P, N, chunk, stages)
    return y, st, ws


def workspace_bytes(b: int, H: int, S: int, P: int, N: int,
                    chunk: int) -> int:
    """Bytes of float32 scratch the kernel takes at this shape (the
    per-tile states and decays), which the wrapper allocates."""
    return 4 * _lib().ssd_scan_workspace_floats(b, H, S, P, N, min(chunk, S))


def ssd_scan_stages(xdt: torch.Tensor, dA: torch.Tensor, B: torch.Tensor,
                    C: torch.Tensor, *, chunk: int = 128) -> dict:
    """The kernel's intermediates, for tests on the card: stage 1 alone
    (``chunk_states``, each tile's own state, and ``decays``, exp of its
    summed dA), then stages 1 and 2 (``passed_states``, the state entering
    each tile, and ``final_state``).  States are (B, H, tiles, P, N)
    float32 over tiles of min(chunk, 64) rows.  Counts no launch: this is
    not the entry point."""
    use_kernel("kernel", xdt)          # raises for tensors off the card
    chunk = min(chunk, xdt.shape[2])
    _check(xdt, dA, B, C, chunk)
    b, H, S, P = xdt.shape
    N = B.shape[3]
    out = {}
    for stages in (1, 2):
        _, st, ws = _run(xdt, dA, B, C, chunk, stages)
        nT = ws.numel() // (b * H * (N * P + 1))
        states = ws[:b * H * nT * N * P].view(b, H, nT, N, P)
        states = states.transpose(-1, -2)
        if stages == 1:
            out["chunk_states"] = states
            out["decays"] = ws[b * H * nT * N * P:].view(b, H, nT)
        else:
            out["passed_states"] = states
            out["final_state"] = st
    return out
