"""The port's SSM stack (mamba2) against the reference's, on the CPU.

The SSD scan's plain versions — the exact recurrence ``ssd_scan_ref`` and
the chunked algorithm ``ssd_chunked`` — are held to the reference's Pallas
kernel in interpret mode and to its own oracle at the reference's
kernel-test shapes and tolerances (5e-5 in float32, 5e-2 in bfloat16).
The mamba2 schema and caches must equal the reference's; the forward,
the decode steps and the greedy ids are held to the reference's on the
same parameters (its own ``init`` carried over with
``interop.model_params``, or ``interop.seeded_params`` at full width) in
float32 within atol = rtol = 1e-4.  Inputs are made with NumPy from a
seed.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.kernels.ssd_scan import ops as ref_ops  # noqa: E402
from repro.kernels.ssd_scan.kernel import ssd_scan_tpu  # noqa: E402
from repro.kernels.ssd_scan.ref import (  # noqa: E402
    ssd_scan_ref as jax_ssd_ref)
from repro.models import model as ref_model  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.serve import decode as ref_decode  # noqa: E402
from repro.serve import kvcache as ref_kvcache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (ssd_scan,  # noqa: E402
                                              ssd_scan_kernel,
                                              ssd_scan_stages)
from repro_torch.kernels.ssd_scan.ref import (  # noqa: E402
    _segsum, ssd_chunk_parallel, ssd_scan_ref)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.serve.decode import decode_step  # noqa: E402
from repro_torch.serve.kvcache import init_cache  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402

TOL = 1e-4
SSD_TOL = {"float32": 5e-5, "bfloat16": 5e-2}
NAME = "mamba2-2.7b"


@pytest.fixture(autouse=True)
def _highest_precision_one_thread():
    """float32 products in full float32; one intra-op thread per worker."""
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_num_threads(n)


def _pair(**over):
    """(reference cfg, port cfg) of ``reduced(mamba2-2.7b, **over)``."""
    return (ref_base.reduced(REF_ARCHS[NAME], **over),
            base.reduced(get_arch(NAME), **over))


@pytest.fixture(scope="module")
def reduced_pair():
    """(reference cfg, reference params, port cfg, port model) of reduced
    mamba2 on the same weights."""
    ref_cfg, cfg = _pair()
    params = ref_model.init(ref_cfg, jax.random.key(0))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, params, cfg, model


# ------------------------------------------------------------ SSD scan
def _kernel_inputs(B, H, G, S, P, N, seed=1):
    """The reference's kernel-test distribution, drawn with NumPy."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, H, S, P)) * 0.5
    dA = -np.logaddexp(0.0, rng.standard_normal((B, H, S))) * 0.5
    Bm = rng.standard_normal((B, G, S, N)) * 0.5
    Cm = rng.standard_normal((B, G, S, N)) * 0.5
    return [a.astype(np.float32) for a in (xdt, dA, Bm, Cm)]


def _model_inputs(B, S, H, P, G, N, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)) * 0.5
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H)))
    A = -np.exp(rng.standard_normal(H) * 0.3)
    Bm = rng.standard_normal((B, S, G, N)) * 0.5
    Cm = rng.standard_normal((B, S, G, N)) * 0.5
    return [a.astype(np.float32) for a in (x, dt, A, Bm, Cm)]


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(
        np.asarray(got.float() if torch.is_tensor(got) else got, np.float32),
        np.asarray(want, np.float32), atol=tol, rtol=tol, err_msg=msg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,S,P,N,chunk", [
    (1, 2, 1, 64, 16, 16, 16),
    (2, 4, 2, 128, 32, 32, 32),
    (1, 8, 1, 96, 64, 128, 32),   # grouped broadcast, wide state
])
def test_ssd_plain_versions_match_pallas(B, H, G, S, P, N, chunk, dtype):
    """The exact recurrence and the chunked algorithm (the CPU path of the
    kernel-layout entry point) against the Pallas kernel in interpret
    mode and the reference's oracle, the reference's kernel test."""
    arrs = _kernel_inputs(B, H, G, S, P, N)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    wants = {"pallas": ssd_scan_tpu(*jx, chunk=chunk, interpret=True),
             "oracle": jax_ssd_ref(*jx, chunk=chunk)}
    gots = {"ssd_scan_ref": ssd_scan_ref(*tx, chunk),
            "ssd_chunked": ssd_scan_kernel(*tx, chunk=chunk)}
    tol = SSD_TOL[dtype]
    for gname, (y, st) in gots.items():
        assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
        for wname, (y_w, st_w) in wants.items():
            _close(y, y_w, tol, f"{gname} y vs {wname}")
            _close(st, st_w, tol, f"{gname} state vs {wname}")


# the reference's kernel-test shapes at chunks 8 to 64, and one wide
# state over several tiles of 64
SSD_STAGED_CASES = [
    (1, 2, 1, 64, 16, 16, 8),
    (1, 2, 1, 64, 16, 16, 16),
    (2, 4, 2, 128, 32, 32, 32),
    (2, 4, 2, 128, 32, 32, 64),
    (1, 8, 1, 96, 64, 128, 32),
    (1, 4, 1, 192, 64, 128, 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,G,S,P,N,chunk", SSD_STAGED_CASES)
def test_ssd_chunk_parallel_matches_pallas(B, H, G, S, P, N, chunk, dtype):
    """The staged plain version (the CUDA kernel's three stages) against
    the Pallas kernel in interpret mode and the exact recurrence."""
    arrs = _kernel_inputs(B, H, G, S, P, N)
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    tx = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    y, st, _ = ssd_chunk_parallel(*tx, chunk)
    assert y.dtype == getattr(torch, dtype) and st.dtype == torch.float32
    tol = SSD_TOL[dtype]
    for name, (y_w, st_w) in {
            "pallas": ssd_scan_tpu(*jx, chunk=chunk, interpret=True),
            "exact": [t.float() for t in ssd_scan_ref(*tx)]}.items():
        _close(y, y_w, tol, f"y vs {name}")
        _close(st, st_w, tol, f"state vs {name}")


@pytest.mark.parametrize("chunk", [8, 24, 64, 100])
def test_ssd_chunk_parallel_stages_are_the_recurrence(chunk):
    """Each stage's result is what the exact recurrence gives: a tile's
    own state is the recurrence over that tile from zero, the state
    entering tile c the recurrence over the first c tiles, the decay the
    exponential of the tile's summed dA; S = 100 leaves a ragged last
    tile for chunks 8, 24 and 64."""
    arrs = [torch.from_numpy(a) for a in _kernel_inputs(2, 4, 2, 100, 8, 16)]
    xdt, dA, Bm, Cm = arrs
    y, st, stages = ssd_chunk_parallel(*arrs, chunk)
    y_r, st_r = ssd_scan_ref(*arrs)
    tol = SSD_TOL["float32"]
    _close(y, y_r, tol)
    _close(st, st_r, tol)
    n_tiles = -(-100 // chunk)
    assert stages["chunk_states"].shape == (2, 4, n_tiles, 8, 16)
    for c in range(n_tiles):
        lo, hi = c * chunk, min(100, (c + 1) * chunk)
        tile = [t[:, :, lo:hi] for t in arrs]
        _close(stages["chunk_states"][:, :, c], ssd_scan_ref(*tile)[1], tol,
               f"chunk state {c}")
        _close(stages["decays"][:, :, c], torch.exp(dA[:, :, lo:hi].sum(-1)),
               tol, f"decay {c}")
        before = (ssd_scan_ref(*[t[:, :, :lo] for t in arrs])[1] if lo
                  else torch.zeros(2, 4, 8, 16))
        _close(stages["passed_states"][:, :, c], before, tol,
               f"passed state {c}")


def _ssd_bf16_design(xdt, dA, B, C, chunk, round_state=False):
    """The arithmetic of an SSD kernel that runs its products on the
    tensor cores in bfloat16 with float32 sums: the chunked algorithm with
    L o C B^T and the decayed xdt rounded to bfloat16 where they become
    product operands, and, with ``round_state``, the state entering each
    tile too.  Every other value is float32; inputs are bfloat16."""
    r = lambda t: t.bfloat16().float()
    b, H, S, P = xdt.shape
    G, N = B.shape[1], B.shape[3]
    nT, Q, rep = S // chunk, chunk, H // G
    x = xdt.float().reshape(b, G, rep, nT, Q, P)
    a = dA.float().reshape(b, G, rep, nT, Q)
    Bc = B.float().reshape(b, G, 1, nT, Q, N)
    Cc = C.float().reshape(b, G, 1, nT, Q, N)
    cs = torch.cumsum(a, dim=-1)
    own = r(x * torch.exp(cs[..., -1:] - cs)[..., None]).transpose(-1, -2) \
        @ Bc
    st = x.new_zeros((b, G, rep, P, N))
    passed = []
    for c in range(nT):
        passed.append(st)
        st = st * torch.exp(cs[..., c, -1])[..., None, None] + own[..., c, :, :]
    h_in = torch.stack(passed, dim=3)
    if round_state:
        h_in = r(h_in)
    scores = r((Cc @ Bc.transpose(-1, -2)) * torch.exp(_segsum(a)))
    y = scores @ x + (Cc @ h_in.transpose(-1, -2)) * torch.exp(cs)[..., None]
    return y.reshape(b, H, S, P).bfloat16(), st.reshape(b, H, P, N)


@pytest.mark.parametrize("round_state", [False, True])
@pytest.mark.parametrize("B,H,G,S,P,N,chunk", SSD_STAGED_CASES)
def test_ssd_bf16_roundings_hold_tolerance(B, H, G, S, P, N, chunk,
                                           round_state):
    """Rounding the tensor-core operands of a bfloat16 SSD kernel (L o C
    B^T, the decayed xdt, and optionally the carried state) keeps the
    result within the reference's bfloat16 tolerance of its oracle."""
    arrs = _kernel_inputs(B, H, G, S, P, N)
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    tx = [torch.from_numpy(a).bfloat16() for a in arrs]
    y, st = _ssd_bf16_design(*tx, chunk, round_state=round_state)
    y_w, st_w = jax_ssd_ref(*jx, chunk=chunk)
    _close(y, y_w, SSD_TOL["bfloat16"])
    _close(st, st_w, SSD_TOL["bfloat16"])


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (48, 48)])
def test_ssd_entry_point_matches_reference_entry_point(S, chunk):
    """Model layout: the port's ``ssd_scan`` (its chunked algorithm on the
    CPU) against the reference's ``ssd_scan`` through the Pallas kernel in
    interpret mode and against the reference model's ``ssd_chunked``."""
    arrs = _model_inputs(2, S, 4, 16, 2, 32)
    y, st = ssd_scan(*(torch.from_numpy(a) for a in arrs), chunk=chunk)
    jx = [jnp.asarray(a) for a in arrs]
    for y_w, st_w in (ref_ops.ssd_scan(*jx, chunk=chunk,
                                       impl="pallas_interpret"),
                      ref_ssm.ssd_chunked(*jx, chunk=chunk)):
        _close(y, y_w, SSD_TOL["float32"])
        _close(st, st_w, SSD_TOL["float32"])


def test_ssd_chunked_with_init_state_matches_reference():
    arrs = _model_inputs(1, 32, 4, 8, 1, 16)
    init = np.random.default_rng(4).standard_normal((1, 4, 8, 16)) \
        .astype(np.float32)
    y, st = ssm.ssd_chunked(*(torch.from_numpy(a) for a in arrs), chunk=8,
                            init_state=torch.from_numpy(init))
    y_w, st_w = ref_ssm.ssd_chunked(*(jnp.asarray(a) for a in arrs),
                                    chunk=8, init_state=jnp.asarray(init))
    _close(y, y_w, SSD_TOL["float32"])
    _close(st, st_w, SSD_TOL["float32"])


def test_ssd_chunked_refuses_chunk_not_dividing_seq():
    arrs = [torch.from_numpy(a) for a in _model_inputs(1, 24, 2, 8, 1, 8)]
    with pytest.raises(ValueError):
        ssm.ssd_chunked(*arrs, chunk=16)
    with pytest.raises(ValueError):
        ssd_scan(*arrs, chunk=16)


def test_ssd_decode_steps_equal_chunked():
    """S single-token steps of the recurrence give the chunked algorithm's
    outputs and final state."""
    x, dt, A, Bm, Cm = (torch.from_numpy(a)
                        for a in _model_inputs(2, 24, 4, 16, 2, 16))
    y_c, st_c = ssm.ssd_chunked(x, dt, A, Bm, Cm, chunk=8)
    state = torch.zeros_like(st_c)
    for s in range(x.shape[1]):
        y, state = ssm.ssd_decode_step(state, x[:, s], dt[:, s], A,
                                       Bm[:, s], Cm[:, s])
        _close(y, y_c[:, s].numpy(), SSD_TOL["float32"], f"step {s}")
    _close(state, st_c.numpy(), SSD_TOL["float32"])


def test_cpu_tensors_run_plain_version_without_launching():
    reset_launches()
    arrs = [torch.from_numpy(a) for a in _kernel_inputs(1, 2, 1, 16, 8, 8)]
    ssd_scan_kernel(*arrs, chunk=8)
    ssd_scan(*(torch.from_numpy(a) for a in _model_inputs(1, 16, 2, 8, 1, 8)),
             chunk=8)
    assert LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError):
        ssd_scan_kernel(*arrs, chunk=8, impl="kernel")
    with pytest.raises(ValueError):
        ssd_scan_stages(*arrs, chunk=8)
    with pytest.raises(ValueError):
        ssd_scan(*(torch.from_numpy(a)
                   for a in _model_inputs(1, 16, 2, 8, 1, 8)),
                 chunk=8, impl="kernel")


# ------------------------------------------------------- schema, caches
@pytest.mark.parametrize("reduce", [False, True])
def test_schema_equals_reference(reduce):
    def flat(t):
        return {k: (flat(v) if isinstance(v, dict)
                    else (v.shape, v.axes, v.init, v.scale, v.dtype))
                for k, v in t.items()}
    ref_cfg, cfg = REF_ARCHS[NAME], get_arch(NAME)
    if reduce:
        ref_cfg, cfg = _pair()
    assert flat(M.schema(cfg)) == flat(ref_model.schema(ref_cfg))


def test_init_follows_schema():
    cfg = base.reduced(get_arch(NAME))
    model = M.init(cfg, seed=1, device="cpu")
    assert all(isinstance(b, M.MambaBlock) for b in model.blocks)
    params = dict(model.named_parameters())
    leaves = list(M.param_leaves(cfg))
    assert sorted(params) == sorted(name for name, *_ in leaves)
    for name, path, layer, d in leaves:
        p = params[name]
        assert tuple(p.shape) == (d.shape if layer is None else d.shape[1:])
        if d.init in ("ones", "zeros"):
            assert bool((p == (d.init == "ones")).all()), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_equals_reference(dtype):
    """Conv tail in the model's dtype, the state always float32, the
    reference's shapes."""
    ref_cfg, cfg = _pair()
    got = init_cache(cfg, 3, 16, dtype=getattr(torch, dtype), device="cpu")
    want = ref_kvcache.init_cache(ref_cfg, 3, 16, dtype=getattr(jnp, dtype))
    assert got.keys() == want.keys() == {"blocks"}
    assert got["blocks"].keys() == want["blocks"].keys() == {"conv", "state"}
    for k in ("conv", "state"):
        g, w = got["blocks"][k], want["blocks"][k]
        assert tuple(g.shape) == w.shape and not bool(g.any())
        assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    assert got["blocks"]["state"].dtype == torch.float32


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("S", [5, 8, 24])
def test_forward_matches_reference(reduced_pair, S):
    """S below, at and above the chunk of 8 (three chunks)."""
    ref_cfg, params, cfg, model = reduced_pair
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    want = np.asarray(ref_model.forward(ref_cfg, params, {"tokens": toks}))
    reset_launches()
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    assert LAUNCHES["ssd_scan"] == 0
    assert got.shape == want.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_forward_refuses_seq_not_multiple_of_chunk(reduced_pair):
    """The reference asserts S % chunk == 0 above the chunk; the port
    raises ValueError."""
    *_, cfg, model = reduced_pair
    with torch.inference_mode(), pytest.raises(ValueError):
        model(torch.zeros((1, 12), dtype=torch.int64))


@pytest.fixture(scope="module")
def full_width():
    """mamba2-2.7b at its own widths with two layers: NumPy-seeded
    weights (drawn once), the tokens ``chip_smoke.py``'s cut-depth phase
    runs, and the reference's logits on them."""
    cfg = dataclasses.replace(get_arch(NAME), n_layers=2)
    ref_cfg = dataclasses.replace(REF_ARCHS[NAME], n_layers=2)
    params = interop.seeded_params(cfg, seed=0)
    toks = SyntheticDataset(cfg.vocab, 256, 2, seed=0).batch(0)["tokens"]
    want = np.asarray(ref_model.forward(ref_cfg, params,
                                        {"tokens": toks.numpy()}))
    return cfg, params, toks, want


def test_forward_full_width_matches_reference(full_width):
    """d_model 2560, 80 heads of 64, d_state 128, vocab 50280, two layers,
    B 2 x 256 tokens (four chunks of 64)."""
    cfg, params, toks, want = full_width
    model = interop.model_params(cfg, params, device="cpu")
    with torch.inference_mode():
        got = model(toks).numpy()
    del model
    assert got.shape == (2, 256, 50280)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_expected_mamba2_is_the_reference(full_width):
    """``chip_smoke.py`` holds the card's cut-depth mamba2-2.7b forward to
    ``EXPECTED_MAMBA2``; these are the reference package's logits on the
    same NumPy-seeded weights and tokens."""
    chip_smoke = _chip_smoke()
    *_, want = full_width
    held = want[:, list(chip_smoke.MAMBA2_HELD_POSITIONS)]
    summary = chip_smoke.forward_summary(held)
    assert chip_smoke.forward_agrees(summary, chip_smoke.EXPECTED_MAMBA2)
    assert [s[0] for s in summary] \
        == [e[0] for e in chip_smoke.EXPECTED_MAMBA2]


# -------------------------------------------------------------- decode
def _ref_step(ref_cfg, params):
    return jax.jit(lambda c, t, p: ref_decode.decode_step(ref_cfg, params,
                                                          c, t, p))


def _prompts(cfg, B, S):
    return SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]


def test_decode_matches_reference(reduced_pair):
    ref_cfg, params, cfg, model = reduced_pair
    B, T = 2, 10
    toks = _prompts(cfg, B, T)
    step = _ref_step(ref_cfg, params)
    ref_caches = ref_kvcache.init_cache(ref_cfg, B, T)
    caches = init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        want, ref_caches = step(ref_caches, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        assert got.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=f"step {t}")
    for k in ("conv", "state"):
        np.testing.assert_allclose(caches["blocks"][k].numpy(),
                                   np.asarray(ref_caches["blocks"][k]),
                                   atol=TOL, rtol=TOL, err_msg=k)


def test_decode_matches_forward(reduced_pair):
    """Cache correctness: decode logits at t equal the forward's at t,
    across two chunks of the forward."""
    *_, cfg, model = reduced_pair
    B, T = 2, 16
    toks = _prompts(cfg, B, T)
    with torch.inference_mode():
        fwd = model(toks)
    caches = init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        np.testing.assert_allclose(got[:, 0].numpy(), fwd[:, t].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=f"t={t}")


def test_greedy_ids_equal_reference_loop(reduced_pair):
    """The driver's generation loop and the reference's pick the same
    tokens; no step's top-2 logit gap is small enough for a rounding
    difference to flip the pick."""
    ref_cfg, params, cfg, model = reduced_pair
    B, S, gen = 3, 12, 10
    prompts = _prompts(cfg, B, S)
    step = _ref_step(ref_cfg, params)
    caches = ref_kvcache.init_cache(ref_cfg, B, S + gen)
    logits, gaps, want = None, [], []
    for t in range(S + gen):
        tok = (jnp.asarray(prompts[:, t:t + 1]) if t < S
               else jnp.argmax(logits[:, -1], axis=-1)[:, None])
        if t >= S:
            want.append(np.asarray(tok))
            top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
            gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        logits, caches = step(caches, tok, jnp.int32(t))
    got, _, _ = serve.generate(model, prompts, gen)
    assert min(gaps) > 1e-4, gaps
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serve_main_on_cpu(capsys, dtype):
    rc = serve.main(["--arch", NAME, "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4", "--device", "cpu",
                     "--dtype", dtype])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill: 8 tokens x 2 seqs in ")
    assert lines[1].startswith("decode:  4 tokens x 2 seqs in ")
    assert len(lines[2].split(":", 1)[1].strip(" []").split(",")) == 4
