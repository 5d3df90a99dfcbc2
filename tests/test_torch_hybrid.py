"""The port's hybrid family (zamba2-7b) against the reference's, on the CPU.

A hybrid model runs G groups of k mamba2 layers, each group followed by
ONE shared attention + MLP block (one set of weights, its own KV cache
slot per application), then n_layers - G·k trailing mamba2 layers.  The
reduced zamba2 (5 layers, ``hybrid_every`` 2: G 2, k 2, 1 trailing) has
every one of those paths.  Its schema, parameter leaves and caches must
equal the reference's; the forward (the plain attention branch at S 64,
the flash branch at ``FLASH_MIN_SEQ``), ten decode steps with their conv,
state and shared k/v caches, and the greedy ids of the serve driver are
held to the reference's on the same parameters (its own ``init`` carried
over with ``interop.model_params``) in float32 within atol = rtol = 1e-4,
as the dense and SSM stacks are.  The full-width 7-layer fixture (one
group of 6, the shared block, one trailing layer; NumPy-seeded weights)
recomputes ``chip_smoke.EXPECTED_ZAMBA2``.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.serve import decode as ref_decode  # noqa: E402
from repro.serve import kvcache as ref_kvcache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import FLASH_MIN_SEQ  # noqa: E402
from repro_torch.serve.decode import decode_step  # noqa: E402
from repro_torch.serve.kvcache import init_cache  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402

TOL = 1e-4
NAME = "zamba2-7b"


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
    """(reference cfg, port cfg) of ``reduced(zamba2-7b, **over)``."""
    return (ref_base.reduced(REF_ARCHS[NAME], **over),
            base.reduced(get_arch(NAME), **over))


@pytest.fixture(scope="module")
def reduced_pair():
    """(reference cfg, reference params, port cfg, port model) of reduced
    zamba2 on the same weights."""
    ref_cfg, cfg = _pair()
    params = ref_model.init(ref_cfg, jax.random.key(0))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, params, cfg, model


def _flat(t):
    return {k: (_flat(v) if isinstance(v, dict)
                else (v.shape, v.axes, v.init, v.scale, v.dtype))
            for k, v in t.items()}


def _leaf_count(tree) -> int:
    return sum(math.prod(v.shape) for v in jax.tree.leaves(
        tree, is_leaf=lambda x: hasattr(x, "axes")))


# ------------------------------------------------------ schema, params
@pytest.mark.parametrize("reduce", [False, True])
def test_schema_equals_reference(reduce):
    """The groups ``blocks`` (G·k mamba2 layers), ``trailing`` and
    ``shared`` (stacked over 1), leaf for leaf."""
    ref_cfg, cfg = REF_ARCHS[NAME], get_arch(NAME)
    if reduce:
        ref_cfg, cfg = _pair()
    got = M.schema(cfg)
    assert _flat(got) == _flat(ref_model.schema(ref_cfg))
    G, k, trail = M._hybrid_split(cfg)
    assert got["blocks"]["in_proj"].shape[0] == G * k
    assert got["trailing"]["in_proj"].shape[0] == trail
    assert all(d.shape[0] == 1 for d in got["shared"].values())


def test_param_leaves_name_every_reference_leaf(reduced_pair):
    """Every parameter of the module is one slice of one reference leaf,
    every reference leaf is sliced, the shared block is one module with
    one set of weights, and the parameter count is the reference's."""
    ref_cfg, params, cfg, model = reduced_pair
    leaves = list(M.param_leaves(cfg))
    assert sorted(dict(model.named_parameters())) \
        == sorted(name for name, *_ in leaves)
    ref_paths = {tuple(getattr(k, "key", k) for k in path)
                 for path, _ in jax.tree_util.tree_flatten_with_path(
                     params)[0]}
    assert {path for _, path, _, _ in leaves} == ref_paths
    slices = {}
    for _, path, layer, d in leaves:
        slices.setdefault(path, set()).add(layer)
    for path, layers in slices.items():
        want = ({None} if len(path) == 1 else
                set(range(np.shape(params[path[0]][path[1]])[0])))
        assert layers == want, path
    assert slices[("shared", "wq")] == {0}
    assert sum(isinstance(m, M.DenseBlock) for m in model.modules()) == 1
    assert sum(p.numel() for p in model.parameters()) \
        == sum(a.size for a in jax.tree.leaves(params))


def test_param_count_equals_reference_full_width():
    """zamba2-7b's own widths: the port's module holds as many parameters
    as the reference's schema (6.75 B), and ``n_params`` — the config's
    closed form, which leaves out the conv, dt, A, D and norm weights and
    the dt columns of the in-projection — is within 1 % of it (6.71 B)."""
    cfg = get_arch(NAME)
    got = sum(math.prod(d.shape[1:] if layer is not None else d.shape)
              for _, _, layer, d in M.param_leaves(cfg))
    want = _leaf_count(ref_model.schema(REF_ARCHS[NAME]))
    assert got == want
    assert abs(got - cfg.n_params) / got < 1e-2
    assert 6.75e9 < got < 6.76e9


def test_interop_round_trip(reduced_pair):
    """``model_params`` puts slice [l] of each reference leaf in layer l of
    its group (slice [0] for the shared block), bit for bit; a leaf whose
    stacking axis is wrong, or one the port does not know, is refused."""
    ref_cfg, params, cfg, model = reduced_pair
    got = dict(model.named_parameters())
    for name, path, layer, _ in M.param_leaves(cfg):
        arr = np.asarray(params[path[0]] if len(path) == 1
                         else params[path[0]][path[1]])
        np.testing.assert_array_equal(
            got[name].detach().numpy(),
            arr if layer is None else arr[layer], err_msg=name)
    np_params = jax.tree.map(np.asarray, params)
    bad = dict(np_params, shared=dict(
        np_params["shared"], wq=np.concatenate(
            [np_params["shared"]["wq"]] * 2)))
    with pytest.raises(ValueError):
        interop.model_params(cfg, bad, device="cpu")
    with pytest.raises(KeyError):
        interop.model_params(cfg, dict(np_params, cross={"wq": np.zeros(3)}),
                             device="cpu")


def test_seeded_params_follow_reference_schema():
    """NumPy-seeded weights have the reference's tree and shapes, and both
    packages compute the same logits on them."""
    ref_cfg, cfg = _pair()
    params = interop.seeded_params(cfg, seed=3)
    assert jax.tree.map(np.shape, params) == jax.tree.map(
        lambda d: d.shape, ref_model.schema(ref_cfg),
        is_leaf=lambda x: hasattr(x, "axes"))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 16))
    want = np.asarray(ref_model.forward(ref_cfg, params,
                                        {"tokens": toks.astype(np.int32)}))
    model = interop.model_params(cfg, params, device="cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_equals_reference(dtype):
    """The mamba2 caches of the grouped and the trailing layers, and the
    shared block's k/v with one slot per application (leading axis G)."""
    ref_cfg, cfg = _pair()
    got = init_cache(cfg, 3, 16, dtype=getattr(torch, dtype), device="cpu")
    want = ref_kvcache.init_cache(ref_cfg, 3, 16, dtype=getattr(jnp, dtype))
    assert got.keys() == want.keys() == {"blocks", "trailing", "shared"}
    for grp in got:
        assert got[grp].keys() == want[grp].keys()
        for k, g in got[grp].items():
            w = want[grp][k]
            assert tuple(g.shape) == w.shape and not bool(g.any())
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    G, _, _ = M._hybrid_split(cfg)
    assert got["shared"]["k"].shape[0] == G


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_forward_matches_reference(reduced_pair, S):
    """S = 64 runs the shared block's plain attention, S = 2048 its flash
    branch, in both packages; the mamba2 layers take 8-token chunks."""
    ref_cfg, params, cfg, model = reduced_pair
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    want = np.asarray(ref_model.forward(ref_cfg, params, {"tokens": toks}))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_shared_block_runs_once_per_group(reduced_pair, monkeypatch):
    """The one shared module is applied G times a forward, after each
    group of k mamba2 layers."""
    *_, cfg, model = reduced_pair
    calls = []
    orig = M.DenseBlock.forward

    def spy(self, h, *a, **kw):
        calls.append(self)
        return orig(self, h, *a, **kw)
    monkeypatch.setattr(M.DenseBlock, "forward", spy)
    with torch.inference_mode():
        model(torch.zeros((1, 8), dtype=torch.int64))
    G, _, _ = M._hybrid_split(cfg)
    assert len(calls) == G and all(c is model.shared for c in calls)


# -------------------------------------------------------------- decode
def _ref_step(ref_cfg, params):
    return jax.jit(lambda c, t, p: ref_decode.decode_step(ref_cfg, params,
                                                          c, t, p))


def _prompts(cfg, B, S):
    return SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]


def test_decode_matches_reference(reduced_pair):
    """Ten steps: logits, then every cache (the grouped and trailing
    layers' conv tails and states, the shared block's k/v per group)."""
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
    for grp, leaves in (("blocks", ("conv", "state")),
                        ("trailing", ("conv", "state")),
                        ("shared", ("k", "v"))):
        for k in leaves:
            np.testing.assert_allclose(caches[grp][k].numpy(),
                                       np.asarray(ref_caches[grp][k]),
                                       atol=TOL, rtol=TOL,
                                       err_msg=f"{grp}/{k}")
    assert bool(caches["shared"]["k"][1].any())   # group 1 wrote its slot


def test_decode_matches_forward(reduced_pair):
    """Cache correctness: decode logits at t equal the forward's at t,
    across two of the mamba2 layers' chunks."""
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


def test_decode_refuses_position_past_cache(reduced_pair):
    *_, cfg, model = reduced_pair
    caches = init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError):
        decode_step(model, caches, torch.zeros(1, 1, dtype=torch.int32), 4)


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


# ---------------------------------------------------------- full width
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def full_width():
    """zamba2-7b at its own widths with 7 layers (G 1, k 6, 1 trailing):
    NumPy-seeded weights (0.98 B, drawn once), the tokens
    ``chip_smoke.py``'s cut-depth phase runs (B 2 x 256), and the
    reference's logits on them."""
    cfg = dataclasses.replace(get_arch(NAME), n_layers=7)
    ref_cfg = dataclasses.replace(REF_ARCHS[NAME], n_layers=7)
    params = interop.seeded_params(cfg, seed=0)
    toks = SyntheticDataset(cfg.vocab, 256, 2, seed=0).batch(0)["tokens"]
    want = np.asarray(ref_model.forward(ref_cfg, params,
                                        {"tokens": toks.numpy()}))
    return cfg, params, toks, want


def test_forward_full_width_matches_reference(full_width):
    """d_model 3584, 32 heads of 112 (the shared block's plain attention
    at S 256), d_ff 14336, 112 SSM heads of 64, d_state 64, vocab 32000;
    B 2 x 256 tokens (four chunks of 64)."""
    cfg, params, toks, want = full_width
    model = interop.model_params(cfg, params, device="cpu")
    with torch.inference_mode():
        got = model(toks).numpy()
    del model
    assert got.shape == (2, 256, 32000)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the port's own logits pass the rule the card's run is held to
    chip_smoke = _chip_smoke()
    assert chip_smoke.forward_agrees(chip_smoke.forward_summary(
        got[:, list(chip_smoke.ZAMBA2_HELD_POSITIONS)]), chip_smoke.EXPECTED_ZAMBA2)


def test_expected_zamba2_is_the_reference(full_width):
    """``chip_smoke.py`` holds the card's cut-depth zamba2-7b forward to
    ``EXPECTED_ZAMBA2``; these are the reference package's logits on the
    same NumPy-seeded weights and tokens, with the logits' L2 norms that
    bound the sums' tolerance."""
    chip_smoke = _chip_smoke()
    *_, want = full_width
    held = want[:, list(chip_smoke.ZAMBA2_HELD_POSITIONS)]
    summary = chip_smoke.forward_summary(held)
    assert chip_smoke.forward_agrees(summary, chip_smoke.EXPECTED_ZAMBA2)
    assert [s[0] for s in summary] \
        == [e[0] for e in chip_smoke.EXPECTED_ZAMBA2]
    np.testing.assert_allclose([s[3] for s in summary],
                               [e[3] for e in chip_smoke.EXPECTED_ZAMBA2],
                               rtol=1e-6)
