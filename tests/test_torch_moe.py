"""The port's MoE family (deepseek-v2-lite-16b, phi3.5-moe-42b) against the
reference's, on the CPU.

A MoE layer routes each token to its top-k experts (softmax in float32,
top-k, renormalised), sorts the (token, choice) pairs by expert, runs each
expert's MLP on its contiguous slice of the sorted rows (the reference's
``jax.lax.ragged_dot``, the port's ``torch.matmul`` per expert), puts the
rows back, weights them by their probabilities, sums over the k choices,
and adds the shared experts.  deepseek-v2-lite also has a leading dense
layer (``dense0``, its own ``d_ff_first``) and MLA attention; phi3.5-moe
is MoE in every layer with GQA attention.

Held here, in float32: ``route``'s ids equal the reference's and its
probabilities within 1e-6; ``moe_ffn_local`` within atol = rtol = 1e-5 at
reduced widths, over (experts, top-k, shared experts, activation); the two
reduced models' schemas, parameters and caches equal the reference's, and
their forwards (S 64, and S 2048 through the flash branch), ten decode
steps and greedy ids within 1e-4, as the other families are.  The
full-width two-layer deepseek-v2-lite fixture (one dense layer and one MoE
layer, B 1 x 2048, NumPy-seeded weights) recomputes
``chip_smoke.EXPECTED_DSV2``.

On the CPU the reference's ``ragged_dot`` is lowered densely: every row
meets every expert (at deepseek's full width, 64 times the work and a
6.4 GB masked operand per product).  The full-width fixture therefore runs
the reference's forward with ``jax.lax.ragged_dot`` computing each group's
product on the host (``_ragged_dot_by_group``), for that fixture only;
``test_ragged_dot_by_group_equals_ragged_dot`` holds it to the real op.
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
from repro.models import model as ref_model  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.serve import decode as ref_decode  # noqa: E402
from repro.serve import kvcache as ref_kvcache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import FLASH_MIN_SEQ  # noqa: E402
from repro_torch.serve.decode import decode_step  # noqa: E402
from repro_torch.serve.kvcache import init_cache  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402

TOL = 1e-4
FFN_TOL = 1e-5
ARCH_NAMES = ["deepseek-v2-lite-16b", "phi3.5-moe-42b"]
DSV2 = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True)
def _highest_precision_one_thread():
    """float32 products in full float32; one intra-op thread per worker."""
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_num_threads(n)


def _pair(name: str):
    """(reference cfg, port cfg) of ``reduced(name)``."""
    return (ref_base.reduced(REF_ARCHS[name]), base.reduced(get_arch(name)))


@pytest.fixture(scope="module", params=ARCH_NAMES)
def reduced_pair(request):
    """(reference cfg, reference params, port cfg, port model) of a reduced
    MoE model on the reference's ``init`` weights."""
    ref_cfg, cfg = _pair(request.param)
    params = ref_model.init(ref_cfg, jax.random.key(0))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, params, cfg, model


def _flat(t):
    return {k: (_flat(v) if isinstance(v, dict)
                else (v.shape, v.axes, v.init, v.scale, v.dtype))
            for k, v in t.items()}


# ------------------------------------------------------ schema, caches
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_schema_equals_reference(name, full):
    """Same groups, leaves, shapes, scales and order (``seeded_params``
    draws in that order): deepseek-v2-lite's ``dense0`` (MLA + an MLP of
    ``d_ff_first``) before its MoE ``blocks``; phi3.5-moe's MoE
    ``blocks``."""
    ref_cfg, cfg = ((REF_ARCHS[name], get_arch(name)) if full
                    else _pair(name))
    got, want = M.schema(cfg), ref_model.schema(ref_cfg)
    assert _flat(got) == _flat(want)
    assert list(got) == list(want)
    for group in got:
        if isinstance(got[group], dict):
            assert list(got[group]) == list(want[group])
    assert ("dense0" in got) == bool(cfg.moe.first_dense)
    assert {"router", "w_up", "w_gate", "w_down"} <= got["blocks"].keys()
    assert ("shared_up" in got["blocks"]) == bool(cfg.moe.n_shared)


def test_param_count_equals_reference(reduced_pair):
    ref_cfg, params, cfg, model = reduced_pair
    assert sorted(dict(model.named_parameters())) \
        == sorted(name for name, *_ in M.param_leaves(cfg))
    assert sum(p.numel() for p in model.parameters()) \
        == sum(a.size for a in jax.tree.leaves(params))


def test_model_params_round_trip(reduced_pair):
    """Every parameter of the port's model is its slice of the reference's
    ``init`` leaf, bit for bit."""
    ref_cfg, params, cfg, model = reduced_pair
    got = dict(model.named_parameters())
    for name, path, layer, d in M.param_leaves(cfg):
        leaf = np.asarray(params[path[0]] if len(path) == 1
                          else params[path[0]][path[1]])
        want = leaf if layer is None else leaf[layer]
        assert tuple(got[name].shape) == want.shape, name
        np.testing.assert_array_equal(got[name].detach().numpy(), want,
                                      err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_cache_equals_reference(name, dtype):
    """deepseek-v2-lite: MLA latents ``ckv`` for ``dense0`` and
    ``blocks``; phi3.5-moe: GQA ``k``/``v`` for ``blocks``."""
    ref_cfg, cfg = _pair(name)
    got = init_cache(cfg, 3, 16, dtype=getattr(torch, dtype), device="cpu")
    want = ref_kvcache.init_cache(ref_cfg, 3, 16, dtype=getattr(jnp, dtype))
    assert got.keys() == want.keys()
    assert ("dense0" in got) == bool(cfg.moe.first_dense)
    for group in got:
        assert got[group].keys() == want[group].keys()
        for leaf, g in got[group].items():
            w = want[group][leaf]
            assert tuple(g.shape) == w.shape and not bool(g.any())
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)


# --------------------------------------------------------------- route
@pytest.mark.parametrize("T,E,k", [(64, 4, 2), (512, 64, 6), (300, 16, 2)])
def test_route_equals_reference(T, E, k):
    """Same ids in the same (descending) order; the renormalised
    probabilities within 1e-6."""
    logits = np.random.default_rng(T).standard_normal((T, E)).astype(
        np.float32)
    want_p, want_i = ref_moe.route(jnp.asarray(logits), k)
    got_p, got_i = moe.route(torch.from_numpy(logits), k)
    assert got_p.dtype == torch.float32 and tuple(got_i.shape) == (T, k)
    np.testing.assert_array_equal(np.sort(got_i.numpy(), -1),
                                  np.sort(np.asarray(want_i), -1))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got_p.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_route_softmax_in_float32():
    """bfloat16 router logits are routed in float32, as the reference's."""
    logits = torch.randn(32, 8, generator=torch.Generator().manual_seed(0))
    p16, i16 = moe.route(logits.bfloat16(), 2)
    p32, i32 = moe.route(logits.bfloat16().float(), 2)
    assert p16.dtype == torch.float32
    assert torch.equal(i16, i32) and torch.equal(p16, p32)


# ------------------------------------------------------- moe_ffn_local
FFN_CASES = [(4, 2, 0, "silu_glu"), (8, 6, 2, "silu_glu"), (4, 2, 1, "gelu")]


def _ffn_cfgs(E, k, n_shared, act):
    """(reference cfg, port cfg): reduced deepseek-v2-lite with ``E``
    experts, top ``k``, ``n_shared`` shared experts and ``act``."""
    out = []
    for cfg in _pair(DSV2):
        out.append(dataclasses.replace(cfg, act=act, moe=dataclasses.replace(
            cfg.moe, n_experts=E, top_k=k, n_shared=n_shared)))
    return tuple(out)


def _moe_block(cfg, leaves: dict) -> M.DenseBlock:
    """A :class:`DenseBlock` holding one layer's MoE leaves (NumPy)."""
    blk = M.DenseBlock({k: v.shape for k, v in leaves.items()},
                       device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for k, v in leaves.items():
            getattr(blk, k).copy_(torch.from_numpy(v))
    return blk


@pytest.mark.parametrize("E,k,n_shared,act", FFN_CASES)
def test_moe_ffn_local_matches_reference(E, k, n_shared, act):
    """The grouped product, the inverse permutation, the weighted sum over
    k and the shared experts, at d_model 64 and experts of 64; ``gelu``
    takes the schema's branch without ``w_gate``."""
    ref_cfg, cfg = _ffn_cfgs(E, k, n_shared, act)
    sch = moe.moe_schema(cfg, 1)
    assert _flat(sch) == _flat(ref_moe.moe_schema(ref_cfg, 1))
    assert ("w_gate" in sch) == (act == "silu_glu")
    rng = np.random.default_rng(E * 10 + k)
    leaves = {name: (rng.standard_normal(d.shape[1:]) * d.scale
                     ).astype(np.float32) for name, d in sch.items()}
    # router columns of larger scale, so that tokens spread over experts
    leaves["router"] *= 20
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_moe.moe_ffn_local(
        {n: jnp.asarray(v) for n, v in leaves.items()}, jnp.asarray(x),
        ref_cfg))
    with torch.inference_mode():
        got = moe.moe_ffn_local(_moe_block(cfg, leaves), torch.from_numpy(x),
                                cfg)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=FFN_TOL, rtol=FFN_TOL)


def test_expert_mlp_skips_empty_experts():
    """Experts that no token chose are skipped; each row goes through its
    own expert's MLP."""
    _, cfg = _ffn_cfgs(8, 1, 0, "silu_glu")
    sch = moe.moe_schema(cfg, 1)
    rng = np.random.default_rng(3)
    leaves = {name: (rng.standard_normal(d.shape[1:]) * d.scale
                     ).astype(np.float32) for name, d in sch.items()}
    blk = _moe_block(cfg, leaves)
    xs = torch.from_numpy(rng.standard_normal((7, cfg.d_model)).astype(
        np.float32))
    offsets = [0, 0, 3, 3, 3, 5, 5, 7, 7]      # experts 0, 2, 3, 5, 7 empty
    with torch.inference_mode():
        got = moe._expert_mlp_sorted(xs, offsets, blk, cfg.act)
        assert got.shape == xs.shape
        for e in range(8):
            lo, hi = offsets[e], offsets[e + 1]
            x = xs[lo:hi]
            h = (x @ blk.w_up[e]) * torch.nn.functional.silu(
                x @ blk.w_gate[e])
            torch.testing.assert_close(got[lo:hi], h @ blk.w_down[e])


def test_one_host_sync_per_moe_layer(reduced_pair, monkeypatch):
    """The group offsets are read to the host once per MoE layer of a
    forward, and once per MoE layer of a decode step."""
    *_, cfg, model = reduced_pair
    calls = []
    orig = moe._host_offsets
    monkeypatch.setattr(moe, "_host_offsets",
                        lambda o: calls.append(1) or orig(o))
    toks = torch.zeros((2, 16), dtype=torch.int64)
    with torch.inference_mode():
        model(toks)
    n_moe = cfg.n_layers - cfg.moe.first_dense
    assert len(calls) == n_moe == len(model.blocks)
    caches = init_cache(cfg, 2, 4, device="cpu")
    decode_step(model, caches, toks[:, :1], 0)
    assert len(calls) == 2 * n_moe


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_forward_matches_reference(reduced_pair, S):
    """S = 64 takes the plain attention in both packages, S = 2048 the
    flash branch in both (deepseek-v2-lite's MLA with V padded)."""
    ref_cfg, params, cfg, model = reduced_pair
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    want = np.asarray(ref_model.forward(ref_cfg, params, {"tokens": toks}))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_flash_branch_once_per_layer(reduced_pair, monkeypatch, S):
    """At ``FLASH_MIN_SEQ`` every layer, the dense one and the MoE ones,
    calls the flash attention once; below it none does."""
    *_, cfg, model = reduced_pair
    seen = []
    orig = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append(q.shape)
        return orig(q, k, v, **kw)
    monkeypatch.setattr(layers, "flash_attention", spy)
    with torch.inference_mode():
        model(torch.zeros((1, S), dtype=torch.int64))
    assert len(seen) == (cfg.n_layers if S >= FLASH_MIN_SEQ else 0)
    assert len(model.dense0) + len(model.blocks) == cfg.n_layers


# -------------------------------------------------------------- decode
def _ref_step(ref_cfg, params):
    return jax.jit(lambda c, t, p: ref_decode.decode_step(ref_cfg, params,
                                                          c, t, p))


def _prompts(cfg, B, S):
    return SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]


def test_decode_matches_reference(reduced_pair):
    """Ten steps: logits, then every cache group written in place."""
    ref_cfg, params, cfg, model = reduced_pair
    B, T = 2, 10
    toks = _prompts(cfg, B, T)
    step = _ref_step(ref_cfg, params)
    ref_caches = ref_kvcache.init_cache(ref_cfg, B, T)
    caches = init_cache(cfg, B, T, device="cpu")
    held = {g: dict(c) for g, c in caches.items()}
    for t in range(T):
        want, ref_caches = step(ref_caches, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        assert got.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=f"step {t}")
    for g, leaves in held.items():
        for leaf, tensor in leaves.items():
            assert caches[g][leaf] is tensor
            np.testing.assert_allclose(tensor.numpy(),
                                       np.asarray(ref_caches[g][leaf]),
                                       atol=TOL, rtol=TOL)


def test_decode_matches_forward(reduced_pair):
    """Cache correctness: decode logits at t equal the forward's at t."""
    *_, cfg, model = reduced_pair
    B, T = 2, 12
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


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_serve_main_on_cpu(capsys, name):
    rc = serve.main(["--arch", name, "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill: 8 tokens x 2 seqs in ")
    assert lines[1].startswith("decode:  4 tokens x 2 seqs in ")
    assert len(lines[2].split(":", 1)[1].strip(" []").split(",")) == 4


# ------------------------------------------- the reference's ragged_dot
def _ragged_dot_by_group(lhs, rhs, group_sizes, **kw):
    """``jax.lax.ragged_dot(lhs (M, K), rhs (G, K, N), group_sizes (G,))``
    for float32 operands, each group's rows times its matrix on the host;
    rows past the groups are zero, as the op defines them."""
    if kw or lhs.dtype != jnp.float32 or rhs.dtype != jnp.float32:
        raise NotImplementedError("float32 operands and no options only")

    def host(x, w, gs):
        out = np.zeros((x.shape[0], w.shape[2]), np.float32)
        lo = 0
        for g, n in enumerate(np.asarray(gs).tolist()):
            out[lo:lo + n] = x[lo:lo + n] @ w[g]
            lo += n
        return out
    return jax.pure_callback(
        host, jax.ShapeDtypeStruct((lhs.shape[0], rhs.shape[2]),
                                   jnp.float32), lhs, rhs, group_sizes)


@pytest.mark.parametrize("sizes", [[40, 0, 100, 3, 0, 1, 0, 48],
                                   [0] * 7 + [192], [24] * 8,
                                   [30, 20, 0, 10, 0, 0, 5, 7]])
def test_ragged_dot_by_group_equals_ragged_dot(sizes):
    """The host product equals the op it stands in for, empty groups and
    rows past the groups included, also traced inside ``lax.scan`` as the
    reference's forward calls it."""
    rng = np.random.default_rng(len(sizes) + sum(sizes))
    x = jnp.asarray(rng.standard_normal((192, 96)).astype(np.float32))
    w = jnp.asarray(rng.standard_normal((2, 8, 96, 40)).astype(np.float32))
    gs = jnp.asarray(np.array(sizes, np.int32))

    def scanned(op):
        return jax.lax.scan(lambda c, wl: (c, op(x, wl, gs)), 0, w)[1]
    want = np.asarray(scanned(jax.lax.ragged_dot))
    got = np.asarray(scanned(_ragged_dot_by_group))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert not got[:, sum(sizes):].any()


# ---------------------------------------------------------- full width
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def full_width():
    """deepseek-v2-lite-16b at its own widths with 2 layers (layer 0 dense,
    layer 1 MoE): NumPy-seeded weights (1.085 B, drawn once), the tokens
    ``chip_smoke.py``'s cut-depth phase runs (B 1 x 2048, the flash
    branch), the reference's logits on them, and the port's model on the
    same weights.  The NumPy leaves are handed to JAX one by one and the
    port's model is built from views of JAX's arrays, so that no more
    than two copies of the weights (8.7 GB) are held at once."""
    cfg = dataclasses.replace(get_arch(DSV2), n_layers=2)
    ref_cfg = dataclasses.replace(REF_ARCHS[DSV2], n_layers=2)
    params = interop.seeded_params(cfg, seed=0)
    ref_params = {}
    for key in list(params):
        node = params.pop(key)
        ref_params[key] = ({name: jnp.asarray(node.pop(name))
                            for name in list(node)}
                           if isinstance(node, dict) else jnp.asarray(node))
        del node
    toks = SyntheticDataset(cfg.vocab, 2048, 1, seed=0).batch(0)["tokens"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "ragged_dot", _ragged_dot_by_group)
        want = np.asarray(ref_model.forward(ref_cfg, ref_params,
                                            {"tokens": toks.numpy()}))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, ref_params),
                                 device="cpu")
    del ref_params
    return cfg, model, toks, want


def test_forward_full_width_matches_reference(full_width):
    """d_model 2048, 16 heads, MLA kv_lora 512 with qk 128 + 64 (V padded
    from 128 to 192 in the flash branch), the dense layer's d_ff 10944,
    64 experts of 1408 top-6 plus 2 shared, vocab 102400."""
    cfg, model, toks, want = full_width
    with torch.inference_mode():
        got = model(toks).numpy()
    assert got.shape == (1, 2048, 102400)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the port's own logits pass the rule the card's run is held to
    chip_smoke = _chip_smoke()
    assert chip_smoke.forward_agrees(chip_smoke.forward_summary(
        got[:, list(chip_smoke.DSV2_HELD_POSITIONS)]),
        chip_smoke.EXPECTED_DSV2)


def test_expected_deepseek_v2_lite_is_the_reference(full_width):
    """``chip_smoke.py`` holds the card's cut-depth deepseek-v2-lite forward
    to ``EXPECTED_DSV2``; these are the reference package's logits on the
    same NumPy-seeded weights and tokens, with the logits' L2 norms that
    bound the sums' tolerance."""
    chip_smoke = _chip_smoke()
    *_, want = full_width
    held = want[:, list(chip_smoke.DSV2_HELD_POSITIONS)]
    summary = chip_smoke.forward_summary(held)
    assert chip_smoke.forward_agrees(summary, chip_smoke.EXPECTED_DSV2)
    assert [s[0] for s in summary] \
        == [e[0] for e in chip_smoke.EXPECTED_DSV2]
    np.testing.assert_allclose([s[3] for s in summary],
                               [e[3] for e in chip_smoke.EXPECTED_DSV2],
                               rtol=1e-6)
