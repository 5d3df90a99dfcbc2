"""The port's VLM family (llama-3.2-vision-11b) against the reference's, on
the CPU.

A VLM's text stack runs G groups, each of k dense self-attention layers
(``blocks``) and one cross layer (``cross``) whose attention takes its
queries from the text and its keys and values from the vision embeddings
(``gqa_attention``'s ``kv_override``: no rope, no mask, never the flash
branch).  Decode reads the vision K/V from a frozen cross cache that
``prefill_cross_cache`` builds once per request.

The reference's stub vision embeddings are zeros, under which every cross
layer adds exactly nothing; every comparison here feeds seeded standard
normals instead.  Held in float32: the schema, parameters and caches
equal the reference's; ``gqa_attention`` with ``kv_override`` and the
cached cross-attention within 1e-5; the reduced model's forward (S 64,
and S 2048 through the flash branch), ``prefill_cross_cache``, eight
decode steps and the greedy ids within 1e-4; the flash entry point is
called by the 32 self-attention layers of a 40-layer model and by no
cross layer.  The full-width five-layer fixture (one group, B 1 x 2048,
NumPy-seeded weights and vision embeddings) recomputes
``chip_smoke.EXPECTED_VLM``.
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
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.serve import decode as ref_decode  # noqa: E402
from repro.serve import kvcache as ref_kvcache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import FLASH_MIN_SEQ  # noqa: E402
from repro_torch.serve.decode import (decode_step,  # noqa: E402
                                      prefill_cross_cache)
from repro_torch.serve.kvcache import init_cache  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402

TOL = 1e-4
LAYER_TOL = 1e-5
VLM = "llama-3.2-vision-11b"


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
    """(reference cfg, port cfg) of ``reduced(llama-3.2-vision-11b)``: one
    group of 2 self layers and a cross layer, 8 vision tokens."""
    return (ref_base.reduced(REF_ARCHS[VLM], **over),
            base.reduced(get_arch(VLM), **over))


def _vision(cfg, B: int, seed: int = 0) -> np.ndarray:
    """Seeded vision embeddings (B, n_vision_tokens, d_model)."""
    return np.random.default_rng([seed, 1]).standard_normal(
        (B, cfg.n_vision_tokens, cfg.d_model), dtype=np.float32)


@pytest.fixture(scope="module", params=[1, 2], ids=["G1", "G2"])
def reduced_pair(request):
    """(reference cfg, reference params, port cfg, port model) of the
    reduced VLM with G groups on the reference's ``init`` weights."""
    ref_cfg, cfg = _pair(n_layers=3 * request.param)
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
def test_schema_equals_reference(full):
    """Same groups, leaves, shapes, scales and order (``seeded_params``
    draws in that order): ``blocks`` of G·k self layers, ``cross`` of G
    layers with three norms."""
    ref_cfg, cfg = (REF_ARCHS[VLM], get_arch(VLM)) if full else _pair()
    got, want = M.schema(cfg), ref_model.schema(ref_cfg)
    assert _flat(got) == _flat(want)
    assert list(got) == list(want)
    for group in ("blocks", "cross"):
        assert list(got[group]) == list(want[group])
    assert {"ln1", "ln2", "ln3"} <= got["cross"].keys()
    if full:
        assert got["blocks"]["wq"].shape[0] == 32
        assert got["cross"]["wq"].shape[0] == 8


def test_param_count_equals_reference(reduced_pair):
    ref_cfg, params, cfg, model = reduced_pair
    assert sorted(dict(model.named_parameters())) \
        == sorted(name for name, *_ in M.param_leaves(cfg))
    assert sum(p.numel() for p in model.parameters()) \
        == sum(a.size for a in jax.tree.leaves(params))
    G = cfg.n_layers // 3
    assert len(model.blocks) == 2 * G and len(model.cross) == G


def test_model_params_round_trip(reduced_pair):
    """Every parameter of the port's model is its slice of the reference's
    ``init`` leaf, bit for bit: ``cross.0.ln3`` too, which no forward
    reads."""
    ref_cfg, params, cfg, model = reduced_pair
    got = dict(model.named_parameters())
    assert "cross.0.ln3" in got
    for name, path, layer, d in M.param_leaves(cfg):
        leaf = np.asarray(params[path[0]] if len(path) == 1
                          else params[path[0]][path[1]])
        want = leaf if layer is None else leaf[layer]
        assert tuple(got[name].shape) == want.shape, name
        np.testing.assert_array_equal(got[name].detach().numpy(), want,
                                      err_msg=name)


def test_model_params_rejects_mismatch():
    """A cross leaf of the wrong shape is a ``ValueError``; a leaf the
    port does not know, or a missing one, a ``KeyError``."""
    ref_cfg, cfg = _pair()
    params = jax.tree.map(np.asarray,
                          ref_model.init(ref_cfg, jax.random.key(0)))
    cross = params["cross"]
    with pytest.raises(ValueError, match="cross/wk"):
        interop.model_params(cfg, dict(params, cross=dict(
            cross, wk=cross["wk"][:, :-1])), device="cpu")
    with pytest.raises(KeyError, match="cross/extra"):
        interop.model_params(cfg, dict(params, cross=dict(
            cross, extra=np.zeros(3))), device="cpu")
    with pytest.raises(KeyError):
        interop.model_params(cfg, dict(params, cross={
            k: v for k, v in cross.items() if k != "ln3"}), device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_equals_reference(dtype):
    """``blocks``: the G·k self layers' k/v over ``max_seq``; ``cross``:
    the G cross layers' over the vision tokens."""
    ref_cfg, cfg = _pair(n_layers=6)
    got = init_cache(cfg, 3, 16, dtype=getattr(torch, dtype), device="cpu")
    want = ref_kvcache.init_cache(ref_cfg, 3, 16, dtype=getattr(jnp, dtype))
    assert got.keys() == want.keys() == {"blocks", "cross"}
    for group in got:
        assert got[group].keys() == want[group].keys()
        for leaf, g in got[group].items():
            w = want[group][leaf]
            assert tuple(g.shape) == w.shape and not bool(g.any())
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    assert tuple(got["cross"]["k"].shape) == (2, 3, 2, 8, 16)


# ------------------------------------------------------- layer level
def _attn_leaves(cfg, seed: int) -> dict:
    sch = layers.gqa_schema(cfg, 1)
    rng = np.random.default_rng(seed)
    return {name: (rng.standard_normal(d.shape[1:]) * 0.2).astype(
        np.float32) for name, d in sch.items()}


def _attn_module(leaves: dict) -> M.Leaves:
    p = M.Leaves({k: v.shape for k, v in leaves.items()}, device="cpu",
                 dtype=torch.float32)
    with torch.no_grad():
        for k, v in leaves.items():
            getattr(p, k).copy_(torch.from_numpy(v))
    return p


@pytest.mark.parametrize("S", [10, FLASH_MIN_SEQ])
def test_kv_override_matches_reference(S, monkeypatch):
    """``gqa_attention(kv_override=(src,))``: K/V projected from ``src``
    without rope, Q not rotated though a rope table is passed, no mask;
    at S = ``FLASH_MIN_SEQ`` still the plain softmax, never the flash
    entry point."""
    _, cfg = _pair()
    leaves = _attn_leaves(cfg, S)
    rng = np.random.default_rng(S + 1)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    src = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    cos, sin = layers.rope_freqs(cfg.head_dim_, cfg.rope_theta,
                                 torch.arange(S))
    want, _ = ref_layers.gqa_attention(
        {k: jnp.asarray(v) for k, v in leaves.items()}, jnp.asarray(x),
        jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        kv_override=(jnp.asarray(src),))
    monkeypatch.setattr(layers, "flash_attention", None)
    with torch.inference_mode():
        got, cache = layers.gqa_attention(
            _attn_module(leaves), torch.from_numpy(x), cos, sin,
            n_heads=cfg.n_heads, kv_override=(torch.from_numpy(src),))
    assert cache is None and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


def test_cross_attention_matches_reference():
    """Attention to a frozen K/V cache, the reference's
    ``_cross_from_cache``, with 4 query heads over 2 KV heads."""
    _, cfg = _pair()
    leaves = _attn_leaves(cfg, 3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    k, v = (rng.standard_normal((3, cfg.n_kv_heads, 9, cfg.head_dim_))
            .astype(np.float32) for _ in range(2))
    want, _ = ref_decode._cross_from_cache(
        {n: jnp.asarray(a) for n, a in leaves.items()}, jnp.asarray(x),
        {"k": jnp.asarray(k), "v": jnp.asarray(v)}, cfg)
    with torch.inference_mode():
        got = layers.cross_attention(_attn_module(leaves),
                                     torch.from_numpy(x),
                                     torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_TOL, rtol=LAYER_TOL)


# ------------------------------------------------------------- forward
def _forward_both(ref_cfg, params, model, toks, vis):
    want = np.asarray(ref_model.forward(
        ref_cfg, params, {"tokens": toks, "vision_embed": vis}))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks),
                    vision_embed=torch.from_numpy(vis)).numpy()
    return got, want


@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_forward_matches_reference(reduced_pair, S):
    """S = 64 takes the plain attention in both packages, S = 2048 the
    flash branch in the self layers of both; the cross layers attend to
    seeded vision embeddings."""
    ref_cfg, params, cfg, model = reduced_pair
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    got, want = _forward_both(ref_cfg, params, model, toks, _vision(cfg, 2))
    assert got.shape == want.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_vision_embeddings_reach_the_logits(reduced_pair):
    """Zero vision embeddings (the reference's stubs) give zero cross K/V,
    so the cross layers add nothing; seeded ones move the logits, so the
    comparisons above see the cross path."""
    *_, cfg, model = reduced_pair
    toks = torch.zeros((2, 16), dtype=torch.int64)
    vis = torch.from_numpy(_vision(cfg, 2))
    with torch.inference_mode():
        zero = model(toks, vision_embed=torch.zeros_like(vis))
        seeded = model(toks, vision_embed=vis)
    assert float((zero - seeded).abs().max()) > 1e-3


def test_forward_needs_vision_embeddings(reduced_pair):
    *_, model = reduced_pair
    with pytest.raises(ValueError, match="vision_embed"):
        model(torch.zeros((1, 4), dtype=torch.int64))


@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_flash_only_in_self_layers(monkeypatch, S):
    """At llama-3.2-vision's depth (40 layers: 8 groups of 4 self layers
    and a cross layer; reduced widths), a 2048-token forward calls the
    flash entry point once per self layer, 32 times, each causal, and
    never for a cross layer; a 64-token forward never."""
    cfg = base.reduced(get_arch(VLM), n_layers=40, cross_attn_every=4)
    model = M.init(cfg, seed=0, device="cpu")
    seen = []
    orig = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(k.shape), kw.get("causal")))
        return orig(q, k, v, **kw)
    monkeypatch.setattr(layers, "flash_attention", spy)
    vis = torch.from_numpy(_vision(cfg, 1))
    with torch.inference_mode():
        model(torch.zeros((1, S), dtype=torch.int64), vision_embed=vis)
    assert len(model.blocks) == 32 and len(model.cross) == 8
    if S < FLASH_MIN_SEQ:
        assert seen == []
    else:
        assert len(seen) == 32
        assert all(causal is True and shape[2] == S
                   for shape, causal in seen)


# -------------------------------------------------------------- decode
def test_prefill_cross_cache_matches_reference(reduced_pair):
    """(G, B, Hkv, Nv, Dh) K and V of every cross layer over the vision
    embeddings, without rope."""
    ref_cfg, params, cfg, model = reduced_pair
    vis = _vision(cfg, 3)
    want = ref_decode.prefill_cross_cache(ref_cfg, params, jnp.asarray(vis))
    got = prefill_cross_cache(model, torch.from_numpy(vis))
    assert got.keys() == want.keys() == {"k", "v"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape \
            == (len(model.cross), 3, cfg.n_kv_heads, cfg.n_vision_tokens,
                cfg.head_dim_)
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), atol=LAYER_TOL,
                                   rtol=LAYER_TOL)


def _prompts(cfg, B, S):
    return SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]


def _ref_step(ref_cfg, params):
    return jax.jit(lambda c, t, p: ref_decode.decode_step(ref_cfg, params,
                                                          c, t, p))


def test_decode_matches_reference(reduced_pair):
    """Eight steps from empty self caches with the cross cache prefilled:
    the logits of each step, then the self caches written in place and
    the cross cache left as it was."""
    ref_cfg, params, cfg, model = reduced_pair
    B, T = 2, 8
    toks, vis = _prompts(cfg, B, T), _vision(cfg, B)
    step = _ref_step(ref_cfg, params)
    ref_caches = ref_kvcache.init_cache(ref_cfg, B, T)
    ref_caches["cross"] = ref_decode.prefill_cross_cache(ref_cfg, params,
                                                         jnp.asarray(vis))
    caches = init_cache(cfg, B, T, device="cpu")
    caches["cross"] = prefill_cross_cache(model, torch.from_numpy(vis))
    held = {g: dict(c) for g, c in caches.items()}
    frozen = {k: v.clone() for k, v in caches["cross"].items()}
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
    for k, v in frozen.items():
        assert torch.equal(caches["cross"][k], v)


def test_decode_matches_forward(reduced_pair):
    """Cache correctness: decode logits at t equal the forward's at t."""
    *_, cfg, model = reduced_pair
    B, T = 2, 12
    toks, vis = _prompts(cfg, B, T), torch.from_numpy(_vision(cfg, B))
    with torch.inference_mode():
        fwd = model(toks, vision_embed=vis)
    caches = init_cache(cfg, B, T, device="cpu")
    caches["cross"] = prefill_cross_cache(model, vis)
    for t in range(T):
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        np.testing.assert_allclose(got[:, 0].numpy(), fwd[:, t].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=f"t={t}")


def test_greedy_ids_equal_reference_loop(reduced_pair):
    """The serve driver's ``generate`` and the reference driver's loop
    (cross cache from the vision embeddings, prefill token by token, then
    greedy) pick the same tokens; no step's top-2 logit gap is small
    enough for a rounding difference to flip the pick."""
    ref_cfg, params, cfg, model = reduced_pair
    B, S, gen = 3, 12, 10
    prompts, vis = _prompts(cfg, B, S), _vision(cfg, B)
    step = _ref_step(ref_cfg, params)
    caches = ref_kvcache.init_cache(ref_cfg, B, S + gen)
    caches["cross"] = ref_decode.prefill_cross_cache(ref_cfg, params,
                                                     jnp.asarray(vis))
    logits, gaps, want = None, [], []
    for t in range(S + gen):
        tok = (jnp.asarray(prompts[:, t:t + 1]) if t < S
               else jnp.argmax(logits[:, -1], axis=-1)[:, None])
        if t >= S:
            want.append(np.asarray(tok))
            top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
            gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
        logits, caches = step(caches, tok, jnp.int32(t))
    got, _, _ = serve.generate(model, prompts, gen,
                               vision_embed=torch.from_numpy(vis))
    assert min(gaps) > 1e-4, gaps
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_serve_main_on_cpu(capsys):
    rc = serve.main(["--arch", VLM, "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
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


def _views(cfg, params: dict):
    """The NumPy-seeded ``params`` as one copy in torch's 64-byte-aligned
    memory, leaf by leaf (each NumPy leaf freed once copied); returns
    (the reference's tree of JAX arrays aliasing it through DLPack, the
    port's model whose parameters are slices of it)."""
    held = {}
    for path in [path for path, _ in M.leaf_paths(params)]:
        node = params
        for key in path[:-1]:
            node = node[key]
        held[path] = torch.from_numpy(node.pop(path[-1])).clone()
    ref_params: dict = {}
    for path, t in held.items():
        node = ref_params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.from_dlpack(t)
    model = M.Transformer(cfg, device="cpu")   # storage never touched
    for name, path, layer, _ in M.param_leaves(cfg):
        module, _, leaf = name.rpartition(".")
        t = held[path] if layer is None else held[path][layer]
        setattr(model.get_submodule(module) if module else model, leaf,
                torch.nn.Parameter(t, requires_grad=False))
    return ref_params, model


@pytest.fixture(scope="module")
def full_width():
    """llama-3.2-vision-11b at its own widths with 5 layers (one group of
    4 self layers and its cross layer; 2.14 B parameters, 8.6 GB):
    NumPy-seeded weights, the tokens and vision embeddings
    ``chip_smoke.py``'s cut-depth phase runs (B 1 x 2048, the flash
    branch; 1600 vision tokens), the reference's logits on them and the
    port's model on the same weights.  One copy of the weights is held:
    the reference reads it through DLPack, the port through views."""
    chip_smoke = _chip_smoke()
    cfg = dataclasses.replace(get_arch(VLM), n_layers=5)
    ref_cfg = dataclasses.replace(REF_ARCHS[VLM], n_layers=5)
    ref_params, model = _views(cfg, interop.seeded_params(cfg, seed=0))
    toks = SyntheticDataset(cfg.vocab, 2048, 1, seed=0).batch(0)["tokens"]
    vis = chip_smoke.seeded_source((1, cfg.n_vision_tokens, cfg.d_model))
    want = np.asarray(ref_model.forward(ref_cfg, ref_params, {
        "tokens": toks.numpy(), "vision_embed": vis}))
    del ref_params
    return cfg, model, toks, vis, want


def test_forward_full_width_matches_reference(full_width):
    """d_model 4096, 32 heads of 128 over 8 KV heads, d_ff 14336, vocab
    128256: 4 flash self layers and a cross layer over 1600 tokens."""
    cfg, model, toks, vis, want = full_width
    with torch.inference_mode():
        got = model(toks, vision_embed=torch.from_numpy(vis)).numpy()
    assert got.shape == (1, 2048, 128256)
    # compared 256 positions at a time: the whole (1, 2048, V) logits
    # would take several more GB of temporaries
    for lo in range(0, 2048, 256):
        np.testing.assert_allclose(got[:, lo:lo + 256], want[:, lo:lo + 256],
                                   atol=TOL, rtol=TOL, err_msg=f"from {lo}")
    # the port's own logits pass the rule the card's run is held to
    chip_smoke = _chip_smoke()
    assert chip_smoke.forward_agrees(chip_smoke.forward_summary(
        got[:, list(chip_smoke.VLM_HELD_POSITIONS)]),
        chip_smoke.EXPECTED_VLM)


def test_expected_vlm_is_the_reference(full_width):
    """``chip_smoke.py`` holds the card's cut-depth llama-3.2-vision
    forward to ``EXPECTED_VLM``; these are the reference package's logits
    on the same NumPy-seeded weights, tokens and vision embeddings, with
    the logits' L2 norms that bound the sums' tolerance."""
    chip_smoke = _chip_smoke()
    *_, want = full_width
    summary = chip_smoke.forward_summary(
        want[:, list(chip_smoke.VLM_HELD_POSITIONS)])
    assert chip_smoke.forward_agrees(summary, chip_smoke.EXPECTED_VLM)
    assert [s[0] for s in summary] \
        == [e[0] for e in chip_smoke.EXPECTED_VLM]
    np.testing.assert_allclose([s[3] for s in summary],
                               [e[3] for e in chip_smoke.EXPECTED_VLM],
                               rtol=1e-6)


# ---------------------------------------------- the noise-floor rule
@pytest.mark.parametrize("fault", [None, "column", "argmax"])
def test_floor_verdict_rejects_a_fault(fault):
    """``chip_smoke.floor_verdict``, which holds the 40-layer forward and
    its decode steps on the card: logits as far from the plain ones as
    float32 noise of the reblocked plain forward pass; one vocabulary
    column off by 1e-2, or one clear argmax moved, fails."""
    chip_smoke = _chip_smoke()
    g = torch.Generator().manual_seed(0)
    plain = torch.randn((2, 64, 500), generator=g)
    reblocked = plain + 1e-5 * torch.randn(plain.shape, generator=g)
    got = plain + 1.5e-5 * torch.randn(plain.shape, generator=g)
    if fault == "column":
        got[..., 17] += 1e-2
    elif fault == "argmax":
        row = plain[0, 5]
        got[0, 5, row.argmin()] = row.max() + 1.0
    floor = chip_smoke.allowance_ratio(reblocked, plain)
    verdict = chip_smoke.floor_verdict(got, plain, floor)
    assert 0 < floor < 1
    assert verdict["ok"] == (fault is None), verdict
    assert verdict["argmax_ok"] == (fault != "argmax")
