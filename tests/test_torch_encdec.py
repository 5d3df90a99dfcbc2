"""The port's encoder-decoder family (seamless-m4t-large-v2) against the
reference's, on the CPU.

The encoder runs ``n_enc_layers`` non-causal self-attention layers over
the source frames, rotated at the source positions, then ``enc_norm``;
each of the ``n_layers`` decoder layers runs causal self-attention (the
flash branch at 2048 tokens or more), cross-attention to the encoder's
output (``kv_override``: no rope, no mask, never the flash branch) and a
plain gelu MLP.  The reference nests the decoder's ``self`` and ``cross``
attention leaves under the layer-stacked ``decoder``; the port names
layer 3's ``decoder/self/wq`` slice ``decoder.3.self.wq``.  Decode reads
the encoder's K/V from a frozen cross cache that ``encode`` and
``prefill_cross_cache`` build once per request.

The reference's stub frames are zeros, which the encoder's first norm
keeps at zero (its output, and every cross K/V, is then 0); every
comparison here feeds seeded standard normals instead.  Held in float32:
the schema (nesting and order), parameters, ``seeded_params``' draw order
and caches equal the reference's; ``encode``, ``prefill_cross_cache``,
the reduced model's forward (S 64, and S 2048 through the flash branch),
eight decode steps and the greedy ids within 1e-4; the flash entry point
is called by the 24 decoder self-attention layers of a 24 + 24-layer
model and never by the encoder or a cross-attention.  The full-width
2 + 2-layer fixture (B 1 x 2048 over 2048 seeded frames, NumPy-seeded
weights) recomputes ``chip_smoke.EXPECTED_SEAMLESS``.
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
from repro.serve import decode as ref_decode  # noqa: E402
from repro.serve import kvcache as ref_kvcache  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import FLASH_MIN_SEQ  # noqa: E402
from repro_torch.serve.decode import (decode_step, encode,  # noqa: E402
                                      prefill_cross_cache)
from repro_torch.serve.kvcache import init_cache  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402
from test_torch_vlm import _views  # noqa: E402

TOL = 1e-4
SEAMLESS = "seamless-m4t-large-v2"


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
    """(reference cfg, port cfg) of ``reduced(seamless-m4t-large-v2)``: 2
    encoder and 2 decoder layers, 16 source frames."""
    return (ref_base.reduced(REF_ARCHS[SEAMLESS], **over),
            base.reduced(get_arch(SEAMLESS), **over))


def _frames(cfg, B: int, S_src: int | None = None,
            seed: int = 0) -> np.ndarray:
    """Seeded source frames (B, S_src, d_model), by default
    ``n_audio_frames`` of them."""
    return np.random.default_rng([seed, 1]).standard_normal(
        (B, S_src or cfg.n_audio_frames, cfg.d_model), dtype=np.float32)


@pytest.fixture(scope="module", params=[(2, 2), (1, 3)],
                ids=["E2D2", "E1D3"])
def reduced_pair(request):
    """(reference cfg, reference params, port cfg, port model) of the
    reduced model with (encoder, decoder) layers on the reference's
    ``init`` weights."""
    Le, Ld = request.param
    ref_cfg, cfg = _pair(n_enc_layers=Le, n_layers=Ld)
    params = ref_model.init(ref_cfg, jax.random.key(0))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, params, cfg, model


def _flat(t):
    return {k: (_flat(v) if isinstance(v, dict)
                else (v.shape, v.axes, v.init, v.scale, v.dtype))
            for k, v in t.items()}


def _leaf(tree: dict, path: tuple):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


# ------------------------------------------------- schema, parameters
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
def test_schema_equals_reference(full):
    """Same groups, nesting, leaves, shapes, scales and order: ``encoder``,
    ``enc_norm``, then ``decoder`` with ``self`` and ``cross`` nested
    before its MLP and three norms."""
    ref_cfg, cfg = ((REF_ARCHS[SEAMLESS], get_arch(SEAMLESS)) if full
                    else _pair())
    got, want = M.schema(cfg), ref_model.schema(ref_cfg)
    assert _flat(got) == _flat(want)
    assert [p for p, _ in M.leaf_paths(got)] \
        == [p for p, _ in M.leaf_paths(want)]
    assert list(got["decoder"])[:2] == ["self", "cross"]
    assert "w_gate" not in got["decoder"]          # gelu, no gate


def test_param_leaves_name_nested_slices():
    """Each port parameter is one slice of one reference leaf, at any
    depth: ``decoder.1.self.wq`` is ``decoder/self/wq[1]``."""
    _, cfg = _pair()
    leaves = {name: (path, layer) for name, path, layer, _ in
              M.param_leaves(cfg)}
    assert leaves["decoder.1.self.wq"] == (("decoder", "self", "wq"), 1)
    assert leaves["decoder.0.cross.wv"] == (("decoder", "cross", "wv"), 0)
    assert leaves["decoder.1.ln3"] == (("decoder", "ln3"), 1)
    assert leaves["encoder.1.wo"] == (("encoder", "wo"), 1)
    assert leaves["enc_norm"] == (("enc_norm",), None)
    assert len(leaves) == len({(p, layer) for p, layer in leaves.values()})


def test_param_count_equals_reference(reduced_pair):
    ref_cfg, params, cfg, model = reduced_pair
    assert sorted(dict(model.named_parameters())) \
        == sorted(name for name, *_ in M.param_leaves(cfg))
    assert sum(p.numel() for p in model.parameters()) \
        == sum(a.size for a in jax.tree.leaves(params))
    assert len(model.encoder) == cfg.n_enc_layers
    assert len(model.decoder) == cfg.n_layers and len(model.blocks) == 0


def test_model_params_round_trip(reduced_pair):
    """Every parameter of the port's model is its slice of the reference's
    ``init`` leaf, bit for bit, the nested ones included."""
    ref_cfg, params, cfg, model = reduced_pair
    got = dict(model.named_parameters())
    for name, path, layer, d in M.param_leaves(cfg):
        leaf = _leaf(params, path)
        want = leaf if layer is None else leaf[layer]
        assert tuple(got[name].shape) == want.shape, name
        np.testing.assert_array_equal(got[name].detach().numpy(), want,
                                      err_msg=name)


def test_model_params_rejects_mismatch():
    """On the nested ``decoder`` tree: a leaf of the wrong shape is a
    ``ValueError``; a leaf the port does not know, at any depth, or a
    missing one, a ``KeyError``."""
    ref_cfg, cfg = _pair()
    params = jax.tree.map(np.asarray,
                          ref_model.init(ref_cfg, jax.random.key(0)))
    dec = params["decoder"]

    def with_decoder(**over):
        return dict(params, decoder=dict(dec, **over))
    with pytest.raises(ValueError, match="decoder/self/wq"):
        interop.model_params(cfg, with_decoder(self=dict(
            dec["self"], wq=dec["self"]["wq"][:, :, :-1])), device="cpu")
    with pytest.raises(KeyError, match="decoder/cross/extra"):
        interop.model_params(cfg, with_decoder(cross=dict(
            dec["cross"], extra=np.zeros(3))), device="cpu")
    with pytest.raises(KeyError, match="decoder/more/deep/leaf"):
        interop.model_params(cfg, with_decoder(
            more={"deep": {"leaf": np.zeros(3)}}), device="cpu")
    with pytest.raises(KeyError):
        interop.model_params(cfg, with_decoder(cross={
            k: v for k, v in dec["cross"].items() if k != "wv"}),
            device="cpu")


def test_seeded_params_draw_in_schema_order():
    """``seeded_params`` draws the leaves depth first in the reference
    schema's order (``decoder/self/*``, then ``decoder/cross/*``, then
    the decoder's MLP and norms) from one ``default_rng(seed)`` stream."""
    ref_cfg, cfg = _pair()
    got = interop.seeded_params(cfg, seed=3)
    rng = np.random.default_rng(3)
    paths = [p for p, _ in M.leaf_paths(ref_model.schema(ref_cfg))]
    assert [p for p, _ in M.leaf_paths(got)] == paths
    for path, d in M.leaf_paths(ref_model.schema(ref_cfg)):
        if d.init == "normal":
            want = rng.standard_normal(d.shape, dtype=np.float32) \
                * np.float32(d.scale)
            np.testing.assert_array_equal(_leaf(got, path), want)
        else:
            assert np.all(_leaf(got, path) == (d.init == "ones"))


@pytest.mark.parametrize("src_len", [None, 16, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_equals_reference(dtype, src_len):
    """``self``: the decoder's k/v over ``max_seq``; ``cross``: its k/v
    over ``src_len`` source positions (``max_seq`` when not given)."""
    ref_cfg, cfg = _pair(n_layers=3)
    got = init_cache(cfg, 2, 12, dtype=getattr(torch, dtype), device="cpu",
                     src_len=src_len)
    want = ref_kvcache.init_cache(ref_cfg, 2, 12, dtype=getattr(jnp, dtype),
                                  src_len=src_len)
    assert got.keys() == want.keys() == {"self", "cross"}
    for group in got:
        assert got[group].keys() == want[group].keys()
        for leaf, g in got[group].items():
            w = want[group][leaf]
            assert tuple(g.shape) == w.shape and not bool(g.any())
            assert str(g.dtype).replace("torch.", "") == str(w.dtype)
    assert got["cross"]["k"].shape[3] == (src_len or 12)


# ---------------------------------------------- encode, cross caches
def test_encode_matches_reference(reduced_pair):
    """The encoder stack over seeded frames, with rope at the source
    positions and no mask, then ``enc_norm``."""
    ref_cfg, params, cfg, model = reduced_pair
    frames = _frames(cfg, 2, 24)
    want = np.asarray(ref_decode.encode(ref_cfg, params,
                                        jnp.asarray(frames)))
    got = encode(model, torch.from_numpy(frames)).numpy()
    assert got.shape == frames.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("which", ["decoder", "cross"])
def test_prefill_cross_cache_matches_reference(reduced_pair, which):
    """(L, B, Hkv, S_src, Dh) K and V of every decoder layer's cross
    attention over the encoder's output; the model has no top-level
    ``cross``, so both spellings read the decoder's, as the
    reference's."""
    ref_cfg, params, cfg, model = reduced_pair
    frames = _frames(cfg, 3)
    enc = ref_decode.encode(ref_cfg, params, jnp.asarray(frames))
    want = ref_decode.prefill_cross_cache(ref_cfg, params, enc, which=which)
    got = prefill_cross_cache(model, encode(model, torch.from_numpy(frames)),
                              which=which)
    assert got.keys() == want.keys() == {"k", "v"}
    for name in got:
        assert tuple(got[name].shape) == want[name].shape \
            == (cfg.n_layers, 3, cfg.n_kv_heads, cfg.n_audio_frames,
                cfg.head_dim_)
        np.testing.assert_allclose(got[name].numpy(),
                                   np.asarray(want[name]), atol=TOL,
                                   rtol=TOL)


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_forward_matches_reference(reduced_pair, S):
    """S = 64 takes the plain attention in both packages, S = 2048 the
    flash branch in the decoder's self-attention of both; the encoder
    runs over 16 seeded frames."""
    ref_cfg, params, cfg, model = reduced_pair
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    frames = _frames(cfg, 2)
    want = np.asarray(ref_model.forward(
        ref_cfg, params, {"tokens": toks, "enc_embed": frames}))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks),
                    enc_embed=torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_frames_reach_the_logits(reduced_pair):
    """Zero frames (the reference's stubs) give a zero encoder output and
    zero cross K/V; seeded ones move the logits, so the comparisons above
    see the encoder and the cross path."""
    *_, cfg, model = reduced_pair
    toks = torch.zeros((2, 16), dtype=torch.int64)
    frames = torch.from_numpy(_frames(cfg, 2))
    with torch.inference_mode():
        assert not bool(encode(model, torch.zeros_like(frames)).any())
        zero = model(toks, enc_embed=torch.zeros_like(frames))
        seeded = model(toks, enc_embed=frames)
    assert float((zero - seeded).abs().max()) > 1e-3


def test_forward_needs_frames(reduced_pair):
    *_, model = reduced_pair
    with pytest.raises(ValueError, match="enc_embed"):
        model(torch.zeros((1, 4), dtype=torch.int64))


@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_flash_only_in_decoder_self_attention(monkeypatch, S):
    """At seamless's depth (24 encoder + 24 decoder layers; reduced
    widths) over 2048 frames, an S-token forward calls the flash entry
    point once per decoder self-attention at S = 2048, 24 times, each
    causal over the text, and never for the encoder's self-attention
    (non-causal over 2048 frames) or a cross-attention."""
    cfg = base.reduced(get_arch(SEAMLESS), n_enc_layers=24, n_layers=24)
    model = M.init(cfg, seed=0, device="cpu")
    seen = []
    orig = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), kw.get("causal")))
        return orig(q, k, v, **kw)
    monkeypatch.setattr(layers, "flash_attention", spy)
    frames = torch.from_numpy(_frames(cfg, 1, FLASH_MIN_SEQ))
    with torch.inference_mode():
        model(torch.zeros((1, S), dtype=torch.int64), enc_embed=frames)
    assert len(model.encoder) == len(model.decoder) == 24
    if S < FLASH_MIN_SEQ:
        assert seen == []
    else:
        assert seen == [((1, cfg.n_heads, S, cfg.head_dim_), True)] * 24


# -------------------------------------------------------------- decode
def _prompts(cfg, B, S):
    return SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]


def _ref_step(ref_cfg, params):
    return jax.jit(lambda c, t, p: ref_decode.decode_step(ref_cfg, params,
                                                          c, t, p))


def _caches_both(ref_cfg, params, cfg, model, B, T, frames):
    """Empty self caches and the cross caches built from ``frames`` by
    ``encode`` and ``prefill_cross_cache``, in both packages."""
    src_len = frames.shape[1]
    ref_caches = ref_kvcache.init_cache(ref_cfg, B, T, src_len=src_len)
    ref_caches["cross"] = ref_decode.prefill_cross_cache(
        ref_cfg, params, ref_decode.encode(ref_cfg, params,
                                           jnp.asarray(frames)),
        which="decoder")
    caches = init_cache(cfg, B, T, device="cpu", src_len=src_len)
    caches["cross"] = prefill_cross_cache(
        model, encode(model, torch.from_numpy(frames)), which="decoder")
    return ref_caches, caches


def test_decode_matches_reference(reduced_pair):
    """Eight steps from empty self caches with the cross cache prefilled:
    the logits of each step, then the self caches written in place and
    the cross cache left as it was."""
    ref_cfg, params, cfg, model = reduced_pair
    B, T = 2, 8
    toks = _prompts(cfg, B, T)
    step = _ref_step(ref_cfg, params)
    ref_caches, caches = _caches_both(ref_cfg, params, cfg, model, B, T,
                                      _frames(cfg, B))
    held = dict(caches["self"])
    frozen = {k: v.clone() for k, v in caches["cross"].items()}
    for t in range(T):
        want, ref_caches = step(ref_caches, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        assert got.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=f"step {t}")
    for leaf, tensor in held.items():
        assert caches["self"][leaf] is tensor
        np.testing.assert_allclose(tensor.numpy(),
                                   np.asarray(ref_caches["self"][leaf]),
                                   atol=TOL, rtol=TOL)
    for k, v in frozen.items():
        assert torch.equal(caches["cross"][k], v)


def test_decode_matches_forward(reduced_pair):
    """Cache correctness: decode logits at t equal the forward's at t."""
    ref_cfg, params, cfg, model = reduced_pair
    B, T = 2, 12
    toks, frames = _prompts(cfg, B, T), _frames(cfg, B)
    with torch.inference_mode():
        fwd = model(toks, enc_embed=torch.from_numpy(frames))
    _, caches = _caches_both(ref_cfg, params, cfg, model, B, T, frames)
    for t in range(T):
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        np.testing.assert_allclose(got[:, 0].numpy(), fwd[:, t].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=f"t={t}")


def test_greedy_ids_equal_reference_loop(reduced_pair):
    """The serve driver's ``generate`` and the reference driver's loop
    (encode the frames, prefill the cross cache, prefill token by token,
    then greedy) pick the same tokens; no step's top-2 logit gap is small
    enough for a rounding difference to flip the pick."""
    ref_cfg, params, cfg, model = reduced_pair
    B, S, gen = 3, 12, 10
    prompts, frames = _prompts(cfg, B, S), _frames(cfg, B)
    step = _ref_step(ref_cfg, params)
    caches, _ = _caches_both(ref_cfg, params, cfg, model, B, S + gen,
                             frames)
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
                               enc_embed=torch.from_numpy(frames))
    assert min(gaps) > 1e-4, gaps
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=1))


def test_serve_main_on_cpu(capsys):
    rc = serve.main(["--arch", SEAMLESS, "--reduced", "--batch", "2",
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


@pytest.fixture(scope="module")
def full_width():
    """seamless-m4t-large-v2 at its own widths with 2 encoder and 2 decoder
    layers (0.62 B parameters, most of them the untied 256206-token
    embedding and unembedding): NumPy-seeded weights, the tokens and
    frames ``chip_smoke.py``'s cut-depth phase runs (B 1 x 2048 over 2048
    frames: the decoder's self-attention through the flash branch), the
    reference's logits on them and the port's model on the same weights,
    one copy of them (``_views``)."""
    chip_smoke = _chip_smoke()
    over = dict(n_enc_layers=2, n_layers=2)
    cfg = dataclasses.replace(get_arch(SEAMLESS), **over)
    ref_cfg = dataclasses.replace(REF_ARCHS[SEAMLESS], **over)
    ref_params, model = _views(cfg, interop.seeded_params(cfg, seed=0))
    toks = SyntheticDataset(cfg.vocab, 2048, 1, seed=0).batch(0)["tokens"]
    frames = chip_smoke.seeded_source((1, 2048, cfg.d_model))
    want = np.asarray(ref_model.forward(ref_cfg, ref_params, {
        "tokens": toks.numpy(), "enc_embed": frames}))
    del ref_params
    return cfg, model, toks, frames, want


def test_forward_full_width_matches_reference(full_width):
    """d_model 1024, 16 heads of 64, d_ff 8192 (gelu), vocab 256206."""
    cfg, model, toks, frames, want = full_width
    with torch.inference_mode():
        got = model(toks, enc_embed=torch.from_numpy(frames)).numpy()
    assert got.shape == (1, 2048, 256206)
    # compared 256 positions at a time: the whole (1, 2048, V) logits
    # would take several more GB of temporaries
    for lo in range(0, 2048, 256):
        np.testing.assert_allclose(got[:, lo:lo + 256], want[:, lo:lo + 256],
                                   atol=TOL, rtol=TOL, err_msg=f"from {lo}")
    chip_smoke = _chip_smoke()
    assert chip_smoke.forward_agrees(chip_smoke.forward_summary(
        got[:, list(chip_smoke.SEAMLESS_HELD_POSITIONS)]),
        chip_smoke.EXPECTED_SEAMLESS)


def test_expected_seamless_is_the_reference(full_width):
    """``chip_smoke.py`` holds the card's cut-depth seamless forward to
    ``EXPECTED_SEAMLESS``; these are the reference package's logits on
    the same NumPy-seeded weights, tokens and frames, with the logits' L2
    norms that bound the sums' tolerance."""
    chip_smoke = _chip_smoke()
    *_, want = full_width
    summary = chip_smoke.forward_summary(
        want[:, list(chip_smoke.SEAMLESS_HELD_POSITIONS)])
    assert chip_smoke.forward_agrees(summary, chip_smoke.EXPECTED_SEAMLESS)
    assert [s[0] for s in summary] \
        == [e[0] for e in chip_smoke.EXPECTED_SEAMLESS]
    np.testing.assert_allclose([s[3] for s in summary],
                               [e[3] for e in chip_smoke.EXPECTED_SEAMLESS],
                               rtol=1e-6)
