"""The port's MLA attention (minicpm3-4b) against the reference's, on the
CPU.

Multi-head latent attention keeps one compressed latent per token, ``ckv``
(kv_lora + rope columns), instead of per-head keys and values.  Decode and
short prefills score queries against it in the *absorbed* form; a causal
prefill of ``FLASH_MIN_SEQ`` tokens or more without a cache expands the
per-head K and V and runs the flash attention with V padded to K's head
dim.  The reduced minicpm3 is taken as ``reduced`` makes it (``q_lora_rank``
0: the ``wq`` projection) and with ``q_lora_rank`` 16 (``w_dq``/``w_uq``,
minicpm3's own form).  Its schema and caches must equal the reference's;
the forward (absorbed at S 64, flash at ``FLASH_MIN_SEQ``), ten decode
steps with the ``ckv`` cache and the greedy ids are held to the
reference's on the same parameters in float32 within atol = rtol = 1e-4,
as the dense stack is.  The full-width 2-layer fixture (B 1 x 2048, the
flash branch with V padded 64 -> 96; NumPy-seeded weights) recomputes
``chip_smoke.EXPECTED_MINICPM3``.
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
from repro_torch.serve.decode import decode_step  # noqa: E402
from repro_torch.serve.kvcache import init_cache  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402

TOL = 1e-4
NAME = "minicpm3-4b"
Q_LORA = [0, 16]


@pytest.fixture(autouse=True)
def _highest_precision_one_thread():
    """float32 products in full float32; one intra-op thread per worker."""
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_num_threads(n)


def _pair(q_lora: int):
    """(reference cfg, port cfg) of reduced minicpm3 with ``q_lora_rank``
    ``q_lora``."""
    out = []
    for cfg in (ref_base.reduced(REF_ARCHS[NAME]),
                base.reduced(get_arch(NAME))):
        out.append(dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, q_lora_rank=q_lora)))
    return tuple(out)


@pytest.fixture(scope="module", params=Q_LORA, ids=lambda q: f"q_lora{q}")
def reduced_pair(request):
    """(reference cfg, reference params, port cfg, port model) of reduced
    minicpm3 on the same weights."""
    ref_cfg, cfg = _pair(request.param)
    params = ref_model.init(ref_cfg, jax.random.key(0))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, params, cfg, model


# ------------------------------------------------------ schema, caches
@pytest.mark.parametrize("q_lora", [None] + Q_LORA)
def test_schema_equals_reference(q_lora):
    """The MLA leaves (``w_dkv``, ``w_uk``, ``w_uv``, ``wo`` and ``w_dq`` +
    ``w_uq`` or ``wq``) at full width (None) and reduced."""
    def flat(t):
        return {k: (flat(v) if isinstance(v, dict)
                    else (v.shape, v.axes, v.init, v.scale, v.dtype))
                for k, v in t.items()}
    ref_cfg, cfg = ((REF_ARCHS[NAME], get_arch(NAME)) if q_lora is None
                    else _pair(q_lora))
    got = M.schema(cfg)
    assert flat(got) == flat(ref_model.schema(ref_cfg))
    q_keys = {"w_dq", "w_uq"} if cfg.mla.q_lora_rank else {"wq"}
    assert q_keys <= got["blocks"].keys()
    assert "wk" not in got["blocks"]


def test_param_count_equals_reference(reduced_pair):
    ref_cfg, params, cfg, model = reduced_pair
    assert sorted(dict(model.named_parameters())) \
        == sorted(name for name, *_ in M.param_leaves(cfg))
    assert sum(p.numel() for p in model.parameters()) \
        == sum(a.size for a in jax.tree.leaves(params))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_equals_reference(dtype):
    """One latent cache, ``ckv`` (L, B, S_max, lora + rope)."""
    ref_cfg, cfg = _pair(16)
    got = init_cache(cfg, 3, 16, dtype=getattr(torch, dtype), device="cpu")
    want = ref_kvcache.init_cache(ref_cfg, 3, 16, dtype=getattr(jnp, dtype))
    assert got.keys() == want.keys() == {"blocks"}
    assert got["blocks"].keys() == want["blocks"].keys() == {"ckv"}
    g, w = got["blocks"]["ckv"], want["blocks"]["ckv"]
    assert tuple(g.shape) == w.shape and not bool(g.any())
    assert str(g.dtype).replace("torch.", "") == str(w.dtype)


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_forward_matches_reference(reduced_pair, S):
    """S = 64 takes the absorbed form in both packages, S = 2048 the
    expanded form through the flash attention in both."""
    ref_cfg, params, cfg, model = reduced_pair
    toks = np.random.default_rng(S).integers(
        0, cfg.vocab, (2, S)).astype(np.int32)
    want = np.asarray(ref_model.forward(ref_cfg, params, {"tokens": toks}))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    assert got.shape == want.shape == (2, S, cfg.vocab)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_flash_branch_pads_v_to_k_head_dim(reduced_pair, monkeypatch, S):
    """At ``FLASH_MIN_SEQ`` every layer hands the flash attention q and k
    of nope + rope columns and V zero-padded from ``v_head_dim`` to that
    width; below it the absorbed form calls no flash attention."""
    *_, cfg, model = reduced_pair
    seen = []
    orig = layers.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q.shape, k.shape, v))
        return orig(q, k, v, **kw)
    monkeypatch.setattr(layers, "flash_attention", spy)
    with torch.inference_mode():
        model(torch.zeros((1, S), dtype=torch.int64))
    m = cfg.mla
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    if S < FLASH_MIN_SEQ:
        assert seen == []
        return
    assert len(seen) == cfg.n_layers
    for q_shape, k_shape, v in seen:
        assert q_shape == k_shape == v.shape == (1, cfg.n_heads, S, qk)
        assert not bool(v[..., m.v_head_dim:].any())


# -------------------------------------------------------------- decode
def _ref_step(ref_cfg, params):
    return jax.jit(lambda c, t, p: ref_decode.decode_step(ref_cfg, params,
                                                          c, t, p))


def _prompts(cfg, B, S):
    return SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]


def test_decode_matches_reference(reduced_pair):
    """Ten steps through the absorbed form: logits, then the ``ckv``
    cache written in place."""
    ref_cfg, params, cfg, model = reduced_pair
    B, T = 2, 10
    toks = _prompts(cfg, B, T)
    step = _ref_step(ref_cfg, params)
    ref_caches = ref_kvcache.init_cache(ref_cfg, B, T)
    caches = init_cache(cfg, B, T, device="cpu")
    ckv = caches["blocks"]["ckv"]
    for t in range(T):
        want, ref_caches = step(ref_caches, jnp.asarray(toks[:, t:t + 1]),
                                jnp.int32(t))
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        assert got.shape == (B, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL, err_msg=f"step {t}")
    assert caches["blocks"]["ckv"] is ckv
    np.testing.assert_allclose(ckv.numpy(),
                               np.asarray(ref_caches["blocks"]["ckv"]),
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
    """minicpm3-4b at its own widths with 2 layers: NumPy-seeded weights
    (0.50 B, drawn once), the tokens ``chip_smoke.py``'s cut-depth phase
    runs (B 1 x 2048, so the flash branch), and the reference's logits on
    them."""
    cfg = dataclasses.replace(get_arch(NAME), n_layers=2)
    ref_cfg = dataclasses.replace(REF_ARCHS[NAME], n_layers=2)
    params = interop.seeded_params(cfg, seed=0)
    toks = SyntheticDataset(cfg.vocab, 2048, 1, seed=0).batch(0)["tokens"]
    want = np.asarray(ref_model.forward(ref_cfg, params,
                                        {"tokens": toks.numpy()}))
    return cfg, params, toks, want


def test_forward_full_width_matches_reference(full_width):
    """d_model 2560, 40 heads, q_lora 768, kv_lora 256, qk 64 + 32, v 64,
    d_ff 6400, vocab 73448: q and k of 96 columns and V padded from 64 to
    96 in the flash branch."""
    cfg, params, toks, want = full_width
    model = interop.model_params(cfg, params, device="cpu")
    with torch.inference_mode():
        got = model(toks).numpy()
    del model
    assert got.shape == (1, 2048, 73448)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the port's own logits pass the rule the card's run is held to
    chip_smoke = _chip_smoke()
    assert chip_smoke.forward_agrees(chip_smoke.forward_summary(
        got[:, list(chip_smoke.MINICPM3_HELD_POSITIONS)]), chip_smoke.EXPECTED_MINICPM3)


def test_expected_minicpm3_is_the_reference(full_width):
    """``chip_smoke.py`` holds the card's cut-depth minicpm3-4b forward to
    ``EXPECTED_MINICPM3``; these are the reference package's logits on the
    same NumPy-seeded weights and tokens, with the logits' L2 norms that
    bound the sums' tolerance."""
    chip_smoke = _chip_smoke()
    *_, want = full_width
    held = want[:, list(chip_smoke.MINICPM3_HELD_POSITIONS)]
    summary = chip_smoke.forward_summary(held)
    assert chip_smoke.forward_agrees(summary, chip_smoke.EXPECTED_MINICPM3)
    assert [s[0] for s in summary] \
        == [e[0] for e in chip_smoke.EXPECTED_MINICPM3]
    np.testing.assert_allclose([s[3] for s in summary],
                               [e[3] for e in chip_smoke.EXPECTED_MINICPM3],
                               rtol=1e-6)
