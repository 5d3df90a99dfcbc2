"""The port's decode step and serve driver against the reference's, on
the CPU, float32, on the reference's own parameters carried over with
``interop.model_params``: decode logits step by step (atol = rtol =
1e-4), decode against the port's own forward, the driver's output, and
greedy token ids equal to the reference's loop."""
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
from repro_torch.serve.decode import decode_step  # noqa: E402
from repro_torch.serve.kvcache import init_cache  # noqa: E402
from repro_torch.train.data import SyntheticDataset  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision_one_thread():
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, reference params, port cfg, port model) of reduced
    smollm-135m on the same weights."""
    name = "smollm-135m"
    ref_cfg = ref_base.reduced(REF_ARCHS[name])
    cfg = base.reduced(get_arch(name))
    params = ref_model.init(ref_cfg, jax.random.key(0))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    return ref_cfg, params, cfg, model


def _prompts(cfg, B, S):
    return SyntheticDataset(cfg.vocab, S, B, seed=0).batch(0)["tokens"]


def _ref_step(ref_cfg, params):
    return jax.jit(lambda c, t, p: ref_decode.decode_step(ref_cfg, params,
                                                          c, t, p))


def test_decode_matches_reference(pair):
    ref_cfg, params, cfg, model = pair
    B, T = 2, 8
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
    np.testing.assert_allclose(caches["blocks"]["k"].numpy(),
                               np.asarray(ref_caches["blocks"]["k"]),
                               atol=TOL, rtol=TOL)


def test_decode_matches_forward(pair):
    """Cache correctness: decode logits at t equal the forward's at t
    (the reference's own test allows 2e-2; float32 needs no such slack)."""
    _, _, cfg, model = pair
    B, T = 2, 6
    toks = _prompts(cfg, B, T)
    with torch.inference_mode():
        fwd = model(toks)
    caches = init_cache(cfg, B, T, device="cpu")
    for t in range(T):
        got, caches = decode_step(model, caches, toks[:, t:t + 1], t)
        np.testing.assert_allclose(got[:, 0].numpy(), fwd[:, t].numpy(),
                                   atol=TOL, rtol=TOL, err_msg=f"t={t}")


def test_decode_refuses_position_past_cache(pair):
    _, _, cfg, model = pair
    caches = init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError):
        decode_step(model, caches, torch.zeros(1, 1, dtype=torch.int32), 4)


def test_greedy_ids_equal_reference_loop(pair):
    """The driver's generation loop and the reference's (launch/serve.py)
    pick the same tokens; no step's top-2 logit gap is small enough for
    a rounding difference to flip the pick."""
    ref_cfg, params, cfg, model = pair
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


def test_serve_main_on_cpu(capsys):
    rc = serve.main(["--arch", "smollm-135m", "--reduced", "--batch", "2",
                     "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    assert lines[0].startswith("prefill: 8 tokens x 2 seqs in ")
    assert lines[1].startswith("decode:  4 tokens x 2 seqs in ")
    assert lines[2].startswith("generated token ids (first sequence): [")
    assert len(lines[2].split(":", 1)[1].strip(" []").split(",")) == 4


def test_serve_main_bfloat16_on_cpu(capsys):
    assert serve.main(["--reduced", "--batch", "1", "--prompt-len", "4",
                       "--gen", "2", "--device", "cpu",
                       "--dtype", "bfloat16"]) == 0
    assert capsys.readouterr().out.count("\n") == 3
