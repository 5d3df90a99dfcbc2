"""The port's model stack against the reference's, on the CPU.

The configs, the synthetic data and the cache schemas are copies and must
be equal; the parameter schema must match name for name.  The forward
pass is held to the reference's on the same parameters — the reference's
own ``init`` carried over with ``interop.model_params`` — in float32
within atol = rtol = 1e-4: the plain attention branch (S = 64), the flash
branch (S = 2048, the reference's Pallas-free plain version there, the
port's plain version here), the full width of smollm-135m with two layers,
and a gelu model.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.registry import ARCHS as REF_ARCHS  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.service.requests import kv_shard_bytes  # noqa: E402
from repro.train import data as ref_data  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.registry import ARCHS, get_arch  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.layers import FLASH_MIN_SEQ  # noqa: E402
from repro_torch.serve.kvcache import cache_schema  # noqa: E402
from repro_torch.train.data import SyntheticDataset, extra_inputs  # noqa: E402

TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision_one_thread():
    """float32 products in full float32; one intra-op thread per worker."""
    prec, n = torch.get_float32_matmul_precision(), torch.get_num_threads()
    torch.set_float32_matmul_precision("highest")
    torch.set_num_threads(1)
    yield
    torch.set_float32_matmul_precision(prec)
    torch.set_num_threads(n)


def _pair(name, **over):
    """(reference cfg, port cfg) of ``reduced(name, **over)``."""
    return (ref_base.reduced(REF_ARCHS[name], **over),
            base.reduced(get_arch(name), **over))


def _forward_both(name, S, B=2, seed=0, **over):
    ref_cfg, cfg = _pair(name, **over)
    params = ref_model.init(ref_cfg, jax.random.key(seed))
    model = interop.model_params(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu")
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    want = np.asarray(ref_model.forward(ref_cfg, params, {"tokens": toks}))
    with torch.inference_mode():
        got = model(torch.from_numpy(toks)).numpy()
    return got, want


# ----------------------------------------------------------------- copies
@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_configs_equal_reference(name):
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    assert dataclasses.asdict(get_arch(name)) \
        == dataclasses.asdict(REF_ARCHS[name])
    ref_cfg, cfg = _pair(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    assert cfg.n_params == ref_cfg.n_params
    assert base.shape_cells(cfg) == ref_base.shape_cells(ref_cfg)


@pytest.mark.parametrize("vocab,seq,batch,seed", [(256, 64, 4, 0),
                                                  (49152, 33, 2, 7)])
def test_synthetic_tokens_equal_reference(vocab, seq, batch, seed):
    got = SyntheticDataset(vocab, seq, batch, seed=seed).batch(3)
    want = ref_data.SyntheticDataset(vocab, seq, batch, seed=seed).batch(3)
    for key in ("tokens", "labels"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


def test_extra_inputs_stub_shapes():
    ref_cfg, cfg = _pair("seamless-m4t-large-v2")
    got = extra_inputs(cfg, 2, seq_len=8, device="cpu")
    want = ref_data.extra_inputs(ref_cfg, 2, seq_len=8)
    assert got.keys() == want.keys()
    for key in got:
        assert tuple(got[key].shape) == want[key].shape
    assert extra_inputs(get_arch("smollm-135m"), 2, device="cpu") == {}


@pytest.mark.parametrize("name", sorted(REF_ARCHS))
def test_cache_schema_bytes_equal_reference(name):
    """The placement service sizes KV shards from the reference's schema:
    the port's must give the same shapes and the same bytes."""
    from repro.serve.kvcache import cache_schema as ref_cache_schema
    cfg, ref_cfg = get_arch(name), REF_ARCHS[name]
    got, want = cache_schema(cfg, 1, 4096), ref_cache_schema(ref_cfg, 1, 4096)
    shapes = lambda t: {k: (shapes(v) if isinstance(v, dict) else v.shape)
                        for k, v in t.items()}
    assert shapes(got) == shapes(want)

    def nbytes(t):                   # unpinned leaves in bfloat16
        return sum(nbytes(v) if isinstance(v, dict)
                   else np.prod(v.shape) * (v.dtype or torch.bfloat16).itemsize
                   for v in t.values())
    assert nbytes(got) == kv_shard_bytes(ref_cfg, 1, 4096)


@pytest.mark.parametrize("name", ["smollm-135m", "starcoder2-7b",
                                  "nemotron-4-340b"])
def test_schema_equals_reference(name):
    def flat(t):
        return {k: (flat(v) if isinstance(v, dict)
                    else (v.shape, v.axes, v.init, v.scale))
                for k, v in t.items()}
    assert flat(M.schema(get_arch(name))) \
        == flat(ref_model.schema(REF_ARCHS[name]))


def test_init_follows_schema():
    """Every parameter of the module is a per-layer slice of a schema
    leaf, made on the asked device, drawn as its ParamDef says."""
    cfg = base.reduced(get_arch("smollm-135m"))
    model = M.init(cfg, seed=1, device="cpu")
    params = dict(model.named_parameters())
    leaves = list(M.param_leaves(cfg))
    assert sorted(params) == sorted(name for name, *_ in leaves)
    for name, path, layer, d in leaves:
        p = params[name]
        assert p.device.type == "cpu" and p.dtype == torch.float32
        assert tuple(p.shape) == (d.shape if layer is None else d.shape[1:])
        if d.init == "ones":
            assert bool((p == 1).all()), name
        else:
            std = float(p.detach().std())
            assert 0.5 * d.scale < std < 1.5 * d.scale, name
    again = M.init(cfg, seed=1, device="cpu")
    assert torch.equal(again.blocks[2].wq, model.blocks[2].wq)


def test_model_params_rejects_mismatch():
    ref_cfg, cfg = _pair("smollm-135m")
    params = jax.tree.map(np.asarray,
                          ref_model.init(ref_cfg, jax.random.key(0)))
    bad = dict(params, blocks=dict(params["blocks"],
                                   wq=params["blocks"]["wq"][:, :-1]))
    with pytest.raises(ValueError):
        interop.model_params(cfg, bad, device="cpu")
    with pytest.raises(KeyError):
        interop.model_params(cfg, dict(params, extra=np.zeros(3)),
                             device="cpu")


# ---------------------------------------------------------------- forward
@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_forward_matches_reference(S):
    """S = 64 takes the plain attention branch in both packages, S = 2048
    the flash branch in both."""
    got, want = _forward_both("smollm-135m", S)
    assert got.shape == want.shape == (2, S, 256)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_forward_full_width_matches_reference():
    """smollm-135m's own widths (9 heads over 3 KV heads, head_dim 64,
    d_ff 1536, vocab 49152) with two layers."""
    got, want = _forward_both("smollm-135m", 32, n_layers=2, d_model=576,
                              n_heads=9, n_kv_heads=3, head_dim=64,
                              d_ff=1536, vocab=49152)
    assert got.shape == (2, 32, 49152)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_forward_gelu_matches_reference():
    """starcoder2's plain gelu MLP: jax.nn.gelu is the tanh form."""
    got, want = _forward_both("starcoder2-7b", 48)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("S", [64, FLASH_MIN_SEQ])
def test_forward_relu2_matches_reference(S):
    """nemotron-4-340b's squared-ReLU MLP and untied unembedding, through
    the plain attention branch (S = 64) and the flash branch (S = 2048)."""
    got, want = _forward_both("nemotron-4-340b", S)
    assert got.shape == want.shape == (2, S, 256)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_expected_forward_is_the_reference():
    """``chip_smoke.py`` holds the card's full-width smollm-135m forward
    (30 layers, 2048 tokens, two rows) to ``EXPECTED_FORWARD``.  Those
    numbers are the reference package's forward on the same NumPy-seeded
    weights and tokens; this recomputes them on the CPU."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    params = interop.seeded_params(get_arch("smollm-135m"), seed=0)
    toks = SyntheticDataset(49152, 2048, 2, seed=0).batch(0)["tokens"]
    logits = ref_model.forward(REF_ARCHS["smollm-135m"], params,
                               {"tokens": toks.numpy()})
    held = np.asarray(logits)[:, list(chip_smoke.HELD_POSITIONS)]
    summary = chip_smoke.forward_summary(held)
    assert chip_smoke.forward_agrees(summary)
    assert [s[0] for s in summary] \
        == [e[0] for e in chip_smoke.EXPECTED_FORWARD]
