"""The sharded paths that no longer run on DTensor's own plan, on 4
``gloo`` ranks (a 2 x 2 ``tp`` mesh) against one device, at the
tolerances of ``test_torch_rank_heads.py`` (outputs within 1e-6,
gradients within 1e-5):

* GQA where both head counts divide the model axis (4 query heads over 2
  KV heads): the plain softmax on each rank's batch and heads (causal,
  non-causal as in an encoder, cross-attention), and the flash branch,
  each through the output projection that sums each rank's own heads and
  all-reduces them;
* MLA on the flash branch (reduced minicpm3-4b, 4 heads): V padded to
  K's head dim on each rank's shard (``sharding.pad_shards``);
* a mamba2 layer (reduced mamba2-2.7b, 8 SSD heads): the causal conv on
  each rank's own batch rows (2 rows split over the data axis; 4 rows
  split over the data and model axes, in float64) and the out-projection
  summed over each rank's slice of the inner dim.

And on one process: ``rmsnorm``'s variance gives autograd's gradient bit
for bit, in bfloat16 and float32.

The ranks run one spawned job (``torch_ranks.run_ranks``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import run_ranks  # noqa: E402

FLASH, SHORT, N_SRC = 2048, 16, 12
GQA = ["causal", "non-causal", "cross", "flash"]
# batch rows and dtype of the mamba2 layer: 2 split over the data axis
# only, 4 over the data and model axes (the conv on each rank's own rows),
# in float64: at 4 rows the conv bias's gradient reaches 160 in size, and
# float32 sums of its 128 tokens in another order differ by 4 ulp there
MAMBA = {"layer": (2, "float32"), "spread": (4, "float64")}


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def job(rank, world, tmp):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.interop import model_params, seeded_params
    from repro_torch.models.layers import gqa_attention, mla_attention
    from repro_torch.models.model import _rope
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh

    ctx = ShardingCtx(mesh=make_mesh("cpu", (2, 2)))
    out = {}

    def both(cfg, dtype=torch.float32):
        params = seeded_params(cfg, 0)
        return (model_params(cfg, params, device="cpu", dtype=dtype),
                ctx.distribute(model_params(cfg, params, device="cpu",
                                            dtype=dtype)))

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    def run(model, c, call, x, g, names):
        """``call(block, x, c)``'s output and the gradients of the block's
        parameters ``names`` under a seeded cotangent ``g``."""
        blk = model.blocks[0]
        with c.scope():
            o = call(blk, c.place(x, ("batch", "seq", "act_embed")), c)
            loss = (o * c.place(g, ("batch", "seq", "act_embed"))).sum()
            grads = torch.autograd.grad(
                loss, [getattr(blk, n) for n in names])
        return (full(o).detach().numpy(),
                {n: full(t).numpy() for n, t in zip(names, grads)})

    cfg = reduced(get_arch("smollm-135m"), n_heads=4, n_kv_heads=2,
                  n_layers=1, d_model=48)
    one, sharded = both(cfg)
    for branch in GQA:
        rng = np.random.default_rng(1)
        S = FLASH if branch == "flash" else SHORT
        x = _randn(rng, 2, S, cfg.d_model)
        src = _randn(rng, 2, N_SRC, cfg.d_model)
        g = _randn(rng, *x.shape)
        cos, sin = _rope(cfg, S, device="cpu")

        def call(blk, xs, c):
            if branch == "cross":
                return gqa_attention(
                    blk, xs, None, None, n_heads=4, ctx=c,
                    kv_override=(c.place(src, ("batch", "seq",
                                               "act_embed")),))[0]
            return gqa_attention(blk, xs, cos, sin, n_heads=4, ctx=c,
                                 causal=branch != "non-causal",
                                 impl="ref")[0]
        names = ["wq", "wk", "wv", "wo"]
        out[("gqa", branch)] = [run(m, c, call, x, g, names) for m, c in
                                ((one, ShardingCtx()), (sharded, ctx))]

    cfg = reduced(get_arch("minicpm3-4b"), n_heads=4, n_layers=1)
    one, sharded = both(cfg)
    rng = np.random.default_rng(2)
    x, g = _randn(rng, 2, FLASH, cfg.d_model), _randn(rng, 2, FLASH,
                                                      cfg.d_model)
    cos, sin = _rope(cfg, FLASH, device="cpu")

    def mla(blk, xs, c):
        return mla_attention(blk, xs, cos, sin, mla=cfg.mla, impl="ref",
                             ctx=c)[0]
    out[("mla", "flash")] = [
        run(m, c, mla, x, g, ["wq", "w_dkv", "w_uk", "w_uv", "wo"])
        for m, c in ((one, ShardingCtx()), (sharded, ctx))]

    cfg = reduced(get_arch("mamba2-2.7b"), n_layers=1)

    def mamba(blk, xs, c):
        return blk(xs, cfg, impl="ref", ctx=c)[0]
    for case, (B, dtype) in MAMBA.items():
        dtype = getattr(torch, dtype)
        one, sharded = both(cfg, dtype)
        rng = np.random.default_rng(3)
        x, g = (_randn(rng, B, 32, cfg.d_model).to(dtype),
                _randn(rng, B, 32, cfg.d_model).to(dtype))
        out[("mamba2", case)] = [
            run(m, c, mamba, x, g, ["in_proj", "conv_w", "conv_b",
                                    "out_proj", "norm_w"])
            for m, c in ((one, ShardingCtx()), (sharded, ctx))]
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("test_torch_rank_paths", "job", 4,
                     tmp_path_factory.mktemp("rank_paths"), seconds=300)[0]


@pytest.mark.parametrize("path", [("gqa", b) for b in GQA]
                         + [("mla", "flash")]
                         + [("mamba2", c) for c in MAMBA],
                         ids="-".join)
def test_sharded_path_is_one_device(runs, path):
    (o1, g1), (o, g) = runs[path]
    np.testing.assert_allclose(o, o1, rtol=0, atol=1e-6)
    assert g.keys() == g1.keys()
    for name in g:
        np.testing.assert_allclose(g[name], g1[name], rtol=0, atol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize(
    "dtype,shape",
    [pytest.param(dt, shp, id=str(dt) if shp == (3, 5, 64)
                  else f"{dt}-{'x'.join(map(str, shp))}")
     for shp in [(3, 5, 64), (2, 3, 576), (1, 4, 4096), (2, 2, 4608)]
     for dt in (torch.bfloat16, torch.float32)])
def test_rmsnorm_variance_gradient_is_autograds(dtype, shape):
    from repro_torch.models.layers import _MeanSquare
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(*shape, generator=gen).to(dtype).requires_grad_()
    g = torch.randn(*shape[:-1], 1, generator=gen)
    want, = torch.autograd.grad(
        x.float().square().mean(dim=-1, keepdim=True), x, g)
    var = _MeanSquare.apply(x)
    got, = torch.autograd.grad(var, x, g)
    assert torch.equal(var, x.float().square().mean(dim=-1, keepdim=True))
    assert got.dtype == want.dtype and torch.equal(got, want)
