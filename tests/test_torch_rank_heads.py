"""Attention on each rank's own query heads, and the lookup and the
unembedding without the whole table, on 4 ``gloo`` ranks (a 2 x 2 ``tp``
mesh) against one device.

* GQA whose KV heads do not divide the model axis (4 query heads over 1
  KV head: each rank's two heads share it; 6 over 3: a rank's three
  heads meet two KV heads, each query head its own copy), on the flash
  branch (2048 tokens, the plain version on the CPU), the short plain
  softmax and cross-attention (``kv_override``), and the decode step's
  ``cross_attention`` on a frozen cache sharded by sequence: the output
  equals the one-device output within 1e-6 (heads are independent), and
  the gradients of ``wq``, ``wk``, ``wv`` and ``wo`` equal the one-device
  ones within 1e-5.
* ``Transformer.embed`` with a vocab that divides the model axis (each
  rank's vocab rows) and one that does not (the ids and the looked-up
  columns move): the rows equal the one-device lookup bit for bit, and
  the table's gradient the one-device gradient within 1e-6.
* ``Transformer.logits`` without a gradient, for a decode step's few
  tokens, with a vocab that does not divide the model axis (the
  activations move: ``matmul_by_columns``): within 1e-5 of one device,
  for batch-sharded tokens and for one replicated token.

The ranks run one spawned job (``torch_ranks.run_ranks``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import run_ranks  # noqa: E402

FLASH, SHORT, N_SRC = 2048, 16, 12
HEADS = {"4-over-1": (4, 1), "6-over-3": (6, 3)}
BRANCHES = ["flash", "short", "cross", "cached-cross"]
VOCABS = {"divides": 256, "does-not-divide": 255}


def _cfg(H, Hkv, V=256):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    return reduced(get_arch("smollm-135m"), n_heads=H, n_kv_heads=Hkv,
                   vocab=V, n_layers=1, d_model=48)


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def job(rank, world, tmp):
    from repro_torch.interop import model_params, seeded_params
    from repro_torch.models.layers import cross_attention, gqa_attention
    from repro_torch.models.model import _rope
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh

    ctx = ShardingCtx(mesh=make_mesh("cpu", (2, 2)))
    out = {}

    def both(cfg):
        params = seeded_params(cfg, 0)
        return (model_params(cfg, params, device="cpu"),
                ctx.distribute(model_params(cfg, params, device="cpu")))

    def full(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    for name, (H, Hkv) in HEADS.items():
        cfg = _cfg(H, Hkv)
        one, sharded = both(cfg)
        for branch in BRANCHES:
            rng = np.random.default_rng(1)
            S = FLASH if branch == "flash" else SHORT
            x = _randn(rng, 2, 1 if branch == "cached-cross" else S,
                       cfg.d_model)
            src = _randn(rng, 2, N_SRC, cfg.d_model)
            kv = [_randn(rng, 2, Hkv, N_SRC, cfg.head_dim_)
                  for _ in range(2)]
            g = _randn(rng, *x.shape)
            cos, sin = _rope(cfg, S, device="cpu")

            def run(model, c):
                blk = model.blocks[0]
                xs = c.place(x, ("batch", "seq", "act_embed"))
                with c.scope():
                    if branch == "cached-cross":
                        axes = ("batch", "cache_heads", "cache_seq", None)
                        o = cross_attention(blk, xs,
                                            *(c.place(t, axes) for t in kv),
                                            ctx=c)
                    else:
                        o, _ = gqa_attention(
                            blk, xs, *((None, None) if branch == "cross"
                                       else (cos, sin)),
                            n_heads=H, ctx=c, impl="ref",
                            kv_override=((c.place(src, ("batch", "seq",
                                                        "act_embed")),)
                                         if branch == "cross" else None))
                    loss = (o * c.place(g, ("batch", "seq",
                                            "act_embed"))).sum()
                    grads = torch.autograd.grad(
                        loss, [blk.wq, blk.wk, blk.wv, blk.wo],
                        allow_unused=True)
                return (full(o).detach().numpy(),
                        [None if t is None else full(t).numpy()
                         for t in grads])

            out[(name, branch)] = (run(one, ShardingCtx()),
                                   run(sharded, ctx))

    rng = np.random.default_rng(2)
    for name, V in VOCABS.items():
        cfg = _cfg(4, 1, V)
        one, sharded = both(cfg)
        tokens = torch.from_numpy(rng.integers(0, V, (4, SHORT)))
        tokens[:, :4] = torch.tensor([0, V // 2 - 1, V // 2, V - 1])
        g = _randn(rng, 4, SHORT, cfg.d_model)

        def lookup(model, c):
            with c.scope():
                rows = model.embed(c.place(tokens, ("batch", "seq")), c)
                (gw,) = torch.autograd.grad(
                    (rows * c.place(g, ("batch", "seq", "act_embed"))).sum(),
                    (model.tok_emb,))
            return full(rows).detach().numpy(), full(gw).numpy()

        out[("embed", name)] = (lookup(one, ShardingCtx()),
                                lookup(sharded, ctx))
        for B in (4, 1):
            h = _randn(rng, B, 1, cfg.d_model)

            def logits(model, c):
                with torch.no_grad(), c.scope():
                    return full(model.logits(
                        c.place(h, ("batch", "seq", "act_embed")),
                        c)).numpy()
            out[("logits", name, B)] = (logits(one, ShardingCtx()),
                                        logits(sharded, ctx))
    return out if rank == 0 else None


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("test_torch_rank_heads", "job", 4,
                     tmp_path_factory.mktemp("rank_heads"), seconds=300)[0]


@pytest.mark.parametrize("branch", BRANCHES)
@pytest.mark.parametrize("heads", list(HEADS))
def test_attention_on_own_heads_is_one_device(runs, heads, branch):
    (o1, g1), (o, g) = runs[(heads, branch)]
    np.testing.assert_allclose(o, o1, rtol=0, atol=1e-6)
    for name, a, b in zip(("wq", "wk", "wv", "wo"), g, g1):
        # the cached cross layer's K and V come from the cache
        assert (a is None) == (b is None) == (
            branch == "cached-cross" and name in ("wk", "wv")), name
        if a is not None:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5,
                                       err_msg=name)


@pytest.mark.parametrize("vocab", list(VOCABS))
def test_lookup_without_the_whole_table_is_one_device(runs, vocab):
    (rows1, gw1), (rows, gw) = runs[("embed", vocab)]
    assert rows.dtype == rows1.dtype and np.array_equal(rows, rows1)
    np.testing.assert_allclose(gw, gw1, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B", [4, 1])
@pytest.mark.parametrize("vocab", list(VOCABS))
def test_decode_logits_without_the_whole_table(runs, vocab, B):
    one, sharded = runs[("logits", vocab, B)]
    np.testing.assert_allclose(sharded, one, rtol=0, atol=1e-5)


def test_own_kv_cuts():
    """Each rank's query heads meet the KV heads of the GQA repeat: 4 over
    1 shares one; 6 over 3 gives rank 0 query heads 0-2 (KV heads 0, 0,
    1) and rank 1 heads 3-5 (KV heads 1, 2, 2)."""
    from repro_torch.models.layers import _own_kv
    k = torch.arange(3.0).reshape(1, 3, 1, 1)

    def kv(lo, n, groups):
        return _own_kv(k, k, lo, n, groups)[0].flatten().tolist()
    assert kv(2, 2, 4) == [0.0]
    assert kv(0, 3, 2) == [0.0, 0.0, 1.0]
    assert kv(3, 3, 2) == [1.0, 2.0, 2.0]
