"""The cross entropy on each rank's vocab shard
(``train_step.vocab_parallel_cross_entropy``) on 4 ``gloo`` ranks.

* On a 2 x 2 ``tp`` mesh the logits (B 4, S 16, V 64), placed as
  ``Transformer.logits`` places them, are split over the vocab: the loss
  is within 1e-6 of the reference's ``cross_entropy`` (JAX on the CPU)
  and of the port's plain ``cross_entropy`` on one rank, and the gathered
  gradient of the logits within 1e-6 of ``jax.grad`` of the reference's
  loss; three all-reduces (max, sum, sum) run over the model axis.  The
  labels hit every rank's shard, both of its edges ``lo`` and ``hi - 1``
  included.
* Where the vocab is not split (V 63 on the 2 x 2 ``tp`` mesh, which it
  does not divide; a 4 x 1 mesh, whose vocab axis has one rank; the
  ``fsdp`` layout) each rank's NLL is the plain ``logsumexp - gather`` on
  its own rows, bit for bit, with no collective; the mean, summed over
  the ranks in another order, within 1e-6.
* At world size 1 (a 1 x 1 mesh) the loss and the gradient are
  ``cross_entropy``'s bit for bit, and two train steps of reduced
  smollm-135m are the one-device steps bit for bit.

The ranks run in spawned processes (``torch_ranks.run_ranks``), one job
for the four-rank cases and one for world size 1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_ranks import run_ranks  # noqa: E402

B, S = 4, 16
# name -> (mesh shape, layout, vocab, whether the vocab is split)
CASES = {
    "tp-2x2": ((2, 2), "tp", 64, True),
    "tp-2x2-V63": ((2, 2), "tp", 63, False),
    "tp-4x1": ((4, 1), "tp", 64, False),
    "fsdp-2x2": ((2, 2), "fsdp", 64, False),
}


def _inputs(V):
    """Seeded logits (B, S, V) float32 and labels (B, S) int32; every row
    starts with both edges of each half of the vocab (a model axis of
    two ranks splits V into chunks of ceil(V / 2), as ``torch.chunk``)."""
    rng = np.random.default_rng(0)
    logits = (3.0 * rng.standard_normal((B, S, V))).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    half = -(-V // 2)
    labels[:, :4] = [0, half - 1, half, V - 1]
    return logits, labels


def _run(ctx, logits, labels):
    """(per-token NLL, loss, gradient of the logits, all-reduce ops in the
    loss's forward), each gathered, from the vocab-parallel loss."""
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.train.train_step import vocab_parallel_cross_entropy

    ops = []
    real = funcol.all_reduce

    def counting(t, op, group, *a, **k):
        ops.append(op)
        return real(t, op, group, *a, **k)

    x = ctx.place(torch.from_numpy(logits),
                  ("batch", "seq", "vocab")).requires_grad_()
    t = ctx.place(torch.from_numpy(labels), ("batch", "seq"))
    funcol.all_reduce = counting
    try:
        with ctx.scope():
            nll = vocab_parallel_cross_entropy(x, t, ctx)
    finally:
        funcol.all_reduce = real
    with ctx.scope():
        loss = nll.mean()
        (grad,) = torch.autograd.grad(loss, [x])
    return {"nll": nll.full_tensor().detach().numpy(),
            "loss": float(loss.detach().full_tensor()),
            "grad": grad.full_tensor().numpy(), "ops": ops,
            "placements": [(type(p).__name__, getattr(p, "dim", None))
                           for p in x.placements]}


def _plain(logits, labels):
    """The port's plain cross entropy on one rank: its per-token NLL, mean
    and gradient."""
    from repro_torch.train.train_step import cross_entropy
    x = torch.from_numpy(logits).requires_grad_()
    t = torch.from_numpy(labels)
    loss = cross_entropy(x, t)
    (grad,) = torch.autograd.grad(loss, [x])
    x = x.detach()
    nll = torch.logsumexp(x, -1) - torch.gather(x, -1, t[..., None].long())[
        ..., 0]
    return {"nll": nll.numpy(), "loss": float(loss),
            "loss_tensor": loss.detach().numpy(), "grad": grad.numpy()}


def job(rank, world, tmp):
    from repro_torch.parallel.sharding import LAYOUTS, ShardingCtx, make_mesh

    out = {}
    for name, (shape, layout, V, _) in CASES.items():
        ctx = ShardingCtx(mesh=make_mesh("cpu", shape),
                          rules=dict(LAYOUTS[layout]))
        logits, labels = _inputs(V)
        out[name] = _run(ctx, logits, labels)
        out[name]["plain"] = _plain(logits, labels)
    return out if rank == 0 else None


def job_one(rank, world, tmp):
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.interop import model_params, seeded_params
    from repro_torch.parallel.sharding import ShardingCtx, make_mesh
    from repro_torch.train.data import SyntheticDataset
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import make_train_step

    ctx = ShardingCtx(mesh=make_mesh("cpu", (1, 1)))
    logits, labels = _inputs(64)
    got = _run(ctx, logits, labels)
    # two train steps of reduced smollm-135m, sharded and not
    cfg = reduced(get_arch("smollm-135m"))
    params = seeded_params(cfg, 0)
    model = ctx.distribute(model_params(cfg, params, device="cpu"))
    one = model_params(cfg, params, device="cpu")
    opt = AdamW(lr=1e-2, warmup_steps=1)
    state, state1 = opt.init(model), opt.init(one)
    step, step1 = make_train_step(cfg, opt, ctx), make_train_step(cfg, opt)
    ds = SyntheticDataset(cfg.vocab, 32, 4, seed=0)
    steps = []
    for i in range(2):
        state, m = step(model, state, ds.batch(i))
        state1, m1 = step1(one, state1, ds.batch(i))
        steps.append(all(torch.equal(m[k], m1[k])
                         for k in ("loss", "grad_norm"))
                     and all(torch.equal(p.full_tensor(), q) for p, q
                             in zip(model.parameters(), one.parameters())))
    return got, _plain(logits, labels), steps


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("vocab_parallel")
    return (run_ranks("test_torch_vocab_parallel", "job", 4, tmp,
                      seconds=240)[0],
            run_ranks("test_torch_vocab_parallel", "job_one", 1, tmp,
                      seconds=120)[0])


def _reference(logits, labels):
    """The reference's loss and its ``jax.grad``, JAX on the CPU."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.train import train_step as ref_ts

    x, t = jnp.asarray(logits), jnp.asarray(labels)
    loss, grad = jax.value_and_grad(ref_ts.cross_entropy)(x, t)
    return float(loss), np.asarray(grad)


def test_vocab_split_loss_and_gradient_are_the_references(ranks):
    got = ranks[0]["tp-2x2"]
    # the logits as Transformer.logits places them: batch on data, vocab
    # on model
    assert got["placements"] == [("Shard", 0), ("Shard", 2)]
    assert got["ops"] == ["max", "sum", "sum"]
    logits, labels = _inputs(64)
    ref_loss, ref_grad = _reference(logits, labels)
    assert abs(got["loss"] - ref_loss) <= 1e-6
    assert abs(got["loss"] - got["plain"]["loss"]) <= 1e-6
    np.testing.assert_allclose(got["grad"], ref_grad, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["grad"], got["plain"]["grad"], rtol=0,
                               atol=1e-6)
    # every label, the shards' edges included, read its own logit
    np.testing.assert_allclose(got["nll"], got["plain"]["nll"], rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("case", [c for c, v in CASES.items() if not v[3]])
def test_vocab_whole_on_each_rank_is_the_plain_loss(ranks, case):
    got = ranks[0][case]
    assert got["ops"] == []             # no collective over the vocab
    assert np.array_equal(got["nll"], got["plain"]["nll"])
    assert abs(got["loss"] - got["plain"]["loss"]) <= 1e-6
    # the plain loss itself is held to the reference's by
    # test_torch_train.py; its gradient is held here too
    _, ref_grad = _reference(*_inputs(CASES[case][2]))
    np.testing.assert_allclose(got["grad"], ref_grad, rtol=0, atol=1e-6)


def test_world_size_one_is_cross_entropy_bit_for_bit(ranks):
    got, plain, _ = ranks[1]
    assert got["ops"] == []
    assert np.array_equal(np.float32(got["loss"]), plain["loss_tensor"])
    assert np.array_equal(got["grad"], plain["grad"])
    assert np.array_equal(got["nll"], plain["nll"])


def test_world_size_one_step_is_the_one_device_step_bit_for_bit(ranks):
    """Loss, gradient norm and parameters after each of two steps."""
    assert ranks[1][2] == [True, True]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_whole_vocab_backward_is_autograds_bit_for_bit(dtype):
    """The loss on a rank that holds the whole vocab, with no collective:
    its NLL and its gradient under seeded token weights are those of
    autograd through ``cross_entropy``'s operations, bit for bit."""
    from repro_torch.train.train_step import _ShardNLL

    logits, labels = _inputs(1000)
    w = torch.from_numpy(np.random.default_rng(1).random((B, S),
                                                         dtype=np.float32))
    t = torch.from_numpy(labels)
    x = torch.from_numpy(logits).to(dtype).requires_grad_()
    # one thread, as the ranks run: the CPU's logsumexp on several threads
    # can split its sums differently from one call to the next
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        xf = x.float()
        want = torch.logsumexp(xf, -1) - torch.gather(
            xf, -1, t[..., None].long())[..., 0]
        (want_grad,) = torch.autograd.grad((want * w).sum(), [x])
        got = _ShardNLL.apply(x, t, 0, [])
        (grad,) = torch.autograd.grad((got * w).sum(), [x])
    finally:
        torch.set_num_threads(threads)
    assert grad.dtype == dtype
    assert torch.equal(got, want) and torch.equal(grad, want_grad)
