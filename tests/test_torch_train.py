"""The port's training path against the JAX package's: the Llama decoder
with flash attention (logits, loss, grads), remat, the loss, the FLOP
count, and a few AdamW steps of make_train_step.

A tiny GQA config (4 query heads, 2 KV heads) in f32 on the CPU, weights
converted from the flax tree; the JAX flash kernel runs in Pallas
interpret mode, the port's flash attention its plain versions. Tolerance
1e-4, as the JAX flash grads test; final parameters 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.train import spmd as jspmd  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.train import spmd as tspmd  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
B, S, STEPS = 2, 16, 3


def _jax_loss(model):
    def loss_fn(params, batch):
        inp, tgt = batch
        return jl.cross_entropy_loss(model.apply(params, inp), tgt)
    return loss_fn


def _torch_loss(model, batch):
    inp, tgt = batch
    return tl.cross_entropy_loss(model(inp), tgt)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32, attention="flash",
                          remat=False)
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="flash",
                          remat=False)
    jmodel = jl.LlamaModel(jcfg)
    jparams = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    data = np.random.default_rng(0).integers(0, SHAPE["vocab_size"],
                                             (B, S + 1))
    jbatch = (jnp.asarray(data[:, :-1], jnp.int32),
              jnp.asarray(data[:, 1:], jnp.int32))
    tbatch = (torch.from_numpy(data[:, :-1]), torch.from_numpy(data[:, 1:]))
    return jcfg, jmodel, jparams, tcfg, jbatch, tbatch


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.count += 1
        return func(*args, **(kwargs or {}))


def _grads(tcfg, jparams, tbatch):
    """(logits, loss, grads by name, matmuls run in the backward)."""
    model = tl.LlamaModel.from_params(
        tcfg, convert.params_from_flax(jparams, tcfg), torch.device("cpu"),
        trainable=True)
    logits = model(tbatch[0])
    loss = tl.cross_entropy_loss(logits, tbatch[1])
    with _CountMatmuls() as mm:
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return logits, loss, grads, mm.count


def test_logits_loss_and_grads_match_jax(setup):
    jcfg, jmodel, jparams, tcfg, jbatch, tbatch = setup
    jlogits = jax.jit(jmodel.apply)(jparams, jbatch[0])
    jloss, jgrads = jax.jit(jax.value_and_grad(_jax_loss(jmodel)))(
        jparams, jbatch)
    logits, loss, grads, _ = _grads(tcfg, jparams, tbatch)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **TOL)
    np.testing.assert_allclose(loss.item(), float(jloss), **TOL)
    want = convert.params_from_flax(jax.device_get(jgrads), tcfg)
    assert want.keys() == grads.keys()
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_grads_of_no_remat(setup, policy):
    """Same grads; "full" recomputes the layers' projections in the
    backward, "dots" keeps them (as dots_with_no_batch_dims_saveable)."""
    _, _, jparams, tcfg, _, tbatch = setup
    _, loss, want, mm = _grads(tcfg, jparams, tbatch)
    cfg = dataclasses.replace(tcfg, remat=True, remat_policy=policy)
    _, got_loss, got, got_mm = _grads(cfg, jparams, tbatch)
    assert got_loss.item() == loss.item()
    for name, g in got.items():
        torch.testing.assert_close(g, want[name], rtol=1e-6, atol=1e-7)
    assert (got_mm > mm) if policy == "full" else (got_mm == mm)


def test_train_steps_match_jax(setup):
    jcfg, jmodel, jparams, tcfg, jbatch, tbatch = setup
    opt = optax.adamw(3e-4, weight_decay=0.01)
    jstep = jax.jit(jspmd.make_train_step(_jax_loss(jmodel), opt))
    jstate = jspmd.TrainState(jparams, opt.init(jparams), jnp.zeros((),
                                                                    jnp.int32))
    state = tspmd.init_train_state(
        tcfg, tspmd.adamw(3e-4, weight_decay=0.01),
        convert.params_from_flax(jparams, tcfg), device="cpu")
    step = tspmd.make_train_step(_torch_loss)
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, tbatch)
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **TOL)
    want = convert.params_from_flax(jax.device_get(jstate.params), tcfg)
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_cross_entropy_loss_matches_jax():
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((2, 5, 11)) * 4).astype(np.float32)
    targets = rng.integers(0, 11, (2, 5))
    mask = (rng.random((2, 5)) > 0.4).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        want = jl.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(targets),
                                     None if m is None else jnp.asarray(m))
        got = tl.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(targets),
                                    None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6,
                                   atol=1e-6)


def test_count_flops_per_token_matches_jax():
    bench_1_2b = dict(vocab_size=32000, d_model=2048, n_layers=16,
                      n_heads=16, n_kv_heads=16, d_ff=8192, max_seq_len=2048)
    pairs = [(jl.LLAMA2_7B, tl.LLAMA2_7B),
             (jl.LlamaConfig(**bench_1_2b), tl.LlamaConfig(**bench_1_2b)),
             (jl.LlamaConfig(**SHAPE, tie_embeddings=True),
              tl.LlamaConfig(**SHAPE, tie_embeddings=True))]
    for jcfg, tcfg in pairs:
        assert tl.count_flops_per_token(tcfg) == jl.count_flops_per_token(jcfg)


def test_config_defaults_match_jax():
    for name in ("LLAMA2_7B", "TINY"):
        jcfg, tcfg = getattr(jl, name), getattr(tl, name)
        assert (tcfg.remat, tcfg.remat_policy, tcfg.attention) == \
            (jcfg.remat, jcfg.remat_policy, jcfg.attention)


def test_init_train_state_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tspmd.init_train_state(tl.TINY, tspmd.adamw(3e-4))
