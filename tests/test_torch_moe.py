"""The port's MoE decoder against the JAX package's, on the CPU.

TINY_MOE in f32 with attention "reference", weights converted from the
flax tree, the same numpy-seeded tokens on both sides: logits, the aux
loss, the routing, the gradients and three AdamW steps, at the reference
capacity factor (1.25) and at 0.5, where the capacity drops choices.
Tolerances are the reference tests': 2e-5 for the forward and the loss,
1e-4 for gradients and for parameters after steps. The JAX routing is
read from the reference's own calls (top_k, the two one_hots and the
router's softmax), intercepted while it runs eagerly.

The AdamW steps hold every parameter at 1e-4 but first-step ties. AdamW's
first update is lr * g / (|g| + eps) (eps 1e-8 in optax and torch), so a
gradient within eps of 0 sets it anywhere in (-lr, lr), and rounding
noise decides where. At capacity 1.25 the first gradient of
layers.0.moe.w_down[0, 85, 49] is 2.94e-9 in JAX and -5.19e-10 in the
port on one CPU (the tensor's rms is 2.3e-3; the element's true gradient
is 0 within f32 rounding): updates of 0.227 lr and -0.049 lr, and after
3 steps the element is 8.29e-5 from JAX's; on another CPU the noise gave
1.2e-4 (0.4 lr), past the tolerance. The routing is identical: every
other element of the layer is within 0.1 of the tolerance. So an element
whose first gradients differ and are under eps on either side is held at
2 lr plus the tolerance (later steps' moments keep 0.1 g and 0.001 g^2 of
it, nothing at this scale), and there may be at most one in a thousand
such elements in a tensor.
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import moe as jm  # noqa: E402
from ray_tpu.train import spmd as jspmd  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import moe as tm  # noqa: E402
from ray_tpu_torch.train import spmd as tspmd  # noqa: E402
from tests.torch_parallel_ranks import moe_loss  # noqa: E402

FWD, GRAD = dict(rtol=2e-5, atol=2e-5), dict(rtol=1e-4, atol=1e-4)
B, S, STEPS = 2, 16, 3
NEAR_TIE = 1e-6      # router-probability gap under which routing may flip
LR, ADAM_EPS = 3e-4, 1e-8
CAPACITY_FACTORS = [1.25, 0.5]


def _jax_loss(model):
    def loss_fn(params, batch):
        inp, tgt = batch
        logits, state = model.apply(params, inp, mutable=["intermediates"])
        return (jl.cross_entropy_loss(logits, tgt)
                + jm.moe_aux_loss(state["intermediates"]))
    return loss_fn


def _jax_forward_and_routing(model, params, tokens):
    """(logits, aux, [per layer: (router probs, top_e, slot, keep)]) of an
    eager apply, the routing read from the reference's own calls."""
    calls = {"softmax": [], "top_k": [], "one_hot": []}
    top_k, one_hot, softmax = jax.lax.top_k, jax.nn.one_hot, jax.nn.softmax

    def record(name, fn):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name].append((args, out))
            return out
        return wrapper

    with mock.patch.object(jax.lax, "top_k", record("top_k", top_k)), \
            mock.patch.object(jax.nn, "one_hot", record("one_hot", one_hot)), \
            mock.patch.object(jax.nn, "softmax", record("softmax", softmax)):
        logits, state = model.apply(params, tokens, mutable=["intermediates"])
    router_probs = [out for args, out in calls["softmax"] if out.ndim == 2]
    routing = []
    for i, probs in enumerate(router_probs):
        (slot, capacity), _ = calls["one_hot"][2 * i + 1]
        slot = np.asarray(slot)
        routing.append((np.asarray(probs), np.asarray(calls["top_k"][i][1][1]),
                        slot, (slot < capacity).astype(np.float32)))
    return logits, jm.moe_aux_loss(state["intermediates"]), routing


@pytest.fixture(scope="module", params=CAPACITY_FACTORS,
                ids=lambda cf: f"capacity{cf}")
def case(request):
    jcfg = dataclasses.replace(jm.TINY_MOE, capacity_factor=request.param)
    tcfg = dataclasses.replace(tm.TINY_MOE, capacity_factor=request.param)
    jmodel = jm.MoEModel(jcfg)
    jparams = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))
    data = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S + 1))
    jbatch = (jnp.asarray(data[:, :-1], jnp.int32),
              jnp.asarray(data[:, 1:], jnp.int32))
    tbatch = (torch.from_numpy(data[:, :-1]), torch.from_numpy(data[:, 1:]))

    logits, aux, routing = _jax_forward_and_routing(jmodel, jparams,
                                                    jbatch[0])
    loss, grads = jax.jit(jax.value_and_grad(_jax_loss(jmodel)))(jparams,
                                                                jbatch)
    model = tm.MoEModel.from_params(tcfg, convert.params_from_flax(
        jparams, tcfg), torch.device("cpu"), trainable=True)
    inter = {}
    got_logits = model(tbatch[0], intermediates=inter)
    got_loss = moe_loss(model, tbatch)
    got_loss.backward()
    return {
        "jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel, "jparams": jparams,
        "jbatch": jbatch, "tbatch": tbatch,
        "want": {"logits": np.asarray(logits), "aux": float(aux),
                 "routing": routing, "loss": float(loss),
                 "grads": convert.params_from_flax(jax.device_get(grads),
                                                   tcfg)},
        "got": {"logits": got_logits.detach().numpy(),
                "aux": tm.moe_aux_loss(inter).item(),
                "routing": [inter[f"layers_{i}/moe/routing"]
                            for i in range(tcfg.n_layers)],
                "loss": got_loss.item(),
                "grads": {n: p.grad for n, p in model.named_parameters()}}}


def test_logits_match_jax(case):
    np.testing.assert_allclose(case["got"]["logits"], case["want"]["logits"],
                               **FWD)


def test_aux_loss_matches_jax(case):
    np.testing.assert_allclose(case["got"]["aux"], case["want"]["aux"], **FWD)
    np.testing.assert_allclose(case["got"]["loss"], case["want"]["loss"],
                               **FWD)


def test_routing_matches_jax(case):
    K = case["tcfg"].experts_per_token
    dropped = 0
    for layer, (got, (probs, top_e, slot, keep)) in enumerate(
            zip(case["got"]["routing"], case["want"]["routing"])):
        ranked = -np.sort(-probs, axis=-1)[:, :K + 1]
        near = (ranked[:, :-1] - ranked[:, 1:]).min(-1) < NEAR_TIE
        if near.any():
            print(f"layer {layer}: near-ties at tokens {np.flatnonzero(near)}")
        got_e = got["top_e"].numpy()
        np.testing.assert_array_equal(got_e[~near], top_e[~near])
        if (got_e == top_e).all():  # else the near-tie moved later slots
            np.testing.assert_array_equal(got["slot"].numpy(), slot)
            np.testing.assert_array_equal(got["keep"].numpy(), keep)
        dropped += int((keep == 0).sum())
    print(f"capacity factor {case['tcfg'].capacity_factor}: {dropped} "
          "choices dropped")
    if case["tcfg"].capacity_factor < 1:
        assert dropped > 0


def test_grads_match_jax(case):
    """Router, experts, attention, norms, embedding and head."""
    got, want = case["got"]["grads"], case["want"]["grads"]
    assert got.keys() == want.keys()
    assert {"layers.0.moe.router.weight", "layers.0.moe.w_gate",
            "layers.0.moe.w_down", "layers.1.attn.q_proj.weight"} <= set(got)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD,
                                   err_msg=name)


def test_train_steps_match_jax(case):
    jmodel, jparams, jbatch = case["jmodel"], case["jparams"], case["jbatch"]
    opt = optax.adamw(LR, weight_decay=0.01)
    jstep = jax.jit(jspmd.make_train_step(_jax_loss(jmodel), opt))
    jstate = jspmd.TrainState(jparams, opt.init(jparams),
                              jnp.zeros((), jnp.int32))
    tcfg = case["tcfg"]
    state = tspmd.init_train_state(
        tcfg, tspmd.adamw(LR, weight_decay=0.01),
        convert.params_from_flax(jparams, tcfg), device="cpu")
    step = tspmd.make_train_step(moe_loss)
    for i in range(STEPS):
        jstate, jm_ = jstep(jstate, jbatch)
        state, m = step(state, case["tbatch"])
        assert m["step"] == int(jm_["step"]) == i + 1
        np.testing.assert_allclose(m["loss"].item(), float(jm_["loss"]),
                                   **FWD)
    want = convert.params_from_flax(jax.device_get(jstate.params), tcfg)
    for name, p in state.model.state_dict().items():
        got, w = p.numpy(), want[name].numpy()
        tie = first_step_ties(case, name)
        if tie.any():
            print(f"{name}: first-step ties at {np.argwhere(tie).tolist()}, "
                  f"ending {np.abs(got - w)[tie].tolist()} apart")
        assert tie.sum() <= tie.size // 1000, name
        np.testing.assert_allclose(got[~tie], w[~tie], **GRAD, err_msg=name)
        np.testing.assert_allclose(got[tie], w[tie], rtol=0,
                                   atol=2 * LR + GRAD["atol"], err_msg=name)


def first_step_ties(case, name) -> np.ndarray:
    """The elements of parameter `name` whose first-step gradients (the
    fixture's, at the initial parameters) differ between JAX and the port
    and are under AdamW's eps on either side (see the module's
    docstring)."""
    want = case["want"]["grads"][name].numpy()
    got = case["got"]["grads"][name].numpy()
    return (want != got) & ((np.abs(want) < ADAM_EPS)
                            | (np.abs(got) < ADAM_EPS))


def test_remat_gives_the_grads_of_no_remat(case):
    """Full remat recomputes each layer, its aux loss and routing
    included, in the backward: the same loss and grads."""
    tcfg = dataclasses.replace(case["tcfg"], remat=True)
    model = tm.MoEModel.from_params(tcfg, convert.params_from_flax(
        case["jparams"], tcfg), torch.device("cpu"), trainable=True)
    loss = moe_loss(model, case["tbatch"])
    loss.backward()
    assert loss.item() == case["got"]["loss"]
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.grad, case["got"]["grads"][name],
                                   rtol=1e-6, atol=1e-7)


def test_config_matches_jax():
    for name in ("MIXTRAL_8X7B", "TINY_MOE"):
        want = dataclasses.asdict(getattr(jm, name))
        got = dataclasses.asdict(getattr(tm, name))
        assert want.pop("dtype") == {torch.bfloat16: jnp.bfloat16,
                                     torch.float32: jnp.float32}[
                                         got.pop("dtype")]
        assert got == want


def test_count_flops_per_token_matches_jax():
    for name in ("MIXTRAL_8X7B", "TINY_MOE"):
        assert tm.count_flops_per_token(getattr(tm, name)) == \
            jm.count_flops_per_token(getattr(jm, name))


def test_init_params_std_matches_flax():
    """Each kind of tensor drawn with flax's initializer's std: an expert
    kernel (E, in, out) has fan_in E * in (lecun_normal's receptive
    field), 1/sqrt(8 * 256) for w_gate here, not 1/sqrt(256)."""
    shape = dict(vocab_size=512, d_model=256, n_layers=1, n_heads=4,
                 n_kv_heads=4, d_ff=512, n_experts=8)
    jcfg = dataclasses.replace(jm.TINY_MOE, **shape)
    tcfg = dataclasses.replace(tm.TINY_MOE, **shape)
    flax_params = convert.params_from_flax(jax.device_get(jax.jit(
        jm.MoEModel(jcfg).init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))), tcfg)
    params = convert.init_params(tcfg, seed=0, device="cpu")
    assert params.keys() == flax_params.keys()
    for name, t in params.items():
        assert t.dtype == flax_params[name].dtype, name
        np.testing.assert_allclose(t.std().item(),
                                   flax_params[name].std().item(), rtol=0.05,
                                   err_msg=name)
    np.testing.assert_allclose(params["layers.0.moe.w_gate"].std().item(),
                               (8 * 256) ** -0.5, rtol=0.01)


def test_router_stays_f32_in_a_bf16_model():
    model = tm.MoEModel(tm.MIXTRAL_8X7B, device="meta")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}
    assert dtypes["layers.0.moe.router.weight"] == torch.float32
    assert dtypes["layers.0.moe.w_gate"] == torch.bfloat16
    assert dtypes["layers.0.attn.q_proj.weight"] == torch.bfloat16


def test_moe_model_refuses_other_attention():
    with pytest.raises(ValueError, match="ulysses"):
        tm.MoEModel(dataclasses.replace(tm.TINY_MOE, attention="ulysses"),
                    device="meta")
