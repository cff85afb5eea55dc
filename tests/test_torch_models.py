"""The port's other model families against the JAX package's, on the CPU:
ViT, DiT (its loss and sampler), the BERT-style encoder, the T5-style
encoder-decoder and the Mamba-style SSM.

Each family at its tiny config in f32, weights converted from the flax
tree (`params_from_flax`), the same numpy-seeded inputs on both sides.
DiT's attention runs the JAX Pallas kernel in interpret mode against the
port's plain flash versions, and the plain attention on both sides; its
random draws (timesteps, noise, label drops, the sampler's start) are
JAX's, fed to the port's private forms. Tolerances are the reference
tests': 2e-5 for forwards and losses, 1e-4 for gradients and for
parameters after AdamW steps.
"""

import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import optax  # noqa: E402

from ray_tpu.models import dit as jdit  # noqa: E402
from ray_tpu.models import encoder as jenc  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import ssm as jssm  # noqa: E402
from ray_tpu.models import vit as jvit  # noqa: E402
from ray_tpu.train import spmd as jspmd  # noqa: E402
from ray_tpu_torch import models as tmodels  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import dit as tdit  # noqa: E402
from ray_tpu_torch.models import encoder as tenc  # noqa: E402
from ray_tpu_torch.models import ssm as tssm  # noqa: E402
from ray_tpu_torch.models import vit as tvit  # noqa: E402
from ray_tpu_torch.train import spmd as tspmd  # noqa: E402

FWD, GRAD = dict(rtol=2e-5, atol=2e-5), dict(rtol=1e-4, atol=1e-4)
CPU = torch.device("cpu")
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
# The reference tests' tiny DiT (tests/test_models.py:152), at one layer.
DIT_SHAPE = dict(image_size=8, patch_size=2, d_model=32, n_layers=1,
                 n_heads=2, num_classes=4, timesteps=50)


def _dit_cfgs(attention, dtype=torch.float32):
    return (jdit.DiTConfig(**DIT_SHAPE, dtype=DTYPES[dtype],
                           attention=attention),
            tdit.DiTConfig(**DIT_SHAPE, dtype=dtype, attention=attention))


def _random_tree(family, seed):
    """Random weights in the flax tree of a family's tiny config, from a
    numpy seed: its structure from tracing flax's init (no compile),
    each kernel a unit normal over sqrt(fan_in), each norm scale
    1 + 0.1 n, every other leaf 0.1 n; so adaLN-Zero's zero kernels carry
    signal and every path has a gradient."""
    jmodel, inputs = _init_inputs(family)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *inputs)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = rng.standard_normal(leaf.shape)
        if path[-1].key == "kernel":
            a /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            a = (path[-1].key == "scale") + 0.1 * a
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _init_inputs(family):
    """(the JAX model, its init inputs) of a family's tiny config."""
    ints = jnp.zeros((1, 8), jnp.int32)
    return {"vit": (jvit.ViT(jvit.VIT_TINY), (jnp.zeros((1, 32, 32, 3)),)),
            "dit": (jdit.DiT(_dit_cfgs("reference")[0]),
                    (jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)),
                     jnp.zeros((1,), jnp.int32))),
            "dit_bf16": (jdit.DiT(_dit_cfgs("reference", torch.bfloat16)[0]),
                         (jnp.zeros((1, 8, 8, 3)), jnp.zeros((1,)),
                          jnp.zeros((1,), jnp.int32))),
            "encoder": (jenc.Encoder(jenc.TINY_ENCODER), (ints,)),
            "encdec": (jenc.EncoderDecoder(jenc.TINY_ENCDEC), (ints, ints)),
            "ssm": (jssm.SSMModel(jssm.TINY_SSM), (ints,))}[family]


@functools.cache
def _flax_init(family):
    """The flax tree that the reference's init makes from PRNGKey(0)."""
    jmodel, inputs = _init_inputs(family)
    return jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                               *inputs))


def _port(tcfg, jparams, trainable=True):
    return convert.model_class(tcfg).from_params(
        tcfg, convert.params_from_flax(jparams, tcfg), CPU,
        trainable=trainable)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _assert_grads(model, jgrads, tcfg):
    want = convert.params_from_flax(jax.device_get(jgrads), tcfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), **GRAD,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# ViT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_case():
    jmodel = jvit.ViT(jvit.VIT_TINY)
    rng = np.random.default_rng(0)
    images = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, (4,))
    jparams = _random_tree("vit", 1)

    def loss_fn(p, batch):
        logits = jmodel.apply(p, batch[0])
        return jvit.vit_loss(logits, batch[1]), logits

    jbatch = (jnp.asarray(images), jnp.asarray(labels, jnp.int32))
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams, jbatch)
    return {"jparams": jparams, "batch": (_t(images), _t(labels)),
            "logits": np.asarray(logits), "loss": float(loss),
            "grads": grads}


def test_vit_forward_and_grads_match_jax(vit_case):
    model = _port(tvit.VIT_TINY, vit_case["jparams"])
    images, labels = vit_case["batch"]
    logits = model(images)
    np.testing.assert_allclose(logits.detach().numpy(), vit_case["logits"],
                               **FWD)
    loss = tvit.vit_loss(logits, labels)
    np.testing.assert_allclose(loss.item(), vit_case["loss"], **FWD)
    loss.backward()
    _assert_grads(model, vit_case["grads"], tvit.VIT_TINY)


def test_vit_refuses_padded_patches():
    with pytest.raises(ValueError, match="multiple of the patch size"):
        tvit.ViT(dataclasses.replace(tvit.VIT_TINY, image_size=30),
                 device="meta")


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["flash", "reference"])
def dit_case(request):
    jcfg, tcfg = _dit_cfgs(request.param)
    jmodel = jdit.DiT(jcfg)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((3, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 4, (3,))
    jparams = _random_tree("dit", 3)
    key = jax.random.PRNGKey(7)
    jbatch = (jnp.asarray(images), jnp.asarray(labels, jnp.int32))
    t = jnp.asarray([3.0, 20.0, 49.0])

    def loss_fn(p, x, y):
        return (jdit.ddpm_loss(jmodel, p, x, y, key),
                jmodel.apply(p, x, t, y))

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, *jbatch)
    # the reference's draws, as ddpm_loss makes them from its key
    rng_t, rng_n, rng_d = jax.random.split(key, 3)
    draws = (jax.random.randint(rng_t, (3,), 0, jcfg.timesteps),
             jax.random.normal(rng_n, images.shape, jnp.float32),
             jax.random.bernoulli(rng_d, 0.1, (3,)))
    return {"jcfg": jcfg, "tcfg": tcfg, "jmodel": jmodel,
            "jparams": jparams, "images": images, "labels": labels,
            "t": np.asarray(t), "out": np.asarray(out), "loss": float(loss),
            "grads": grads, "draws": [np.asarray(d) for d in draws]}


def test_dit_forward_matches_jax(dit_case):
    model = _port(dit_case["tcfg"], dit_case["jparams"], trainable=False)
    out = model(_t(dit_case["images"]), _t(dit_case["t"]),
                _t(dit_case["labels"]))
    np.testing.assert_allclose(out.numpy(), dit_case["out"], **FWD)


def test_ddpm_loss_and_grads_match_jax_on_its_draws(dit_case):
    model = _port(dit_case["tcfg"], dit_case["jparams"])
    t, noise, drop = map(_t, dit_case["draws"])
    loss = tdit._ddpm_loss(model, _t(dit_case["images"]),
                           _t(dit_case["labels"]), t, noise, drop)
    np.testing.assert_allclose(loss.item(), dit_case["loss"], **FWD)
    loss.backward()
    _assert_grads(model, dit_case["grads"], dit_case["tcfg"])


def test_ddpm_loss_draws_from_the_generator():
    _, tcfg = _dit_cfgs("reference")
    model = tdit.DiT.from_params(tcfg, convert.init_params(tcfg, device="cpu"),
                                 CPU)
    images = torch.ones(2, 8, 8, 3)
    labels = torch.zeros(2, dtype=torch.long)
    losses = [tdit.ddpm_loss(model, images, labels,
                             torch.Generator().manual_seed(s)).item()
              for s in (1, 1, 2)]
    # adaLN-Zero: the fresh model predicts 0, so the loss is the noise's
    # mean square
    assert losses[0] == losses[1] != losses[2]
    assert 0.5 < losses[0] < 2.0


def test_ddim_steps_match_jax_from_its_states():
    """4 steps with guidance (two forwards a step), each from the state the
    reference's sampler reached (its lax.scan run as a Python loop over
    its jitted body that records the carries), from JAX's noise.

    The first step divides by sqrt(alpha_bar[T]) = sqrt(1e-5) before it
    clips x0 to +-3: where x0 stays inside the clip, a rounding difference
    in the predicted noise reaches the step's output multiplied by
    sqrt(alpha_bar[t_next] (1 - alpha_bar[T]) / alpha_bar[T]), 160 here.
    Those elements (a few in a thousand) are held at the forward tolerance
    times that gain, every other element of every step at the forward
    tolerance. (A whole run compounds the gain through the model, which
    mixes the elements of an image, so the steps are held one by one.)"""
    jcfg, tcfg = _dit_cfgs("reference")
    jmodel = jdit.DiT(jcfg)
    jparams = _random_tree("dit", 4)
    key = jax.random.PRNGKey(2)
    labels = np.array([1, 3])
    carries = []

    def scan(body, x, xs):
        body = jax.jit(body)
        for i in xs:
            carries.append(np.asarray(x))
            x, _ = body(x, i)
        carries.append(np.asarray(x))
        return x, None

    with mock.patch.object(jax.lax, "scan", scan):
        jdit.ddim_sample(jmodel, jparams, key, num=2, steps=4,
                         labels=jnp.asarray(labels), guidance=1.0)
    np.testing.assert_array_equal(
        carries[0], np.asarray(jax.random.normal(key, (2, 8, 8, 3))))
    model = _port(tcfg, jparams, trainable=False)
    alpha_bar = tdit.diffusion_schedule(tcfg)
    ts = tdit.sample_timesteps(tcfg, 4)
    for i, (t, t_next) in enumerate(zip(ts, ts[1:] + [0])):
        x = _t(carries[i])
        got = tdit._ddim_step(model, x, t, t_next, alpha_bar, _t(labels),
                              1.0).numpy()
        want = carries[i + 1]
        if i:
            np.testing.assert_allclose(got, want, **FWD, err_msg=f"step {i}")
            continue
        # the first step's x0, unclipped, at the port's predicted noise
        ab, ab_n = alpha_bar[t], alpha_bar[t_next]
        with torch.no_grad():
            tb = torch.full((2,), t - 1.0)
            eps = model(x, tb, _t(labels))
            eps_u = model(x, tb, torch.full((2,), tcfg.num_classes))
            eps = eps_u + 2.0 * (eps - eps_u)
        x0 = ((x - (1 - ab).sqrt() * eps) / ab.sqrt()).numpy()
        inside = np.abs(x0) < 3.0 * 1.01
        gain = (ab_n * (1 - ab) / ab).sqrt().item()
        print(f"{inside.sum()} of {inside.size} inside the first clip, gain "
              f"{gain:.1f}")
        assert inside.mean() < 0.01
        np.testing.assert_allclose(got[~inside], want[~inside], **FWD)
        np.testing.assert_allclose(got[inside], want[inside],
                                   rtol=FWD["rtol"] * gain,
                                   atol=FWD["atol"] * gain)
    gen = torch.Generator().manual_seed(0)
    drawn = tdit.ddim_sample(model, gen, num=2, steps=4, labels=_t(labels),
                             guidance=1.0)
    assert drawn.shape == (2, 8, 8, 3) and torch.isfinite(drawn).all()


@pytest.mark.parametrize("steps", [4, 50])
def test_sampler_timesteps_match_jax(steps):
    _, tcfg = _dit_cfgs("reference")
    for timesteps in (50, 1000):
        cfg = dataclasses.replace(tcfg, timesteps=timesteps)
        want = jnp.linspace(timesteps, 1, steps).astype(jnp.int32)
        assert tdit.sample_timesteps(cfg, steps) == np.asarray(want).tolist()


def test_diffusion_schedule_and_embedding_match_jax():
    jcfg, tcfg = _dit_cfgs("reference")
    jcfg, tcfg = (dataclasses.replace(c, timesteps=1000) for c in (jcfg, tcfg))
    np.testing.assert_allclose(tdit.diffusion_schedule(tcfg).numpy(),
                               np.asarray(jdit.diffusion_schedule(jcfg)),
                               rtol=2e-5, atol=1e-7)
    # cos and sin of t * freq in f32 agree to the argument's rounding: a
    # few ulps of t (6.1e-5 at t = 999) on top of the forward tolerance
    t = np.array([0.0, 1.0, 49.0, 499.0, 999.0], np.float32)
    got = tdit.timestep_embedding(_t(t), 384).numpy()
    want = np.asarray(jdit.timestep_embedding(jnp.asarray(t), 384))
    allowed = 2e-5 + 4 * np.spacing(t)[:, None]
    assert (np.abs(got - want) <= allowed).all(), np.abs(got - want).max()


def test_bf16_dit_converts_bit_exact_in_mixed_dtypes():
    """DiT's conditioning layers stay f32 in a bf16 model, as in the
    reference; every tensor crosses bit for bit."""
    jcfg, tcfg = _dit_cfgs("reference", torch.bfloat16)
    jparams = _flax_init("dit_bf16")
    got = convert.params_from_flax(jparams, tcfg)
    dtypes = {n: p.dtype for n, p in
              tdit.DiT(tcfg, device="meta").named_parameters()}
    assert {n for n, d in dtypes.items() if d == torch.float32} == {
        "t_embed.weight", "t_embed.bias", "label_embed.weight",
        "final_norm.scale", "final_norm.bias", "final_proj.weight",
        "final_proj.bias"} | {f"blocks.{i}.adaLN.{w}"
                              for i in range(DIT_SHAPE["n_layers"])
                              for w in ("weight", "bias")}
    flat = {"/".join(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(jparams["params"])[0]}
    assert len(flat) == len(got)
    for name, t in got.items():
        assert t.dtype == dtypes[name], name
        path, perm = convert.flax_path(name, t.dim())
        want = np.asarray(flat[path])
        want = np.transpose(want, perm) if perm else want
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          want.view(np.int16), err_msg=name)
        else:
            np.testing.assert_array_equal(t.numpy(), want, err_msg=name)


def test_count_dit_params_matches_jax():
    for shape in (DIT_SHAPE, {}, dict(image_size=32, channels=4,
                                      patch_size=2, d_model=1152,
                                      n_layers=28, n_heads=16,
                                      num_classes=1000)):
        got = tdit.count_dit_params(tdit.DiTConfig(**shape))
        assert got == jdit.count_dit_params(jdit.DiTConfig(**shape))
    _, tcfg = _dit_cfgs("reference")
    assert tdit.count_dit_params(tcfg) == sum(
        p.numel() for p in tdit.DiT(tcfg, device="meta").parameters())


# ---------------------------------------------------------------------------
# Encoder and encoder-decoder
# ---------------------------------------------------------------------------


def test_encoder_with_padding_matches_jax():
    jmodel = jenc.Encoder(jenc.TINY_ENCODER)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, 256, (3, 16))
    mask = np.ones((3, 16), bool)
    mask[0, 11:] = mask[2, 5:] = False          # padded rows
    targets = rng.integers(0, 256, (3, 16))
    mlm = (rng.random((3, 16)) < 0.3) & mask
    jparams = _random_tree("encoder", 5)

    def loss_fn(p):
        feats, logits = jmodel.apply(p, jnp.asarray(tokens),
                                     jnp.asarray(mask))
        return jenc.mlm_loss(logits, jnp.asarray(targets),
                             jnp.asarray(mlm)), (feats, logits)

    (loss, (feats, logits)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    model = _port(tenc.TINY_ENCODER, jparams)
    got_feats, got_logits = model(_t(tokens), _t(mask))
    np.testing.assert_allclose(got_feats.detach().numpy(), np.asarray(feats),
                               **FWD)
    np.testing.assert_allclose(got_logits.detach().numpy(),
                               np.asarray(logits), **FWD)
    np.testing.assert_allclose(
        tenc.Encoder.pooled(got_feats, _t(mask)).detach().numpy(),
        np.asarray(jenc.Encoder.pooled(feats, jnp.asarray(mask))), **FWD)
    got_loss = tenc.mlm_loss(got_logits, _t(targets), _t(mlm))
    np.testing.assert_allclose(got_loss.item(), float(loss), **FWD)
    got_loss.backward()
    _assert_grads(model, grads, tenc.TINY_ENCODER)


def test_encoder_decoder_matches_jax():
    jmodel = jenc.EncoderDecoder(jenc.TINY_ENCDEC)
    rng = np.random.default_rng(6)
    src, tgt = rng.integers(0, 256, (2, 12)), rng.integers(0, 256, (2, 9))
    src_mask = np.ones((2, 12), bool)
    src_mask[1, 7:] = False
    jparams = _random_tree("encdec", 6)

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(src), jnp.asarray(tgt[:, :-1]),
                              jnp.asarray(src_mask))
        return jenc.seq2seq_loss(logits, jnp.asarray(tgt[:, 1:])), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    model = _port(tenc.TINY_ENCDEC, jparams)
    got = model(_t(src), _t(tgt[:, :-1]), _t(src_mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               **FWD)
    got_loss = tenc.seq2seq_loss(got, _t(tgt[:, 1:]))
    np.testing.assert_allclose(got_loss.item(), float(loss), **FWD)
    got_loss.backward()
    _assert_grads(model, grads, tenc.TINY_ENCDEC)


def test_encoder_adamw_steps_match_optax():
    """3 AdamW steps of make_train_step on the MLM loss against the
    reference's step under optax.adamw: losses and every parameter after
    them. (Not ViT: its k_proj bias has a gradient of 0 within rounding,
    softmax being blind to a constant added to a row's scores, and
    AdamW's first update lr g / (|g| + eps) turns that noise into up to
    lr; see tests/test_torch_moe.py.)"""
    jmodel = jenc.Encoder(jenc.TINY_ENCODER)
    rng = np.random.default_rng(8)
    tgt = rng.integers(3, 256, (4, 16))
    mlm = rng.random((4, 16)) < 0.3
    inp = np.where(mlm, 1, tgt)
    jparams = _random_tree("encoder", 5)

    def loss_fn(p, batch):
        return jenc.mlm_loss(jmodel.apply(p, batch[0])[1], batch[1], batch[2])

    opt = optax.adamw(3e-4, weight_decay=0.01)
    jstep = jax.jit(jspmd.make_train_step(loss_fn, opt))
    jstate = jspmd.TrainState(jparams, opt.init(jparams),
                              jnp.zeros((), jnp.int32))
    state = tspmd.init_train_state(
        tenc.TINY_ENCODER, tspmd.adamw(3e-4, weight_decay=0.01),
        convert.params_from_flax(jparams, tenc.TINY_ENCODER), device="cpu")
    step = tspmd.make_train_step(
        lambda model, b: tenc.mlm_loss(model(b[0])[1], b[1], b[2]))
    jbatch = tuple(map(jnp.asarray, (inp, tgt, mlm)))
    for i in range(3):
        jstate, jm = jstep(jstate, jbatch)
        state, m = step(state, (_t(inp), _t(tgt), _t(mlm)))
        assert m["step"] == int(jm["step"]) == i + 1
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), **FWD)
    want = convert.params_from_flax(jax.device_get(jstate.params),
                                    tenc.TINY_ENCODER)
    for name, p in state.model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **GRAD,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# SSM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ssm_case():
    jmodel = jssm.SSMModel(jssm.TINY_SSM)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, 256, (2, 13))
    jparams = _random_tree("ssm", 7)
    return {"jmodel": jmodel, "jparams": jparams, "tokens": tokens,
            "model": _port(tssm.TINY_SSM, jparams)}


def test_ssm_forward_and_grads_match_jax(ssm_case):
    jmodel, jparams, tokens = (ssm_case[k] for k in
                               ("jmodel", "jparams", "tokens"))

    def loss_fn(p):
        logits = jmodel.apply(p, jnp.asarray(tokens[:, :-1]))
        return jl.cross_entropy_loss(logits,
                                     jnp.asarray(tokens[:, 1:])), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jparams)
    model = ssm_case["model"]
    model.zero_grad(set_to_none=True)
    got = model(_t(tokens[:, :-1]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits),
                               **FWD)
    got_loss = tmodels.cross_entropy_loss(got, _t(tokens[:, 1:]))
    np.testing.assert_allclose(got_loss.item(), float(loss), **FWD)
    got_loss.backward()
    _assert_grads(model, grads, tssm.TINY_SSM)


@pytest.mark.parametrize("S", [1, 16, 37])
def test_selective_scan_and_its_backward_match_jax(S):
    """The doubling scan against associative_scan, and its autograd
    backward (the reverse scan) against jax.grad, at a power of two, an
    odd length and one token."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.2, 1.0, (2, S, 3, 4)).astype(np.float32)
    b, w = (rng.standard_normal((2, S, 3, 4)).astype(np.float32)
            for _ in range(2))
    @jax.jit
    def scan_and_vjp(a, b, w):
        h, vjp = jax.vjp(jssm._selective_scan, a, b)
        return h, *vjp(w)

    want, want_da, want_db = scan_and_vjp(*map(jnp.asarray, (a, b, w)))
    ta, tb = (_t(x).requires_grad_() for x in (a, b))
    h = tssm._selective_scan(ta, tb)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want), **FWD)
    h.backward(_t(w))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_da), **GRAD)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_db), **GRAD)


def test_ssm_prefill_then_decode_matches_jax(ssm_case):
    """ssm_prefill on 9 tokens, then 4 ssm_decode_step steps, the logits
    and the carried states against the reference's, and against the
    port's own parallel forward."""
    jmodel, jparams, tokens = (ssm_case[k] for k in
                               ("jmodel", "jparams", "tokens"))
    model = ssm_case["model"]
    jlast, jstates = jax.jit(lambda p, t: jssm.ssm_prefill(jmodel, p, t))(
        jparams, jnp.asarray(tokens[:, :9]))
    jstep = jax.jit(lambda p, t, s: jssm.ssm_decode_step(jmodel, p, t, s))
    with torch.no_grad():
        full = model(_t(tokens))
        last, states = tssm.ssm_prefill(model, _t(tokens[:, :9]))
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast), **FWD)
        np.testing.assert_allclose(last.numpy(), full[:, 8].numpy(), **FWD)
        for t in range(9, 13):
            jlogits, jstates = jstep(jparams, jnp.asarray(tokens[:, t]),
                                     jstates)
            logits, states = tssm.ssm_decode_step(model, _t(tokens[:, t]),
                                                  states)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **FWD)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       **FWD)
    for (cw, h), (jcw, jh) in zip(states, jstates):
        np.testing.assert_allclose(cw.numpy(), np.asarray(jcw), **FWD)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), **FWD)
    fresh = tssm.init_ssm_state(tssm.TINY_SSM, 2, device="cpu")
    jfresh = jssm.init_ssm_state(jssm.TINY_SSM, 2)
    assert [(tuple(c.shape), tuple(h.shape)) for c, h in fresh] == \
        [(c.shape, h.shape) for c, h in jfresh]
    with pytest.raises(ValueError, match="S==1"):
        model(_t(tokens[:, :2]), fresh)


# ---------------------------------------------------------------------------
# Configs, initializers, exports
# ---------------------------------------------------------------------------

CONFIGS = [(jvit, tvit, ("VIT_B16", "VIT_L16", "VIT_TINY")),
           (jenc, tenc, ("BERT_BASE", "BERT_LARGE", "TINY_ENCODER",
                         "T5_BASE", "T5_LARGE", "TINY_ENCDEC")),
           (jssm, tssm, ("MAMBA_130M", "MAMBA_790M", "TINY_SSM"))]


@pytest.mark.parametrize("jmod,tmod,names", CONFIGS,
                         ids=["vit", "encoder", "ssm"])
def test_configs_match_jax(jmod, tmod, names):
    for name in names:
        want = dataclasses.asdict(getattr(jmod, name))
        got = dataclasses.asdict(getattr(tmod, name))
        assert DTYPES[got.pop("dtype")] == want.pop("dtype"), name
        assert got == want, name
    want = dataclasses.asdict(jdit.DiTConfig())
    got = dataclasses.asdict(tdit.DiTConfig())
    assert DTYPES[got.pop("dtype")] == want.pop("dtype")
    assert got == want


def test_init_params_match_flax_initializers():
    """Each tensor drawn with the std of flax's initializer (exact zeros
    and ones where flax has them: adaLN-Zero's kernels, the biases, the
    norms), in the flax tree's dtype, for the bf16 DiT, whose f32
    conditioning layers and zero kernels the generic rules do not
    cover."""
    tcfg = _dit_cfgs("reference", torch.bfloat16)[1]
    flax = convert.params_from_flax(_flax_init("dit_bf16"), tcfg)
    params = convert.init_params(tcfg, seed=0, device="cpu")
    assert params.keys() == flax.keys()
    for name, t in params.items():
        want = flax[name]
        assert t.dtype == want.dtype, name
        if want.float().std() == 0:
            torch.testing.assert_close(t, want, rtol=0, atol=0, msg=name)
        else:
            np.testing.assert_allclose(t.float().std().item(),
                                       want.float().std().item(), rtol=0.2,
                                       err_msg=name)


def test_models_export_the_families():
    for name in ("ViT", "VIT_B16", "vit_loss", "DiT", "DiTConfig",
                 "ddpm_loss", "ddim_sample", "Encoder", "EncoderDecoder",
                 "BERT_BASE", "T5_BASE", "mlm_loss", "seq2seq_loss",
                 "SSMModel", "MAMBA_130M", "SSM_RULES", "init_ssm_state",
                 "ssm_prefill", "ssm_decode_step"):
        assert name in tmodels.__all__ and hasattr(tmodels, name), name


def test_entry_points_default_to_cuda():
    """Without device, the families' entry points ask for CUDA: with no
    card they raise, where a silent CPU run would hide the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: convert.init_params(tvit.VIT_TINY),
                 lambda: tssm.init_ssm_state(tssm.TINY_SSM, 1),
                 lambda: tspmd.init_train_state(tenc.TINY_ENCODER,
                                                tspmd.adamw(1e-3))):
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            call()
