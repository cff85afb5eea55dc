"""The port's last RLlib learners (ray_tpu_torch.rllib: DT, QMIX with
CoopSwitch, DreamerV3) against the JAX package's, on the CPU.

The reference objects are built in process (none of the three starts an
actor). Each update is held from mid-training: two of the reference's
jitted steps, their params, targets, slow critic, return scale and optax
Adam states loaded into the port's learner, then three more steps on
both sides. The reference's update is jitted together with the gradient
of its own loss (one compile), so the port's gradients are held too.
DreamerV3 draws its categoricals with jax.random inside its update and
its act(); the test replays the reference's key splits, draws
jax.random.gumbel from each key and hands those arrays to the port.

Tolerances: f32 losses and aux terms 2e-5; params, gradients, QMIX's
target, DreamerV3's slow critic and ret_scale 1e-4 (the JAX package's
flash tests' bounds). Environments, buffers and batches are numpy in both
packages and held bitwise. A latent that differs between the two sides
passes only at a near-tie of its Gumbel-perturbed logits (top-2 gap
under 1e-5), which is reported.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib import dreamerv3 as jdv3  # noqa: E402
from ray_tpu.rllib import dt as jdt  # noqa: E402
from ray_tpu.rllib import qmix as jqmix  # noqa: E402
from ray_tpu_torch.rllib import dreamerv3 as tdv3  # noqa: E402
from ray_tpu_torch.rllib import dt as tdt  # noqa: E402
from ray_tpu_torch.rllib import qmix as tqmix  # noqa: E402
from ray_tpu_torch.rllib.env import ENV_REGISTRY  # noqa: E402
from ray_tpu_torch.rllib.offline import write_offline_json  # noqa: E402
from ray_tpu_torch.rllib.ppo import (load_reference_state,  # noqa: E402
                                     sorted_items)

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
TIE = 1e-5
# DreamerV3 at a tiny size: deter 16, 4 x 4 latents, hidden 16, batch
# 4 x 8, horizon 5.
DV3_TINY = dict(deter=16, stoch_groups=4, stoch_classes=4, hidden=16,
                batch_size=4, batch_length=8, imag_horizon=5)


def _flat(tree) -> dict:
    """path -> a numpy copy of the leaf (never a view of a live tensor)."""
    return {"/".join(map(str, path)): np.array(
        leaf.detach() if torch.is_tensor(leaf) else leaf)
        for path, leaf in sorted_items(tree)}


def _hold(got, want, tol=GRAD, rounding=None, bound=0.0):
    """Every leaf within `tol`, but the entries `rounding` names ({path:
    index}), whose gradient is 0 but for rounding: Adam scales that
    noise up to a step of about lr, so they are held to `bound`."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if rounding and k in rounding:
            idx = rounding[k]
            assert np.abs(g[idx] - w[idx]).max() <= bound, k
            g, w = g.copy(), w.copy()
            g[idx] = w[idx] = 0.0
        np.testing.assert_allclose(g, w, **tol, err_msg=k)


def _grads(params) -> dict:
    """The .grad of every tensor of a tree, as a tree; every leaf must
    have one (optax steps every leaf)."""
    out = {}
    for path, t in sorted_items(params):
        assert t.grad is not None, path
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t.grad
    return out


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam(opt_state):
    """(count, mu, nu) of an optax.adam state, as numpy."""
    s = opt_state[0]
    return int(s.count), _np(s.mu), _np(s.nu)


def _label_states(opt_state) -> dict:
    """optax.multi_transform's state as {label: (count, mu, nu)}, each
    label's moments over its own keys."""
    out = {}
    for label, masked in opt_state.inner_states.items():
        s = masked.inner_state[0]
        keep = [k for k, v in s.mu.items()
                if not isinstance(v, optax.MaskedNode)]
        out[label] = (int(s.count), {k: _np(s.mu[k]) for k in keep},
                      {k: _np(s.nu[k]) for k in keep})
    return out


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _compiled(fn):
    """jax.jit(fn), compiled on its first call at XLA's backend
    optimization level 0: the reference's programs here (threefry's
    random bits above all) compile 4-5x faster on one core, the same
    functions of the same inputs (the random draws bitwise). Every later
    call takes arguments of the first call's shapes and types."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                {"xla_backend_optimization_level": 0}))
        return compiled[0](*args)

    return call


def _with_grads(jitted, loss_name: str = "loss_fn", n_params: int = 1):
    """The reference's jitted update and the gradient of its loss at the
    same arguments, as one program: (update's outputs, grads)."""
    update = jitted.__wrapped__
    loss_fn = _closure(update)[loss_name]

    def both(*args):
        loss_args = args[:n_params] + args[n_params + 1:]
        return update(*args), jax.grad(loss_fn)(*loss_args)

    return _compiled(both)


def _offline_file(tmp_path, n=400, seed=0):
    """A CartPole-shaped log with episodes of 1-60 steps."""
    rng = np.random.default_rng(seed)
    dones = (rng.random(n) < 0.05).astype(np.float32)
    dones[[0, 5, 6]] = 1.0          # episodes of 1 and 5 steps
    path = str(tmp_path / "data.jsonl")
    write_offline_json(path, [{
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": rng.uniform(0, 1, n).astype(np.float32),
        "dones": dones}])
    return path


def _assert_latents(got, want, perturbed, what):
    """got/want: one-hot latents [..., G * C] (straight-through values),
    perturbed: the reference's Gumbel-perturbed log-probs [..., G, C].
    Equal but at near-ties, which are reported."""
    G, C = perturbed.shape[-2:]
    g = np.argmax(np.asarray(got).reshape(-1, G, C), -1)
    w = np.argmax(np.asarray(want).reshape(-1, G, C), -1)
    top2 = np.sort(np.asarray(perturbed).reshape(-1, G, C), -1)[..., -2:]
    gap = top2[..., 1] - top2[..., 0]
    off = g != w
    if off.any():
        print(f"{what}: {int(off.sum())} latent(s) differ at top-2 gaps "
              f"{gap[off].tolist()}")
    assert (gap[off] < TIE).all(), (what, gap[off])


# ---------------- the updates, from mid-training ----------------

class _Pair:
    """One algorithm's update on both sides: ref_step(state, i) ->
    (state, outputs, grads) runs the reference's jitted update on batch
    i; port(state) makes the port's learner from a reference state;
    port_step(learner, i) -> outputs; sync(state, learner) syncs both
    targets; held(state, learner) -> [(port tree, reference tree)]."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@functools.cache
def _dt_ref(path):
    ref = jdt.DTConfig(input_path=path).build()
    ref._build_update()
    return ref, _with_grads(ref._update, n_params=1)


def _dt_pair(tmp_path):
    path = _offline_file(tmp_path)
    ref, update = _dt_ref(path)
    rng = np.random.default_rng(7)
    batches = [tuple(np.asarray(a) for a in ref._sample_batch(rng))
               for _ in range(5)]

    def ref_step(st, i):
        (p, o, loss), g = update(st["params"], st["opt"], *batches[i])
        return dict(st, params=p, opt=o), {"loss": loss}, g

    def port(st):
        lr = tdt.DTConfig(input_path=path).build(device="cpu")
        load_reference_state(lr, _np(st["params"]), *_adam(st["opt"]))
        return lr

    # A block's key bias adds a constant to each query's scores, which
    # the softmax takes out: its gradient is 0 but for rounding (under
    # 1e-8 here, on both sides).
    E = ref.config.embed_dim
    rounding = {f"blk{i}/qkv/b": slice(E, 2 * E)
                for i in range(ref.config.n_layers)}
    return _Pair(state={"params": ref.params, "opt": ref._opt_state},
                 ref_step=ref_step, port=port,
                 port_step=lambda lr, i: {"loss": lr.update(*batches[i])},
                 sync=None, rounding=rounding, lr=ref.config.lr,
                 held=lambda st, lr: [(lr.params, st["params"])])


@functools.cache
def _qmix_ref():
    ref = jqmix.QMIXConfig().build()
    ref._build_update()
    return ref, _with_grads(ref._update_fn, n_params=2)


def _qmix_batch(seed, B=64):
    rng = np.random.default_rng(seed)

    def aug():
        bits = rng.integers(0, 2, (B, 2))
        obs = np.eye(2, dtype=np.float32)[bits]
        return np.concatenate(
            [obs, np.broadcast_to(np.eye(2, dtype=np.float32),
                                  (B, 2, 2))], -1), bits.astype(np.float32)

    obs, state = aug()
    next_obs, next_state = aug()
    return {"obs": obs, "actions": rng.integers(0, 2, (B, 2)).astype(
        np.int32), "state": state,
            "reward": (rng.random(B) < 0.4).astype(np.float32),
            "next_obs": next_obs, "next_state": next_state,
            "done": (rng.random(B) < 0.1).astype(np.float32)}


def _qmix_pair(tmp_path):
    ref, update = _qmix_ref()
    batches = [_qmix_batch(20 + i) for i in range(5)]

    def ref_step(st, i):
        b = {k: jnp.asarray(v) for k, v in batches[i].items()}
        (p, o, loss), g = update(st["params"], st["target"], st["opt"], b)
        return dict(st, params=p, opt=o), {"loss": loss}, g

    def port(st):
        lr = tqmix.QMIXConfig().build(device="cpu")
        load_reference_state(lr, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        return lr

    def sync(st, lr):
        lr.sync_target()
        return dict(st, target=st["params"])

    # The reference aliases its target at init: the first steps leave it
    # at the initial params, as the port's copy.
    return _Pair(state={"params": ref.params, "target": ref.params,
                        "opt": ref._opt_state},
                 ref_step=ref_step, port=port,
                 port_step=lambda lr, i: {"loss": lr.update(batches[i])},
                 sync=sync,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.target, st["target"])])


def _dv3_batch(seed, cfg):
    rng = np.random.default_rng(seed)
    B, L = cfg.batch_size, cfg.batch_length
    return {"obs": rng.standard_normal((B, L, 4)).astype(np.float32),
            "action": rng.integers(0, 2, (B, L)).astype(np.int32),
            "reward": rng.uniform(0, 1, (B, L)).astype(np.float32),
            "cont": (rng.random((B, L)) > 0.05).astype(np.float32),
            "is_first": (rng.random((B, L)) < 0.1).astype(np.float32)}


def _dv3_draws(cfg, key):
    """The Gumbel draws the reference's update takes from `key`, by its
    own splits: split(key, 3) into the filter's, the imagination's and an
    unused key; L filter keys, H imagination keys each split into the
    action's and the prior latent's."""
    G, C = cfg.stoch_groups, cfg.stoch_classes
    B, L, H = cfg.batch_size, cfg.batch_length, cfg.imag_horizon
    N = B * L
    kw, ki, _ka = jax.random.split(key, 3)
    post = jax.vmap(lambda k: jax.random.gumbel(k, (B, G, C)))(
        jax.random.split(kw, L))
    k1, k2 = jax.vmap(jax.random.split, out_axes=1)(
        jax.random.split(ki, H))
    return {"post": post,
            "act": jax.vmap(lambda k: jax.random.gumbel(k, (N, 2)))(k1),
            "prior": jax.vmap(lambda k: jax.random.gumbel(k, (N, G, C)))(k2)}


@functools.cache
def _dv3_ref():
    """The reference at the tiny size, and its train() loop body for one
    update (the jitted grads, optax.multi_transform's step, the slow
    critic's EMA) jitted as one program with the update's noise."""
    cfg = jdv3.DreamerV3Config(**DV3_TINY)
    ref = cfg.build()
    d = cfg.critic_ema_decay

    def step(params, opt, slow, batch, key, ret_scale):
        grads, ret_scale, aux = ref._update_grads.__wrapped__(
            params, slow, batch, key, ret_scale)
        updates, opt = ref._opt.update(grads, opt, params)
        params = optax.apply_updates(params, updates)
        slow = {hk: jax.tree_util.tree_map(
            lambda s, p: d * s + (1 - d) * p, slow[hk], params[hk])
            for hk in ("critic1", "critic2")}
        return (params, opt, slow, ret_scale, aux, grads,
                _dv3_draws(cfg, key))

    return ref, _compiled(step)


def _dv3_pair(tmp_path):
    ref, step = _dv3_ref()
    cfg = ref.config
    batches = [_dv3_batch(30 + i, cfg) for i in range(5)]
    keys = [jax.random.PRNGKey(500 + i) for i in range(5)]
    noise = {}

    def ref_step(st, i):
        params, opt, slow, ret_scale, aux, grads, noise[i] = step(
            st["params"], st["opt"], st["slow"], batches[i], keys[i],
            st["ret_scale"])
        return (dict(st, params=params, opt=opt, slow=slow,
                     ret_scale=ret_scale), aux, grads)

    def port(st):
        lr = tdv3.DreamerV3Config(**DV3_TINY).build(device="cpu")
        lr.load_reference_state(_np(st["params"]), _label_states(st["opt"]),
                                _np(st["slow"]), st["ret_scale"])
        return lr

    def port_step(lr, i):
        return lr.update(batches[i], {k: torch.tensor(np.asarray(v))
                                      for k, v in noise[i].items()})

    # ret_scale starts as the reference's Python 1.0, strongly typed here
    # so that the step compiles once.
    return _Pair(state={"params": ref.params, "opt": ref._opt_state,
                        "slow": ref._slow_critic,
                        "ret_scale": jnp.float32(1.0)},
                 ref_step=ref_step, port=port, port_step=port_step,
                 sync=None,
                 held=lambda st, lr: [
                     (lr.params, st["params"]),
                     (lr.slow_critic, st["slow"]),
                     ({"ret_scale": lr.ret_scale},
                      {"ret_scale": st["ret_scale"]})])


PAIRS = {"dt": _dt_pair, "qmix": _qmix_pair, "dreamerv3": _dv3_pair}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_update_matches_reference_from_mid_training(name, tmp_path):
    """Two reference steps make a mid-training state; the port's learner
    takes it and both take three more steps on the same batches (and,
    for DreamerV3, the same Gumbel noise): losses and aux within 2e-5,
    gradients, params, QMIX's target, DreamerV3's slow critic and
    ret_scale within 1e-4 after each step. QMIX's target syncs after the
    fourth step on both sides."""
    pair = PAIRS[name](tmp_path)
    st = pair.state
    for i in range(2):
        st, _, _ = pair.ref_step(st, i)
    learner = pair.port(st)
    for i in range(2, 5):
        st, want, want_grads = pair.ref_step(st, i)
        got = pair.port_step(learner, i)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), **FWD,
                                       err_msg=f"step {i}: {k}")
        grads = _grads(learner.params)
        _hold(grads, _np(want_grads))
        rounding = getattr(pair, "rounding", None)
        for k, idx in (rounding or {}).items():
            assert np.abs(_flat(grads)[k][idx]).max() < 1e-8, k
            assert np.abs(_flat(_np(want_grads))[k][idx]).max() < 1e-8, k
        for port_tree, ref_tree in pair.held(st, learner):
            # Adam moves a rounding-noise entry by at most about lr a
            # step (phase 14's rule on the card: 2 lr an update).
            _hold(port_tree, _np(ref_tree), rounding=rounding,
                  bound=2 * getattr(pair, "lr", 0.0) * (i - 1))
        if i == 3 and pair.sync is not None:
            st = pair.sync(st, learner)


def test_initial_params_are_the_reference_bitwise(tmp_path):
    """Each learner inits its parameters by the reference's numpy draws:
    bitwise the reference's."""
    path = _offline_file(tmp_path)
    pairs = [(tdt.DTConfig(input_path=path).build(device="cpu"),
              jdt.DTConfig(input_path=path).build()),
             (tqmix.QMIXConfig().build(device="cpu"),
              jqmix.QMIXConfig().build()),
             (tdv3.DreamerV3Config(**DV3_TINY).build(device="cpu"),
              _dv3_ref()[0])]
    for port, ref in pairs:
        got, want = _flat(port.params), _flat(ref.params)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------- forwards ----------------

def test_dt_forward_on_evaluate_contexts(tmp_path):
    """DT's forward on evaluate()'s zero-padded contexts (1 to K steps
    of history) within 2e-5 of the reference's, from a perturbed state;
    evaluate() and compute_single_action() then act as the reference's."""
    path = _offline_file(tmp_path)
    ref, _ = _dt_ref(path)
    port = tdt.DTConfig(input_path=path).build(device="cpu")
    rng = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        ref.params)
    load_reference_state(port, params, 0, _np(params), _np(params))
    K = port.config.context_len
    for n in (1, 3, K):
        rtg = np.zeros((2, K), np.float32)
        obs = np.zeros((2, K, 4), np.float32)
        acts = np.zeros((2, K), np.int32)
        rtg[:, :n] = rng.uniform(0, 50, (2, n))
        obs[:, :n] = rng.standard_normal((2, n, 4))
        acts[:, :n] = rng.integers(0, 2, (2, n))
        onehot = np.eye(2, dtype=np.float32)[acts]
        want = np.asarray(ref._forward(params, rtg, obs, onehot))
        np.testing.assert_allclose(port.logits(rtg, obs, onehot), want,
                                   **FWD, err_msg=f"{n} steps")
    ref.params = params
    assert port.evaluate(episodes=1, max_steps=25) == \
        ref.evaluate(episodes=1, max_steps=25)
    o = rng.standard_normal(4).astype(np.float32)
    assert port.compute_single_action(o) == ref.compute_single_action(o)


def _posterior_logp(port, h, emb):
    """The unimixed posterior log-probs [.., G, C] on the port's side,
    to judge a latent that differs."""
    G, C = port.config.stoch_groups, port.config.stoch_classes
    post = port._mlp2(port.params, "post1", "post2", torch.cat([h, emb], -1))
    return torch.log(0.99 * torch.softmax(post.reshape(-1, G, C), -1)
                     + 0.01 / C).detach().numpy()


def test_dreamerv3_act_with_the_reference_noise():
    """DreamerV3's act() from a filter state mid-episode and from an
    episode start, with the Gumbel draws of the reference's split(key)
    handed over: h within 2e-5, the latent and the action the
    reference's but at near-ties."""
    ref, _ = _dv3_ref()
    cfg = ref.config
    G, C = cfg.stoch_groups, cfg.stoch_classes
    port = tdv3.DreamerV3Config(**DV3_TINY).build(device="cpu")
    rng = np.random.default_rng(4)
    act = _compiled(ref._act.__wrapped__)
    draw = _compiled(lambda key: tuple(
        jax.random.gumbel(k, s) for k, s in zip(jax.random.split(key),
                                                ((1, G, C), (1, 2)))))
    for step, is_first in enumerate((0.0, 1.0, 0.0)):
        h = (0.5 * rng.standard_normal(cfg.deter)).astype(np.float32)
        z = np.eye(C, dtype=np.float32)[rng.integers(0, C, G)].reshape(-1)
        obs = rng.standard_normal(4).astype(np.float32)
        key = jax.random.PRNGKey(40 + step)
        n_post, n_act = (np.asarray(x) for x in draw(key))
        wh, wz, wa = act(ref.params, h, z, 1, obs, jnp.float32(is_first),
                         key)
        gh, gz, ga = port.act(torch.tensor(h), torch.tensor(z), 1, obs,
                              is_first, torch.tensor(n_post),
                              torch.tensor(n_act))
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), **FWD)
        emb = port._encode(port.params, torch.tensor(obs)[None])
        _assert_latents(gz.numpy(), wz, _posterior_logp(
            port, gh[None], emb) + n_post, f"act {step}")
        np.testing.assert_allclose(gz.numpy(), np.asarray(wz), atol=1e-6)
        assert int(ga) == int(wa)


def test_dreamerv3_filter_latents_match_reference():
    """The world-model loss's filter over one batch with the reference's
    Gumbel draws: every posterior latent the reference's but at near-ties
    (reported), the loss and its aux within 2e-5."""
    ref, _ = _dv3_ref()
    cfg = ref.config
    wm_loss = _compiled(_closure(ref._update_grads.__wrapped__)["wm_loss"])
    batch = _dv3_batch(60, cfg)
    key = jax.random.PRNGKey(61)
    # The update hands the world-model loss the first of split(key, 3).
    kw = jax.random.split(key, 3)[0]
    want_loss, (_hs, want_zs, want_aux) = wm_loss(ref.params, batch, kw)
    post_noise = np.asarray(_compiled(
        lambda k: _dv3_draws(cfg, k)["post"])(key))
    port = tdv3.DreamerV3Config(**DV3_TINY).build(device="cpu")
    b = {k: torch.tensor(v) for k, v in batch.items()}
    loss, hs, zs, aux = port._wm_loss(port.params, b,
                                      torch.tensor(post_noise))
    np.testing.assert_allclose(loss.item(), float(want_loss), **FWD)
    for k in want_aux:
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]), **FWD,
                                   err_msg=k)
    emb = port._encode(port.params, b["obs"])
    for t in range(cfg.batch_length):
        _assert_latents(zs[:, t].numpy(), want_zs[:, t],
                        _posterior_logp(port, hs[:, t], emb[:, t])
                        + post_noise[t], f"filter t={t}")
    np.testing.assert_allclose(zs.numpy(), np.asarray(want_zs), atol=1e-6)


# ---------------- data and envs ----------------

def test_coopswitch_trajectories_match_reference():
    """CoopSwitch is the reference's, bitwise: resets from a seed and
    without, observations, global state, rewards, dones and infos over
    random joint actions; the port registers it as CoopSwitch-v0."""
    assert ENV_REGISTRY["CoopSwitch-v0"] is tqmix.CoopSwitch
    rng = np.random.default_rng(0)
    got_env, want_env = tqmix.CoopSwitch(seed=3), jqmix.CoopSwitch(seed=3)
    for ep in range(3):
        seed = None if ep == 1 else ep
        got, want = got_env.reset(seed=seed), want_env.reset(seed=seed)
        for _ in range(20):
            for a in want:
                np.testing.assert_array_equal(got[a], want[a])
            np.testing.assert_array_equal(got_env.global_state,
                                          want_env.global_state)
            acts = {a: int(rng.integers(2)) for a in want_env.agent_ids}
            got_out = got_env.step(acts)
            want_out = want_env.step(acts)
            got, want = got_out[0], want_out[0]
            assert got_out[1:] == want_out[1:]


def test_seq_replay_samples_the_reference_windows():
    """_SeqReplay fills and samples as the reference's, bitwise: before
    the ring wraps, after it wraps (windows across the write head
    resampled), and where eight resamples fail and the deterministic
    start stands in."""
    for capacity, steps, length, batch in ((64, 40, 8, 16),
                                           (64, 150, 8, 32),
                                           (20, 47, 16, 64)):
        got = tdv3._SeqReplay(capacity, 4, 2)
        want = jdv3._SeqReplay(capacity, 4, 2)
        rng = np.random.default_rng(capacity + steps)
        for t in range(steps):
            row = (rng.standard_normal(4).astype(np.float32),
                   int(rng.integers(2)), float(rng.random()),
                   float(rng.random() > 0.1), float(t % 13 == 0))
            got.add(*row)
            want.add(*row)
        assert (got.n, got.ptr) == (want.n, want.ptr)
        for seed in range(3):
            g = got.sample(np.random.default_rng(seed), batch, length)
            w = want.sample(np.random.default_rng(seed), batch, length)
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].dtype == w[k].dtype
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_dt_episodes_and_batches_match_reference(tmp_path):
    """DT's episodes (returns-to-go, undiscounted and at gamma 0.9) and
    its sampled batches are the reference's, bitwise."""
    path = _offline_file(tmp_path)
    for gamma in (1.0, 0.9):
        got = tdt.DTConfig(input_path=path, gamma=gamma).build(device="cpu")
        want = jdt.DTConfig(input_path=path, gamma=gamma).build()
        assert len(got.episodes) == len(want.episodes)
        for g, w in zip(got.episodes, want.episodes):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
        assert got.max_return == want.max_return
        for seed in range(2):
            g = got._sample_batch(np.random.default_rng(seed))
            w = want._sample_batch(np.random.default_rng(seed))
            for a, b in zip(g, w):
                b = np.asarray(b)
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


# ---------------- whole iterations ----------------

def test_qmix_train_iteration_matches_reference():
    """One QMIX.train() on both sides from one seed: the same actions and
    transitions in the buffer (bitwise), the same sampled batches, the
    mean TD loss within 2e-5, the same result otherwise."""
    got_algo = tqmix.QMIXConfig().build(device="cpu")
    want_algo = jqmix.QMIXConfig().build()
    got, want = got_algo.train(), want_algo.train()
    assert len(got_algo._buffer) == len(want_algo._buffer) == 256
    for g, w in zip(got_algo._buffer, want_algo._buffer):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got_algo.rng.bit_generator.state == \
        want_algo.rng.bit_generator.state
    np.testing.assert_allclose(got.pop("mean_loss"), want.pop("mean_loss"),
                               **FWD)
    got.pop("iter_time_s")
    want.pop("iter_time_s")
    assert got == want
    _hold(got_algo.params, _np(want_algo.params))
    obs = want_algo.env.reset(seed=9)
    assert got_algo.compute_actions(obs) == want_algo.compute_actions(obs)
