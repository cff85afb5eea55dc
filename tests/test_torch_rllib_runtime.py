"""The port's on-policy RLlib on its runtime (ray_tpu_torch.rllib: PPO's
rollout workers and algorithm, the LearnerGroup, IMPALA, APPO, PG, A2C,
A3C, ES/ARS, connectors, EnvRunner, bandits, the random agent) against
the JAX package's, on the CPU.

One port cluster for the file (4 CPUs, CUDA_VISIBLE_DEVICES "", so no
card), started once; every learner runs on device="cpu". The reference
objects are built in process, so its runtime never starts: a reference
actor is its class (`ActorClass._cls`), and a reference algorithm whose
constructor would start actors is made with object.__new__, its config
and params set before `_build_update()`, which reads only those.

Tolerances: f32 forward and losses 2e-5, grads and params 1e-4 (the JAX
package's flash tests' bounds). The MLP's rollouts are numpy in both
packages and held bitwise; the CNN's forward is torch on one side and
JAX on the other, so its actions are held equal and its logp and
advantages to 2e-5. Learners start mid-training where a test says so:
the reference's params and optax Adam state after two steps loaded into
the port's learner (`load_reference_state`).
"""

import dataclasses
import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib import __all__ as REF_ALL  # noqa: E402
from ray_tpu.rllib import a2c as ja2c  # noqa: E402
from ray_tpu.rllib import a3c as ja3c  # noqa: E402
from ray_tpu.rllib import appo as jappo  # noqa: E402
from ray_tpu.rllib import bandit as jbandit  # noqa: E402
from ray_tpu.rllib import connectors as jconn  # noqa: E402
from ray_tpu.rllib import env_runner as jrunner  # noqa: E402
from ray_tpu.rllib import es as jes  # noqa: E402
from ray_tpu.rllib import impala as jimpala  # noqa: E402
from ray_tpu.rllib import learner_group as jlg  # noqa: E402
from ray_tpu.rllib import pg as jpg  # noqa: E402
from ray_tpu.rllib import ppo as jppo  # noqa: E402
from ray_tpu.rllib import random_agent as jrandom  # noqa: E402
from ray_tpu.rllib.catalog import get_model as jget_model  # noqa: E402
from ray_tpu_torch import rllib as trllib  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402
from ray_tpu_torch.rllib import a2c as ta2c  # noqa: E402
from ray_tpu_torch.rllib import a3c as ta3c  # noqa: E402
from ray_tpu_torch.rllib import appo as tappo  # noqa: E402
from ray_tpu_torch.rllib import bandit as tbandit  # noqa: E402
from ray_tpu_torch.rllib import connectors as tconn  # noqa: E402
from ray_tpu_torch.rllib import env_runner as trunner  # noqa: E402
from ray_tpu_torch.rllib import es as tes  # noqa: E402
from ray_tpu_torch.rllib import impala as timpala  # noqa: E402
from ray_tpu_torch.rllib import learner_group as tlg  # noqa: E402
from ray_tpu_torch.rllib import pg as tpg  # noqa: E402
from ray_tpu_torch.rllib import ppo as tppo  # noqa: E402
from ray_tpu_torch.rllib import random_agent as trandom  # noqa: E402

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu", "msgpack",
          "cloudpickle")
FRAG = 64


@pytest.fixture(scope="module")
def rt():
    cfg = PortConfig()
    cfg.health_check_period_s = 0.2
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    old = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        ray_tpu_torch.init(num_cpus=4, config=cfg)
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if torch.is_tensor(v)
                                         else v)
    return out


def _hold(got: dict, want: dict, tol=GRAD):
    want = _flat(want)
    got = _flat(got)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **tol, err_msg=k)


def _equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


def _mlp(seed=0, hidden=32, obs=4, act=2):
    return tppo.init_policy_params(obs, act, hidden, seed)


def _ppo_rows(n, seed, obs=4, n_act=2):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((n, obs)).astype(np.float32),
            "actions": rng.integers(0, n_act, n).astype(np.int32),
            "logp": (np.log(1.0 / n_act)
                     + 0.3 * rng.standard_normal(n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "returns": rng.standard_normal(n).astype(np.float32)}


def _fragment(n, seed, obs=4, n_act=2):
    """An IMPALA fragment: behavior logp, rewards, dones (two episode
    ends) and the bootstrap observation."""
    rng = np.random.default_rng(seed)
    dones = np.zeros(n, np.float32)
    dones[[n // 3, n - 5]] = 1.0
    return {"obs": rng.standard_normal((n, obs)).astype(np.float32),
            "actions": rng.integers(0, n_act, n).astype(np.int32),
            "behavior_logp": (np.log(1.0 / n_act) + 0.3
                              * rng.standard_normal(n)).astype(np.float32),
            "rewards": rng.standard_normal(n).astype(np.float32),
            "dones": dones,
            "bootstrap_obs": rng.standard_normal(obs).astype(np.float32)}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _optax_state(opt_state):
    """(count, mu, nu) of an optax.adam state as numpy."""
    s = opt_state[0]
    return int(s.count), _np_tree(s.mu), _np_tree(s.nu)


# ---------------- rollout workers ----------------

ROLLOUTS = {  # case -> (env, model, hidden)
    "mlp": ("CartPole-v1", "mlp", 64),
    "atari_cnn": ("VisualCatch-v0", "atari_cnn", 256),
    "multi_agent": ("DualCartPole-v0", "mlp", 64),
}


@pytest.mark.parametrize("case", sorted(ROLLOUTS))
def test_rollout_worker_matches_reference(rt, case):
    """Two fragments of FRAG steps from worker 1 of each package, the same
    params: the MLP's bitwise (its forward is numpy in both), the CNN's
    actions equal and logp, advantages and returns within 2e-5. The port's
    worker holds one thread, no CUDA, no banned package."""
    env, model, hidden = ROLLOUTS[case]
    spec = jget_model(model)
    probe = trllib.make_env(env)
    obs_in = probe.observation_shape if model == "atari_cnn" \
        else probe.observation_size
    ours = tppo.RolloutWorker.remote(env, 1, 0.99, 0.95, model)
    ref = jppo.RolloutWorker._cls(env, 1, 0.99, 0.95, model)
    try:
        if case == "multi_agent":
            params = {"p0": spec.init_params(obs_in, 2, hidden, 0),
                      "p1": spec.init_params(obs_in, 2, hidden, 1)}
            mapping = {"agent_0": "p0", "agent_1": "p1"}
            for _ in range(2):
                got = rt.get(ours.sample_multi_agent.remote(params, FRAG,
                                                            mapping))
                want = ref.sample_multi_agent(params, FRAG, mapping)
                assert got["episode_returns"] == want["episode_returns"]
                assert sorted(got["policy_batches"]) == ["p0", "p1"]
                for pid, w in want["policy_batches"].items():
                    _equal(got["policy_batches"][pid], w)
            return
        params = spec.init_params(obs_in, probe.num_actions, hidden, 0)
        for _ in range(2):
            got = rt.get(ours.sample.remote(params, FRAG))
            want = ref.sample(params, FRAG)
            if model == "mlp":
                _equal(got, want)
                continue
            assert got["episode_returns"] == want["episode_returns"]
            for k in ("obs", "actions"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            for k in ("logp", "advantages", "returns"):
                np.testing.assert_allclose(got[k], want[k], **FWD, err_msg=k)
        state = rt.get(ours.process_state.remote())
        assert not state["cuda_initialized"]
        assert state["threads"] == tppo.ROLLOUT_THREADS
        assert not set(state["packages"]) & set(BANNED), state["packages"]
    finally:
        rt.kill(ours)


# ---------------- PPO end to end ----------------

def _ref_ppo(cfg, params=None, policy_params=None):
    """The reference's PPO with its jitted update, no actors."""
    algo = object.__new__(jppo.PPO)
    algo.config = cfg
    algo._spec = jget_model(cfg.model)
    algo.params = params
    algo.policy_params = policy_params
    algo._build_update()
    return algo


def _ref_sgd(algo, params, opt_state, batch, iteration):
    """PPO.train's SGD epochs over the reference's jitted update."""
    cfg = algo.config
    rng = np.random.default_rng(cfg.seed + iteration)
    n = len(batch["obs"])
    aux = {}
    for _ in range(cfg.num_sgd_iter):
        perm = rng.permutation(n)
        for s in range(0, n, cfg.sgd_minibatch_size):
            idx = perm[s: s + cfg.sgd_minibatch_size]
            params, opt_state, _l, aux = algo._update(
                params, opt_state, {k: v[idx] for k, v in batch.items()})
    return params, opt_state, aux


PPO_KW = dict(rollout_fragment_length=FRAG, train_batch_size=2 * FRAG,
              sgd_minibatch_size=32)


def test_ppo_train_matches_reference(rt):
    """One PPO.train() on the port's runtime (2 workers, fragment 64, the
    learner on the CPU) against the reference's rollout workers in process
    and its jitted update over the same concatenated batch and
    permutations: the episodes bitwise, the params within 1e-4; then
    compute_single_action."""
    cfg = dict(PPO_KW, hidden_size=32)
    algo = trllib.PPOConfig().training(**cfg).build(device="cpu")
    try:
        params0 = algo.get_policy_params()
        result = algo.train()
    finally:
        algo.stop()
    jcfg = jppo.PPOConfig().training(**cfg)
    want0 = jget_model("mlp").init_params(4, 2, 32, jcfg.seed)
    _equal(_flat(params0), _flat(want0))
    workers = [jppo.RolloutWorker._cls("CartPole-v1", i, jcfg.gamma,
                                       jcfg.lam, "mlp") for i in range(2)]
    frags = [w.sample(want0, FRAG) for w in workers]
    batch = {k: np.concatenate([f[k] for f in frags])
             for k in tppo.PPO._BATCH_KEYS}
    returns = sum((f["episode_returns"] for f in frags), [])
    ref = _ref_ppo(jcfg, params=want0)
    want, _opt, aux = _ref_sgd(ref, want0, ref._opt_state, batch, 0)
    assert result["training_iteration"] == 1
    assert result["timesteps_this_iter"] == len(batch["obs"]) == 2 * FRAG
    assert result["episodes_this_iter"] == len(returns)
    assert result["episode_reward_mean"] == float(np.mean(returns))
    for k, v in aux.items():
        np.testing.assert_allclose(result[k], float(v), **GRAD, err_msg=k)
    got = algo.get_policy_params()
    _hold(got, _np_tree(want))
    obs = batch["obs"][:3]
    for o in obs:
        logits, _ = jppo.numpy_forward(got, o[None])
        assert algo.compute_single_action(o) == int(np.argmax(logits[0]))


def test_ppo_multi_agent_matches_reference(rt):
    """Multi-agent PPO on DualCartPole, two policies from seed and seed +
    1, one PPOLearner each: one train() against the reference's per-policy
    update streams over its in-process workers' per-policy batches."""
    mapping_fn = ("agent_0", "agent_1").index
    pols = {"pol_a": None, "pol_b": None}

    def policy_map(aid):
        return ("pol_a", "pol_b")[mapping_fn(aid)]

    cfg = dict(PPO_KW, hidden_size=32, num_sgd_iter=2)
    algo = (trllib.PPOConfig().environment("DualCartPole-v0").training(**cfg)
            .multi_agent(policies=pols, policy_mapping_fn=policy_map)
            .build(device="cpu"))
    try:
        start = algo.policy_params
        result = algo.train()
        with pytest.raises(ValueError, match="policy_id"):
            algo.get_policy_params()
    finally:
        algo.stop()
    jcfg = (jppo.PPOConfig().environment("DualCartPole-v0").training(**cfg)
            .multi_agent(policies=pols, policy_mapping_fn=policy_map))
    pp = {pid: jget_model("mlp").init_params(4, 2, 32, i)
          for i, pid in enumerate(sorted(pols))}
    for pid in pp:
        _equal(_flat(start[pid]), _flat(pp[pid]))
    mapping = {a: policy_map(a) for a in ("agent_0", "agent_1")}
    workers = [jppo.RolloutWorker._cls("DualCartPole-v0", i, jcfg.gamma,
                                       jcfg.lam, "mlp") for i in range(2)]
    outs = [w.sample_multi_agent(pp, FRAG, mapping) for w in workers]
    ref = _ref_ppo(jcfg, policy_params=pp)
    steps = 0
    for pid in sorted(pols):
        parts = [o["policy_batches"][pid] for o in outs]
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        steps += len(batch["obs"])
        want, _o, _a = _ref_sgd(ref, pp[pid], ref._opt_state[pid], batch, 0)
        _hold(algo.get_policy_params(pid), _np_tree(want))
    assert result["timesteps_this_iter"] == steps
    a, b = (algo.get_policy_params(p)["h1"]["w"] for p in sorted(pols))
    assert np.abs(a - b).max() > 0


# ---------------- LearnerGroup ----------------

def _ref_mean_step(actor, params, opt_state, shards):
    """The reference learner's step on the mean of the shards' grads (its
    flat f32 sum over the group divided by the world)."""
    grads = [actor._grad(params, s)[0] for s in shards]
    flat = [actor._flatten(g) for g in grads]
    mean = (flat[0] + flat[1]) / np.float32(2)
    return actor._apply(params, opt_state, actor._unflatten(mean))


def test_learner_group_step_matches_the_mean_gradient(rt):
    """Two learners over gloo: update_shards within 1e-4 of the
    reference's step on the mean of the two shards' gradients; the
    fingerprints equal, and at init equal to the reference learner's
    (one leaf order); save_state/restore_state round-trip bitwise."""
    group = tlg.LearnerGroup(num_learners=2, model="mlp", obs_size=4,
                             num_actions=2, hidden=32, lr=1e-3,
                             entropy_coeff=0.01, device="cpu")
    try:
        _hold_group_step(group)
    finally:
        group.shutdown()


def _hold_group_step(group):
    assert group.backend == "gloo" and group.num_gpus == 0
    ref = jlg.LearnerActor._cls(0, 1, "ref", "mlp", 4, 2, 32, 1e-3, 0.2,
                                0.5, 0.01, 0)
    fps = group.fingerprints()
    assert fps[0] == fps[1] == ref.params_fingerprint()
    shards = [_ppo_rows(32, seed=s) for s in (1, 2)]
    got = group.update_shards(shards)
    want_p, want_opt = _ref_mean_step(ref, ref.params, ref.opt_state, shards)
    _hold(group.get_params(), _np_tree(want_p))
    losses = [float(ref._grad(ref.params, s)[1]) for s in shards]
    np.testing.assert_allclose(got["loss"], np.mean(losses), **FWD)
    fps = group.fingerprints()
    assert fps[0] == fps[1]
    stats = group.comm_stats()
    n = sum(v.size for v in _flat(ref.params).values())
    assert [s["updates"] for s in stats] == [1, 1]
    assert [s["allreduce_bytes"] for s in stats] == [4 * n, 4 * n]

    # Round trip: the state saved, one more step, the state restored: the
    # same fingerprint, and the same step again bitwise.
    blob = group.save_state()
    more = [_ppo_rows(32, seed=s) for s in (3, 4)]
    group.update_shards(more)
    after = group.fingerprints()
    group.restore_state(blob)
    assert group.fingerprints() == fps
    group.update_shards(more)
    assert group.fingerprints() == after
    assert after[0] != fps[0]
    # Mid-training: the reference's state after its second step.
    want_p, _o = _ref_mean_step(ref, want_p, want_opt, more)
    _hold(group.get_params(), _np_tree(want_p))


def test_learner_group_impala_loss(rt):
    """The IMPALA variant: one whole fragment a learner, the step within
    1e-4 of the reference's on the mean gradient of its IMPALA loss."""
    kw = {"gamma": 0.99, "clip_rho": 1.0, "clip_c": 1.0}
    group = tlg.LearnerGroup(num_learners=2, model="mlp", obs_size=4,
                             num_actions=2, hidden=32, lr=5e-4,
                             entropy_coeff=0.01, algo="impala",
                             algo_kwargs=kw, device="cpu")
    try:
        shards = [_fragment(FRAG, seed=s) for s in (5, 6)]
        got = group.update_shards(shards)
        assert set(got) == {"loss", "pi_loss", "vf_loss", "entropy",
                            "mean_rho"}
        ref = jlg.LearnerActor._cls(0, 1, "ref", "mlp", 4, 2, 32, 5e-4, 0.2,
                                    0.5, 0.01, 0, "impala", kw)
        want_p, _ = _ref_mean_step(ref, ref.params, ref.opt_state, shards)
        _hold(group.get_params(), _np_tree(want_p))
        fps = group.fingerprints()
        assert fps[0] == fps[1]
    finally:
        group.shutdown()


# ---------------- losses and one Adam step, from mid-training ----------------

def _ref_algo(cls, cfg, params, **attrs):
    algo = object.__new__(cls)
    algo.config = cfg
    algo.params = params
    for k, v in attrs.items():
        setattr(algo, k, v)
    algo._build_update()
    return algo


def _closure(fn) -> dict:
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _port_learner(loss_fn, lr, params, opt_state):
    """A port learner holding the reference's state mid-training."""
    learner = tppo.TorchLearner(params, loss_fn, lr, "cpu")
    tppo.load_reference_state(learner, params, *_optax_state(opt_state))
    return learner


def _step_pairs(name):
    """(reference update -> (params, opt, loss, aux), port loss) of an
    algorithm, and its batches."""
    p0 = _mlp(seed=3)
    if name in ("impala", "appo"):
        batches = [_fragment(FRAG, seed=s) for s in range(10, 15)]
    else:
        batches = [_ppo_rows(FRAG, seed=s) for s in range(10, 15)]
    if name == "impala":
        cfg = jimpala.ImpalaConfig(hidden_size=32)
        ref = _ref_algo(jimpala.Impala, cfg, p0)
        port = timpala.make_impala_loss(
            gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
            entropy_coeff=cfg.entropy_coeff, clip_rho=cfg.vtrace_clip_rho,
            clip_c=cfg.vtrace_clip_c)
        return cfg, ref, ref._update, port, batches
    if name == "pg":
        cfg = jpg.PGConfig(hidden_size=32, entropy_coeff=0.01)
        ref = _ref_algo(jpg.PG, cfg, p0)

        def update(p, o, b):
            p, o, m = ref._update(p, o, b)
            return p, o, m["loss"], {"pg_loss": m["pg_loss"],
                                     "vf_loss": m["vf_loss"],
                                     "entropy": m["entropy"]}

        return cfg, ref, update, tpg.make_pg_loss(cfg.vf_coeff,
                                                  cfg.entropy_coeff), batches
    cfg = ja2c.A2CConfig(hidden_size=32)
    ref = _ref_algo(ja2c.A2C, cfg, p0)
    return cfg, ref, ref._update, ta2c.make_a2c_loss(
        cfg.vf_coeff, cfg.entropy_coeff), batches


@pytest.mark.parametrize("name", ["a2c", "impala", "pg"])
def test_loss_and_adam_step_match_reference(name):
    """Two reference steps make a mid-training state; the port's learner
    takes it (params and optax's count, mu, nu) and both take three more
    steps: every loss and aux term within 2e-5, the params within 1e-4."""
    cfg, ref, update, port_loss, batches = _step_pairs(name)
    p, o = ref.params, ref._opt_state
    for b in batches[:2]:
        p, o, _l, _a = update(p, o, b)
    learner = _port_learner(port_loss, cfg.lr, _np_tree(p), o)
    for b in batches[2:]:
        p, o, jl, jaux = update(p, o, b)
        tl, taux = learner.update(b)
        np.testing.assert_allclose(tl.item(), float(jl), **FWD)
        assert sorted(taux) == sorted(jaux)
        for k in jaux:
            np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **FWD,
                                       err_msg=k)
    _hold(learner.params, _np_tree(p))


def test_vtrace_matches_reference():
    """V-trace's targets and advantages against the reference's own
    vtrace (the closure of its IMPALA loss), rhos clipped on both sides."""
    cfg = jimpala.ImpalaConfig()
    ref_vtrace = _closure(jimpala.make_impala_loss(
        gamma=cfg.gamma, vf_coeff=0.5, entropy_coeff=0.0, clip_rho=1.0,
        clip_c=0.9))["vtrace"]
    rng = np.random.default_rng(7)
    f = _fragment(FRAG, seed=8)
    values = rng.standard_normal(FRAG).astype(np.float32)
    boot = np.float32(0.3)
    rhos = np.exp(0.5 * rng.standard_normal(FRAG)).astype(np.float32)
    want = ref_vtrace(values, boot, f["rewards"], f["dones"], rhos)
    got = timpala.vtrace(*(torch.as_tensor(x) for x in (
        values, boot, f["rewards"], f["dones"], rhos)), gamma=cfg.gamma,
        clip_rho=1.0, clip_c=0.9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FWD)


def test_appo_learner_matches_reference():
    """APPO from mid-training (two of the reference's steps), then three
    steps: the target network syncs after the fourth step on both sides."""
    cfg = jappo.APPOConfig(hidden_size=32, target_update_freq=4)
    p0 = _mlp(seed=4)
    ref = _ref_algo(jappo.APPO, cfg, p0, _steps_since_sync=0)
    batches = [_fragment(FRAG, seed=s) for s in range(20, 25)]
    p, o = ref.params, ref._opt_state
    for b in batches[:2]:
        p, o, _l, _a = ref._update(p, o, b)
    learner = tappo.APPOLearner(p0, cfg, "cpu")
    tppo.load_reference_state(learner, _np_tree(p), *_optax_state(o))
    learner._steps_since_sync = 2
    for b in batches[2:]:
        p, o, jl, jaux = ref._update(p, o, b)
        tl, taux = learner.update(b)
        np.testing.assert_allclose(tl.item(), float(jl), **FWD)
        for k in jaux:
            np.testing.assert_allclose(taux[k].item(), float(jaux[k]), **FWD,
                                       err_msg=k)
    assert learner._steps_since_sync == ref._steps_since_sync == 1
    _hold(learner.params, _np_tree(p))
    _hold(learner.target, _np_tree(ref._target_params))


def test_adam_state_round_trip():
    """adam_state reads back what load_reference_state wrote: the optax
    state after two steps, as numpy."""
    cfg = ja2c.A2CConfig(hidden_size=32)
    ref = _ref_algo(ja2c.A2C, cfg, _mlp(seed=5))
    p, o = ref.params, ref._opt_state
    for s in (1, 2):
        p, o, _l, _a = ref._update(p, o, _ppo_rows(FRAG, seed=s))
    learner = _port_learner(ta2c.make_a2c_loss(0.5, 0.01), cfg.lr,
                            _np_tree(p), o)
    count, mu, nu = _optax_state(o)
    st = tppo.adam_state(learner)
    assert st["count"] == count == 2
    _equal(_flat(st["mu"]), _flat(mu))
    _equal(_flat(st["nu"]), _flat(nu))


# ---------------- the algorithms on the runtime ----------------

def test_async_and_sync_algorithms_train(rt):
    """IMPALA (in the driver and on a 2-learner group), APPO, PG, A2C and
    A3C each take one train() on the runtime: finite losses, the steps
    counted as the reference counts them. Their arrival order is not
    deterministic, so the math is held above on fixed batches."""
    runs = [(timpala.ImpalaConfig(num_learners=2, num_fragments_per_iter=2),
             "loss"),
            (timpala.ImpalaConfig(num_fragments_per_iter=2), "vf_loss"),
            (tappo.APPOConfig(num_fragments_per_iter=2), "mean_ratio"),
            (tpg.PGConfig(), "pg_loss"), (ta2c.A2CConfig(), "pi_loss"),
            (ta3c.A3CConfig(batches_per_iter=2), "mean_loss")]
    for cfg, key in runs:
        algo = cfg.training(rollout_fragment_length=FRAG).build(device="cpu")
        try:
            r = algo.train()
        finally:
            algo.stop()
        assert r["training_iteration"] == 1
        assert np.isfinite(r[key]), (type(algo).__name__, r)
        steps = r.get("timesteps_total", r.get("timesteps_this_iter"))
        assert steps == 2 * FRAG, (type(algo).__name__, r)
    with pytest.raises(ValueError, match="multiple of num_learners"):
        timpala.ImpalaConfig(num_learners=3).build(device="cpu")


def test_builds_need_a_card(rt):
    """build() with no device puts the learner on the card: without one
    it raises, in the driver or for the learner group, and starts no
    actor; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    for cfg in (trllib.PPOConfig(), trllib.ImpalaConfig(),
                trllib.APPOConfig(), trllib.PGConfig(), trllib.A2CConfig(),
                trllib.A3CConfig(), trllib.DQNConfig(),
                trllib.SimpleQConfig(), trllib.ApexDQNConfig(),
                trllib.RainbowConfig(), trllib.R2D2Config(),
                trllib.TD3Config(), trllib.DDPGConfig(), trllib.SACConfig(),
                trllib.MADDPGConfig(), trllib.SlateQConfig(),
                trllib.AlphaZeroConfig(),
                # The offline three raise before they read their data.
                trllib.CQLConfig(input_path="data.jsonl"),
                trllib.CRRConfig(input_path="data.jsonl"),
                trllib.DTConfig(input_path="data.jsonl"),
                trllib.QMIXConfig(), trllib.DreamerV3Config()):
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.build()
    for cfg in (trllib.PPOConfig(num_learners=2),
                trllib.ImpalaConfig(num_learners=2)):
        with pytest.raises(RuntimeError, match="cards"):
            cfg.build()


# ---------------- ES / ARS ----------------

class _Direct:
    """A reference actor called in process: .method.remote(*a) runs it."""

    def __init__(self, obj):
        self._obj = obj

    def __getattr__(self, name):
        return types.SimpleNamespace(remote=getattr(self._obj, name))


class _Fixed:
    """An evaluation worker whose results are drawn from a seed."""

    def __init__(self, rng):
        self.evaluate = types.SimpleNamespace(
            remote=lambda vec, spec, eps, steps: (float(rng.normal()),
                                                  int(rng.integers(9, 99))))


def _fake_runtime(monkeypatch, module, attr):
    monkeypatch.setattr(module, attr, types.SimpleNamespace(
        get=lambda futs, timeout=None: futs, kill=lambda a: None))


def _new_es(module, cls, cfg, workers):
    algo = object.__new__(cls)
    algo.config = cfg
    probe = module.make_env(cfg.env)
    params = module.init_policy_params(probe.observation_size,
                                       probe.num_actions, cfg.hidden_size,
                                       cfg.seed)
    algo.theta, algo.spec = module._flatten(params)
    algo.rng = np.random.default_rng(cfg.seed)
    algo.workers = workers
    algo.iteration = algo.total_steps = 0
    return algo


@pytest.mark.parametrize("algo_name", ["ES", "ARS"])
def test_es_and_ars_updates_are_the_reference(monkeypatch, algo_name):
    """_center_weights bitwise; one train() whose evaluations are fixed
    (drawn from one seed on both sides): theta bitwise; the evaluation
    worker's episodes bitwise."""
    cfgs = {"ES": (tes.ESConfig, jes.ESConfig, tes.ES, jes.ES),
            "ARS": (tes.ARSConfig, jes.ARSConfig, tes.ARS, jes.ARS)}
    tcfg_cls, jcfg_cls, tcls, jcls = cfgs[algo_name]
    kw = dict(population=6, max_episode_steps=50)
    _fake_runtime(monkeypatch, tes, "ray_tpu_torch")
    _fake_runtime(monkeypatch, jes, "ray_tpu")
    algos = []
    for module, cls, cfg in ((tes, tcls, tcfg_cls(**kw)),
                             (jes, jcls, jcfg_cls(**kw))):
        rng = np.random.default_rng(11)
        algos.append(_new_es(module, cls, cfg, [_Fixed(rng), _Fixed(rng)]))
    ours, ref = algos
    np.testing.assert_array_equal(ours.theta, ref.theta)
    assert ours.spec == ref.spec
    r = np.random.default_rng(3).standard_normal(12)
    np.testing.assert_array_equal(ours._center_weights(r),
                                  ref._center_weights(r))
    got, want = ours.train(), ref.train()
    np.testing.assert_array_equal(ours.theta, ref.theta)
    assert {k: v for k, v in got.items() if k != "iter_time_s"} == \
        {k: v for k, v in want.items() if k != "iter_time_s"}
    _equal(_flat(ours.get_policy_params()), _flat(ref.get_policy_params()))
    w_ours = tes._EvalWorker._cls("CartPole-v1", 1)
    w_ref = jes._EvalWorker._cls("CartPole-v1", 1)
    for _ in range(2):
        assert w_ours.evaluate(ours.theta, ours.spec, 2, 50) == \
            w_ref.evaluate(ref.theta, ref.spec, 2, 50)


def test_es_train_on_the_runtime_is_the_reference(rt, monkeypatch):
    """ES.train() with its evaluation actors on the runtime against the
    reference's train() over in-process evaluation workers: theta
    bitwise (each worker takes its candidates in order, seeded by its
    index)."""
    kw = dict(population=4, max_episode_steps=40)
    ours = tes.ESConfig(**kw).build()
    try:
        ours.train()
    finally:
        ours.stop()
    _fake_runtime(monkeypatch, jes, "ray_tpu")
    ref = _new_es(jes, jes.ES, jes.ESConfig(**kw), [
        _Direct(jes._EvalWorker._cls("CartPole-v1", i)) for i in range(2)])
    ref.train()
    np.testing.assert_array_equal(ours.theta, ref.theta)


# ---------------- connectors, EnvRunner, bandits, random agent ----------------

def test_connector_pipeline_units():
    """tests/test_rllib_new_algos.py::test_connector_pipeline_units on the
    port, each output also held bitwise to the reference's."""
    pipes = [m.ConnectorPipeline([m.FlattenObs(), m.NormalizeObs()])
             for m in (tconn, jconn)]
    for i in range(20):
        outs = [p(np.full((2, 2), float(i))) for p in pipes]
        np.testing.assert_array_equal(*outs)
        assert outs[0].shape == (4,)
    assert np.all(np.abs(outs[0]) <= 10.0)
    state = pipes[0].state()
    assert state == pipes[1].state()
    pipe2 = tconn.ConnectorPipeline([tconn.FlattenObs(), tconn.NormalizeObs()])
    pipe2.set_state(state)
    x = np.ones((2, 2)) * 3.0
    np.testing.assert_allclose(pipes[0](x), pipe2(x), rtol=1e-6)

    fs = tconn.FrameStack(k=3)
    a = fs(np.zeros(2))
    assert a.shape == (6,)
    fs.reset()
    b = fs(np.ones(2))
    assert b.tolist() == [1, 1, 1, 1, 1, 1]

    act = tconn.RescaleActions(low=np.array([-2.0]), high=np.array([2.0]))
    assert act(np.array([1.0]))[0] == pytest.approx(2.0)
    assert tconn.ClipActions()(np.array([5.0]))[0] == 1.0


def test_env_runner_vectorized_sampling():
    """tests/test_rllib_new_algos.py::test_env_runner_vectorized_sampling
    on the port, the fragment bitwise the reference's."""
    frags = []
    for runner_mod, ppo in ((trunner, tppo), (jrunner, jppo)):
        runner = runner_mod.EnvRunner("CartPole-v1", num_envs=3, seed=0)
        params = ppo.init_policy_params(runner.observation_size, 2)
        rng = np.random.default_rng(0)

        def fwd(obs, params=params, ppo=ppo):
            return ppo.numpy_forward(params, obs)

        def sample(logits, _i, rng=rng):
            p = np.exp(logits - logits.max())
            p /= p.sum()
            a = int(rng.choice(len(p), p=p))
            return a, float(np.log(p[a] + 1e-8))

        frags.append(runner.sample_fragment(fwd, sample, num_steps=40))
    frag = frags[0]
    assert frag["obs"].shape == (120, 4)
    assert frag["actions"].shape == (120,)
    assert frag["num_envs"] == 3
    assert frag["done"].sum() >= 1
    _equal(frag, frags[1])


def test_bandit_linucb_and_ts_beat_random():
    """tests/test_rllib_families.py::test_bandit_linucb_and_ts_beat_random
    on the port, each iteration's result the reference's."""
    for mode in ("ucb", "ts"):
        algos = [m.BanditConfig().environment("LinearBandit-v0")
                 .training(exploration=mode, steps_per_iter=200).build()
                 for m in (tbandit, jbandit)]
        out = []
        for _ in range(4):
            got, want = (a.train() for a in algos)
            got.pop("iter_time_s")
            want.pop("iter_time_s")
            assert got == want
            out.append(got)
        assert out[-1]["mean_regret"] < out[0]["mean_regret"]
    env = tbandit.LinearDiscreteBandit(seed=0)
    rng = np.random.default_rng(0)
    env.reset(seed=1)
    regrets = []
    for _ in range(200):
        _obs, _r, _d, info = env.step(int(rng.integers(env.num_actions)))
        regrets.append(info["regret"])
    assert out[-1]["mean_regret"] < np.mean(regrets)


def test_random_agent_baseline():
    """tests/test_rllib_families.py::test_random_agent_baseline on the
    port, the result the reference's."""
    got = trandom.RandomAgentConfig().environment("CartPole-v1").build() \
        .train()
    want = jrandom.RandomAgentConfig().environment("CartPole-v1").build() \
        .train()
    assert got["episodes_this_iter"] == 8
    assert 5 <= got["episode_reward_mean"] <= 200
    got.pop("iter_time_s")
    want.pop("iter_time_s")
    assert got == want


def test_exports_and_configs_match_reference():
    """The package exports every one of the reference's names, in its
    __all__ order, and every config's defaults are the reference's; Tune
    exports the reference's names in its order."""
    ported = [n for n in REF_ALL if hasattr(trllib, n)]
    assert ported == list(REF_ALL)
    assert trllib.__all__[:len(ported)] == ported
    for n in ("PPO", "Impala", "APPO", "PG", "A2C", "A3C", "ES", "ARS",
              "EnvRunner", "Bandit", "RandomAgent", "ConnectorPipeline",
              "DQN", "SimpleQ", "ApexDQN", "Rainbow", "R2D2", "TD3", "DDPG",
              "SAC", "MADDPG", "SlateQ", "AlphaZero", "CQL", "CRR",
              "ReplayBuffer", "PrioritizedReplayBuffer", "SequenceReplay",
              "CoopNav", "SlateDocEnv", "MCTS", "TicTacToe"):
        assert n in ported
    for n in ("DT", "QMIX", "CoopSwitch", "DreamerV3"):
        assert n in ported
    pairs = [(tppo.PPOConfig, jppo.PPOConfig),
             (timpala.ImpalaConfig, jimpala.ImpalaConfig),
             (tappo.APPOConfig, jappo.APPOConfig),
             (tpg.PGConfig, jpg.PGConfig), (ta2c.A2CConfig, ja2c.A2CConfig),
             (ta3c.A3CConfig, ja3c.A3CConfig),
             (tes.ESConfig, jes.ESConfig), (tes.ARSConfig, jes.ARSConfig),
             (tbandit.BanditConfig, jbandit.BanditConfig),
             (trandom.RandomAgentConfig, jrandom.RandomAgentConfig)]
    from ray_tpu import rllib as jrllib

    pairs += [(getattr(trllib, n), getattr(jrllib, n)) for n in (
        "DQNConfig", "SimpleQConfig", "ApexDQNConfig", "RainbowConfig",
        "R2D2Config", "TD3Config", "DDPGConfig", "SACConfig",
        "MADDPGConfig", "SlateQConfig", "AlphaZeroConfig", "CQLConfig",
        "CRRConfig", "DTConfig", "QMIXConfig", "DreamerV3Config")]
    for t, j in pairs:
        assert dataclasses.asdict(t()) == dataclasses.asdict(j()), t
    assert tlg.LearnerGroup.__name__ == "LearnerGroup"
    from ray_tpu import tune as jtune
    from ray_tpu_torch import tune as ttune

    assert ttune.__all__ == jtune.__all__
