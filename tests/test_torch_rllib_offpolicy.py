"""The port's off-policy RLlib (ray_tpu_torch.rllib: the replay buffers,
DQN, SimpleQ, Ape-X, Rainbow, R2D2, TD3/DDPG, SAC, MADDPG, SlateQ,
AlphaZero, and the offline CQL and CRR) against the JAX package's, on the
CPU.

The reference objects are built in process, so its runtime never starts:
a reference actor is its class (`ActorClass._cls`), and a reference
algorithm is made with object.__new__, its config and params set before
`_build_update()`, which reads only those. Each update is held from
mid-training: two of the reference's jitted steps, their params, targets
and optax Adam states loaded into the port's learner, then three more
steps on both sides. Where the reference draws noise with jax.random
inside its update (TD3's target smoothing, SAC's reparameterisation,
Rainbow's noisy nets), the test draws the same normals from the same key
with jax and hands them to the port's update.

One port cluster for the file (4 CPUs, CUDA_VISIBLE_DEVICES "", so no
card) runs one train() of each actor-based algorithm, the learner on
device="cpu".

Tolerances: f32 losses 2e-5, params, targets and log_alpha 1e-4 (the JAX
package's flash tests' bounds). Buffers, environments, MCTS and the
rollout workers are numpy in both packages and held bitwise.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
pytest.importorskip("optax")

import jax.numpy as jnp  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.rllib import alphazero as jaz  # noqa: E402
from ray_tpu.rllib import cql as jcql  # noqa: E402
from ray_tpu.rllib import crr as jcrr  # noqa: E402
from ray_tpu.rllib import ddpg as jddpg  # noqa: E402
from ray_tpu.rllib import dqn as jdqn  # noqa: E402
from ray_tpu.rllib import maddpg as jmaddpg  # noqa: E402
from ray_tpu.rllib import ppo as jppo  # noqa: E402
from ray_tpu.rllib import r2d2 as jr2d2  # noqa: E402
from ray_tpu.rllib import rainbow as jrainbow  # noqa: E402
from ray_tpu.rllib import replay as jreplay  # noqa: E402
from ray_tpu.rllib import sac as jsac  # noqa: E402
from ray_tpu.rllib import simple_q as jsq  # noqa: E402
from ray_tpu.rllib import slateq as jslateq  # noqa: E402
from ray_tpu_torch import rllib as trllib  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402
from ray_tpu_torch.rllib import alphazero as taz  # noqa: E402
from ray_tpu_torch.rllib import cql as tcql  # noqa: E402
from ray_tpu_torch.rllib import crr as tcrr  # noqa: E402
from ray_tpu_torch.rllib import ddpg as tddpg  # noqa: E402
from ray_tpu_torch.rllib import dqn as tdqn  # noqa: E402
from ray_tpu_torch.rllib import maddpg as tmaddpg  # noqa: E402
from ray_tpu_torch.rllib import r2d2 as tr2d2  # noqa: E402
from ray_tpu_torch.rllib import rainbow as trainbow  # noqa: E402
from ray_tpu_torch.rllib import replay as treplay  # noqa: E402
from ray_tpu_torch.rllib import sac as tsac  # noqa: E402
from ray_tpu_torch.rllib import simple_q as tsq  # noqa: E402
from ray_tpu_torch.rllib import slateq as tslateq  # noqa: E402
from ray_tpu_torch.rllib import utils as tutils  # noqa: E402
from ray_tpu_torch.rllib.offline import write_offline_json  # noqa: E402
from ray_tpu_torch.rllib.ppo import (load_adam_state,  # noqa: E402
                                     load_reference_state, load_tree,
                                     sorted_items)

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu", "msgpack",
          "cloudpickle")
B = 32          # rows (sequences for R2D2) of a test batch


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


@pytest.fixture
def keep_threads():
    """A rollout actor made in process sets torch's threads to one; the
    test process gets its own count back."""
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


def _flat(tree) -> dict:
    """path -> a numpy copy of the leaf (never a view of a live tensor)."""
    return {"/".join(map(str, path)): np.array(
        leaf.detach() if torch.is_tensor(leaf) else leaf)
        for path, leaf in sorted_items(tree)}


def _hold(got, want, tol=GRAD):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, **tol, err_msg=k)


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam(opt_state):
    """(count, mu, nu) of an optax.adam or adamw state, as numpy."""
    s = opt_state[0]
    return int(s.count), _np(s.mu), _np(s.nu)


def _ref(cls, cfg, **attrs):
    """The reference's algorithm with its jitted update, no actors."""
    algo = object.__new__(cls)
    algo.config = cfg
    for k, v in attrs.items():
        setattr(algo, k, v)
    algo._build_update()
    return algo


# ---------------- batches ----------------

def _transitions(seed, obs=4, n_act=2, act=None, weights=False):
    rng = np.random.default_rng(seed)
    out = {"obs": rng.standard_normal((B, obs)).astype(np.float32),
           "next_obs": rng.standard_normal((B, obs)).astype(np.float32),
           "actions": rng.uniform(-1, 1, (B, act)).astype(np.float32)
           if act else rng.integers(0, n_act, B).astype(np.int32),
           "rewards": rng.standard_normal(B).astype(np.float32),
           "dones": (rng.random(B) < 0.2).astype(np.float32)}
    if weights:
        out["weights"] = rng.uniform(0.2, 1.0, B).astype(np.float32)
    return out


def _sequences(seed, cfg, obs=4, n_act=2):
    rng = np.random.default_rng(seed)
    T = cfg.seq_len
    return {"obs": rng.standard_normal((B, T, obs)).astype(np.float32),
            "next_obs": rng.standard_normal((B, T, obs)).astype(np.float32),
            "actions": rng.integers(0, n_act, (B, T)).astype(np.int32),
            "rewards": rng.standard_normal((B, T)).astype(np.float32),
            "dones": (rng.random((B, T)) < 0.1).astype(np.float32),
            "resets": (rng.random((B, T)) < 0.15).astype(np.float32),
            "h0": (0.5 * rng.standard_normal((B, cfg.hidden_size))
                   ).astype(np.float32)}


def _joint(seed, n=2, obs=4, act=1):
    rng = np.random.default_rng(seed)
    return {"obs": rng.standard_normal((B, n, obs)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (B, n, act)).astype(np.float32),
            "rewards": rng.standard_normal(B).astype(np.float32),
            "next_obs": rng.standard_normal((B, n, obs)).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32)}


def _slates(seed, docs):
    rng = np.random.default_rng(seed)

    def users():
        u = rng.standard_normal((B, docs.shape[1])).astype(np.float32)
        return u / np.linalg.norm(u, axis=1, keepdims=True)

    return {"user": users(),
            "clicked_doc": docs[rng.integers(0, len(docs), B)],
            "reward": rng.uniform(0, 1, B).astype(np.float32),
            "next_user": users(),
            "done": (rng.random(B) < 0.2).astype(np.float32)}


def _games(seed):
    rng = np.random.default_rng(seed)
    return {"boards": rng.integers(-1, 2, (B, 9)).astype(np.float32),
            "pis": rng.dirichlet(np.ones(9), B).astype(np.float32),
            "zs": rng.integers(-1, 2, B).astype(np.float32)}


def _offline_file(tmp_path, n=160, seed=0):
    rng = np.random.default_rng(seed)
    dones = (rng.random(n) < 0.05).astype(np.float32)
    path = str(tmp_path / "data.jsonl")
    write_offline_json(path, [{
        "obs": rng.standard_normal((n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n).astype(np.int32),
        "rewards": rng.standard_normal(n).astype(np.float32),
        "dones": dones}])
    return path


def _key(i):
    return jax.random.PRNGKey(1000 + i)


def _with_noise(update, draws, key_arg: int = -1):
    """The reference's update (the function its _update jits) and the
    normals `draws(key)` gives, jitted as one program: (update's outputs,
    normals), the key the update's argument `key_arg`. One compile of the
    random bits, where a second program would compile them again."""
    return jax.jit(lambda *args: (update.__wrapped__(*args),
                                  draws(args[key_arg])))


def _torch_tree(tree):
    return jax.tree_util.tree_map(lambda x: torch.tensor(np.asarray(x)),
                                  tree)


# ---------------- the updates, from mid-training ----------------

class _Pair:
    """One algorithm's update on both sides. ref_step(state, batch, i) ->
    (state, losses) runs the reference's jitted update; port(state)
    makes the port's learner from a reference state; port_step(learner,
    batch, i) -> losses; sync(state, learner) syncs both targets
    (reference: the driver's snapshot; port: the learner's sync);
    held(state, learner) -> [(port tree, reference tree)] to compare."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


@functools.cache
def _dqn_pair(algo):
    if algo == "apex":
        jcfg, tcfg, jcls = jsq.ApexDQNConfig(), tsq.ApexDQNConfig(), \
            jsq.ApexDQN
        learner_cls = tsq.ApexLearner
    elif algo == "simple_q":
        jcfg, tcfg, jcls = jsq.SimpleQConfig(), tsq.SimpleQConfig(), \
            jsq.SimpleQ
        learner_cls = tdqn.DQNLearner
    else:
        jcfg, tcfg, jcls = jdqn.DQNConfig(), tdqn.DQNConfig(), jdqn.DQN
        learner_cls = tdqn.DQNLearner
    p0 = jdqn.init_q_params(4, 2, jcfg.hidden_size, seed=3)
    ref = _ref(jcls, jcfg, params=p0)
    apex = algo == "apex"

    def ref_step(st, b, i):
        out = ref._update(st["params"], st["target"], st["opt"], b)
        st = dict(st, params=out[0], opt=out[1])
        return st, {"loss": out[2], **({"td_error": out[3]} if apex else {})}

    def port(st):
        learner = learner_cls(tcfg, 4, 2, device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        return learner

    def port_step(learner, b, i):
        loss, aux = learner.update(b)
        return {"loss": loss, **aux}

    def sync(st, learner):
        learner.sync_target()
        return dict(st, target=st["params"])

    return _Pair(
        state={"params": p0, "target": p0, "opt": ref._opt_state},
        batch=lambda s: _transitions(s, weights=apex), ref_step=ref_step,
        port=port, port_step=port_step, sync=sync,
        held=lambda st, lr: [(lr.params, st["params"]),
                             (lr.target, st["target"])])


def _rainbow_draws(cfg, A):
    """key -> the normals the reference's rainbow loss draws from it (its
    sample_eps of each of split(key, 3)), in NOISE_DRAWS' order."""
    def sample_eps(k):
        kv1, kv2, ka1, ka2 = jax.random.split(k, 4)
        return {"v_in": jax.random.normal(kv1, (cfg.hidden_size,)),
                "v_out": jax.random.normal(kv2, (cfg.num_atoms,)),
                "a_in": jax.random.normal(ka1, (cfg.hidden_size,)),
                "a_out": jax.random.normal(ka2, (A * cfg.num_atoms,))}

    return lambda key: dict(zip(trainbow.NOISE_DRAWS,
                                map(sample_eps, jax.random.split(key, 3))))


def _rainbow_pair():
    jcfg, tcfg = jrainbow.RainbowConfig(), trainbow.RainbowConfig()
    p0 = jrainbow.init_rainbow_params(4, 2, jcfg.num_atoms, jcfg.hidden_size,
                                      seed=3)
    ref = _ref(jrainbow.Rainbow, jcfg, params=p0, num_actions=2,
               z=np.linspace(jcfg.v_min, jcfg.v_max,
                             jcfg.num_atoms).astype(np.float32))

    def batch(s):
        b = _transitions(s, weights=True)
        # Returns on the support's scale, so the projection splits mass
        # over many atoms, and some rows clipped at v_max.
        b["rewards"] = np.abs(b["rewards"]) * 60.0
        return b

    update = _with_noise(ref._update, _rainbow_draws(jcfg, 2))
    noise = {}

    def ref_step(st, b, i):
        (p, o, loss, ce), noise[i] = update(st["params"], st["target"],
                                            st["opt"], b, _key(i))
        return dict(st, params=p, opt=o), {"loss": loss, "ce": ce}

    def port(st):
        learner = trainbow.RainbowLearner(tcfg, 4, 2, device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        return learner

    def port_step(learner, b, i):
        loss, ce = learner.update(b, _torch_tree(noise[i]))
        return {"loss": loss, "ce": ce}

    def sync(st, learner):
        learner.sync_target()
        return dict(st, target=st["params"])

    return _Pair(state={"params": p0, "target": p0, "opt": ref._opt_state},
                 batch=batch, ref_step=ref_step, port=port,
                 port_step=port_step, sync=sync,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.target, st["target"])])


def _r2d2_pair():
    jcfg = jr2d2.R2D2Config(burn_in=3, train_length=5)
    tcfg = tr2d2.R2D2Config(burn_in=3, train_length=5)
    p0 = jr2d2.init_r2d2_params(4, 2, jcfg.hidden_size, seed=3)
    ref = _ref(jr2d2.R2D2, jcfg, params=p0)

    def ref_step(st, b, i):
        p, o, loss = ref._update(st["params"], st["target"], st["opt"], b)
        return dict(st, params=p, opt=o), {"loss": loss}

    def port(st):
        learner = tr2d2.R2D2Learner(tcfg, 4, 2, device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        return learner

    def port_step(learner, b, i):
        return {"loss": learner.update(b)[0]}

    def sync(st, learner):
        learner.sync_target()
        return dict(st, target=st["params"])

    return _Pair(state={"params": p0, "target": p0, "opt": ref._opt_state},
                 batch=lambda s: _sequences(s, jcfg), ref_step=ref_step,
                 port=port, port_step=port_step, sync=sync,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.target, st["target"])])


@functools.cache
def _td3_pair(algo):
    jcfg = jddpg.DDPGConfig() if algo == "ddpg" else jddpg.TD3Config()
    tcfg = tddpg.DDPGConfig() if algo == "ddpg" else tddpg.TD3Config()
    p0 = jddpg.init_td3_params(3, 1, jcfg.hidden_size, seed=3)
    ref = _ref(jddpg.TD3, jcfg, params=p0)

    # The normals jax.random.normal(key, next_a.shape) gives.
    update = _with_noise(ref._update,
                         lambda key: jax.random.normal(key, (B, 1)), 4)
    noise = {}

    def ref_step(st, b, i):
        do_policy = (i + 1) % jcfg.policy_delay == 0
        (p, t, o, m), noise[i] = update(st["params"], st["target"],
                                        st["opt"], b, _key(i), do_policy)
        return dict(st, params=p, target=t, opt=o), m

    def port(st):
        learner = tddpg.TD3Learner(tcfg, 3, 1, device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        return learner

    def port_step(learner, b, i):
        eps = _torch_tree(noise[i]) if tcfg.target_noise > 0 else None
        return learner.update(b, eps, (i + 1) % tcfg.policy_delay == 0)

    return _Pair(state={"params": p0, "target": p0, "opt": ref._opt_state},
                 batch=lambda s: _transitions(s, obs=3, act=1),
                 ref_step=ref_step, port=port, port_step=port_step,
                 sync=None,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.target, st["target"])])


@functools.cache
def _sac_pair():
    jcfg, tcfg = jsac.SACConfig(), tsac.SACConfig()
    p0 = jsac.init_sac_params(3, 1, jcfg.hidden_size, seed=3)
    ref = _ref(jsac.SAC, jcfg, params=p0, act_size=1,
               log_alpha=float(np.log(jcfg.initial_alpha)))

    # The reference's split of the key, and its normals, shaped as mu.
    update = _with_noise(ref._update, lambda key: [
        jax.random.normal(k, (B, 1)) for k in jax.random.split(key)])
    noise = {}

    def ref_step(st, b, i):
        (p, t, la, o, ao, m), noise[i] = update(
            st["params"], st["target"], st["log_alpha"], st["opt"],
            st["alpha_opt"], b, _key(i))
        return dict(st, params=p, target=t, log_alpha=la, opt=o,
                    alpha_opt=ao), m

    def port(st):
        learner = tsac.SACLearner(tcfg, 3, 1, device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        tree = {"log_alpha": learner.log_alpha}
        load_tree(tree, {"log_alpha": st["log_alpha"]})
        count, mu, nu = _adam(st["alpha_opt"])
        load_adam_state(learner.alpha_optimizer, tree, count,
                        {"log_alpha": mu}, {"log_alpha": nu})
        return learner

    def port_step(learner, b, i):
        return learner.update(b, *_torch_tree(noise[i]))

    def sync(st, learner):
        # An iteration boundary: the reference keeps log_alpha as a Python
        # float in between, the port as its tensor.
        return dict(st, log_alpha=jnp.asarray(float(st["log_alpha"]),
                                              jnp.float32))

    # The temperature's optax state as the update returns it (strong f32
    # leaves, where init gave weak ones), so the update compiles once.
    alpha_opt = jax.tree_util.tree_map(lambda x: jnp.asarray(x, x.dtype),
                                       ref._alpha_state)
    return _Pair(
        state={"params": p0,
               "target": {"q1": p0["q1"], "q2": p0["q2"]},
               "log_alpha": jnp.asarray(ref.log_alpha, jnp.float32),
               "opt": ref._opt_state, "alpha_opt": alpha_opt},
        batch=lambda s: _transitions(s, obs=3, act=1), ref_step=ref_step,
        port=port, port_step=port_step, sync=sync,
        held=lambda st, lr: [(lr.params, st["params"]),
                             (lr.target, st["target"]),
                             ({"log_alpha": lr.log_alpha},
                              {"log_alpha": st["log_alpha"]})])


def _maddpg_pair():
    jcfg, tcfg = jmaddpg.MADDPGConfig(), tmaddpg.MADDPGConfig()
    p0 = jmaddpg.init_maddpg_params(2, 4, 1, jcfg.hidden_size, seed=3)
    ref = _ref(jmaddpg.MADDPG, jcfg, params=p0, n_agents=2)

    def ref_step(st, b, i):
        p, t, oa, oc, closs, aloss = ref._update(
            st["params"], st["target"], st["oa"], st["oc"],
            {k: jnp.asarray(v) for k, v in b.items()})
        return dict(st, params=p, target=t, oa=oa, oc=oc), \
            {"critic_loss": closs, "actor_loss": aloss}

    def port(st):
        learner = tmaddpg.MADDPGLearner(tcfg, 2, 4, 1, device="cpu")
        load_tree(learner.params, _np(st["params"]))
        load_tree(learner.target, _np(st["target"]))
        load_adam_state(learner.optimizer, learner.critics, *_adam(st["oc"]))
        load_adam_state(learner.actor_optimizer, learner.actors,
                        *_adam(st["oa"]))
        return learner

    def port_step(learner, b, i):
        closs, aloss = learner.update(b)
        return {"critic_loss": closs, "actor_loss": aloss}

    return _Pair(state={"params": p0, "target": p0, "oa": ref._opt_a_state,
                        "oc": ref._opt_c_state},
                 batch=_joint, ref_step=ref_step, port=port,
                 port_step=port_step, sync=None,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.target, st["target"])])


def _slateq_pair():
    jcfg, tcfg = jslateq.SlateQConfig(), tslateq.SlateQConfig()
    env = jslateq.SlateDocEnv(0)
    p0 = jslateq.init_slateq_params(env.dim, jcfg.hidden_size, seed=3)
    ref = _ref(jslateq.SlateQ, jcfg, params=p0, env=env)

    def ref_step(st, b, i):
        p, o, loss = ref._update(st["params"], st["target"], st["opt"], b)
        return dict(st, params=p, opt=o), {"loss": loss}

    def port(st):
        learner = tslateq.SlateQLearner(tcfg, env.docs, env.slate_size,
                                        env.no_click_mass, device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        return learner

    def port_step(learner, b, i):
        return {"loss": learner.update(b)[0]}

    def sync(st, learner):
        learner.sync_target()
        return dict(st, target=st["params"])

    return _Pair(state={"params": p0, "target": p0, "opt": ref._opt_state},
                 batch=lambda s: _slates(s, env.docs), ref_step=ref_step,
                 port=port, port_step=port_step, sync=sync,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.target, st["target"])])


def _alphazero_pair():
    jcfg, tcfg = jaz.AlphaZeroConfig(), taz.AlphaZeroConfig()
    p0 = jaz.init_az_params(hidden=jcfg.hidden_size, seed=3)
    ref = _ref(jaz.AlphaZero, jcfg, params=p0)

    def ref_step(st, b, i):
        p, o, loss = ref._update(st["params"], st["opt"], b)
        return dict(st, params=p, opt=o), {"loss": loss}

    def port(st):
        learner = taz.AlphaZeroLearner(tcfg, device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]))
        return learner

    def port_step(learner, b, i):
        return {"loss": learner.update(b)[0]}

    return _Pair(state={"params": p0, "opt": ref._opt_state}, batch=_games,
                 ref_step=ref_step, port=port, port_step=port_step,
                 sync=None, held=lambda st, lr: [(lr.params, st["params"])])


def _cql_pair(tmp_path):
    path = _offline_file(tmp_path)
    jcfg = jcql.CQLConfig(input_path=path)
    tcfg = tcql.CQLConfig(input_path=path, target_update_every=4)
    p0 = jcql.init_q_params(4, 2, jcfg.hidden_size, seed=3)
    ref = _ref(jcql.CQL, jcfg, params=p0)

    def ref_step(st, b, i):
        p, o, m = ref._update(st["params"], st["target"], st["opt"], b)
        st = dict(st, params=p, opt=o)
        if (i + 1) % tcfg.target_update_every == 0:     # as CQL.train syncs
            st["target"] = p
        return st, m

    def port(st):
        learner = tcfg.build(device="cpu")
        load_reference_state(learner, _np(st["params"]), *_adam(st["opt"]),
                             target=_np(st["target"]))
        learner._updates = 2
        return learner

    return _Pair(state={"params": p0, "target": p0, "opt": ref._opt_state},
                 batch=_transitions, ref_step=ref_step, port=port,
                 port_step=lambda lr, b, i: lr.update(b), sync=None,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.target, st["target"])])


def _crr_pair(tmp_path):
    path = _offline_file(tmp_path)
    jcfg = jcrr.CRRConfig(input_path=path)
    tcfg = tcrr.CRRConfig(input_path=path)
    pi0 = jppo.init_policy_params(4, 2, jcfg.hidden_size, seed=3)
    q0 = jdqn.init_q_params(4, 2, jcfg.hidden_size, seed=4)
    ref = _ref(jcrr.CRR, jcfg, params=pi0, q_params=q0)

    def ref_step(st, b, i):
        p, q, po, qo, ql, pl = ref._update(
            st["params"], st["q_params"], st["q_target"], st["pi_opt"],
            st["q_opt"], b)
        return dict(st, params=p, q_params=q, pi_opt=po, q_opt=qo), \
            {"critic_loss": ql, "policy_loss": pl}

    def port(st):
        learner = tcfg.build(device="cpu")
        load_reference_state(learner, _np(st["params"]),
                             *_adam(st["pi_opt"]))
        load_tree(learner.q_params, _np(st["q_params"]))
        load_tree(learner.q_target, _np(st["q_target"]))
        load_adam_state(learner.q_optimizer, learner.q_params,
                        *_adam(st["q_opt"]))
        return learner

    def port_step(learner, b, i):
        ql, pl = learner.update(b)
        return {"critic_loss": ql, "policy_loss": pl}

    def sync(st, learner):
        tutils.tree_assign(learner.q_target, learner.q_params)
        return dict(st, q_target=st["q_params"])

    return _Pair(state={"params": pi0, "q_params": q0, "q_target": q0,
                        "pi_opt": ref._opt_state, "q_opt": ref._q_opt_state},
                 batch=_transitions, ref_step=ref_step, port=port,
                 port_step=port_step, sync=sync,
                 held=lambda st, lr: [(lr.params, st["params"]),
                                      (lr.q_params, st["q_params"]),
                                      (lr.q_target, st["q_target"])])


PAIRS = {"dqn": lambda tmp: _dqn_pair("dqn"),
         "simple_q": lambda tmp: _dqn_pair("simple_q"),
         "apex": lambda tmp: _dqn_pair("apex"),
         "rainbow": lambda tmp: _rainbow_pair(),
         "r2d2": lambda tmp: _r2d2_pair(),
         "td3": lambda tmp: _td3_pair("td3"),
         "ddpg": lambda tmp: _td3_pair("ddpg"),
         "sac": lambda tmp: _sac_pair(),
         "maddpg": lambda tmp: _maddpg_pair(),
         "slateq": lambda tmp: _slateq_pair(),
         "alphazero": lambda tmp: _alphazero_pair(),
         "cql": _cql_pair,
         "crr": _crr_pair}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_update_matches_reference_from_mid_training(name, tmp_path):
    """Two reference steps make a mid-training state (params, targets,
    optax Adam states, SAC's log_alpha); the port's learner takes it and
    both take three more steps on the same batches and noise: every loss
    (and Ape-X's and Rainbow's new priorities) within 2e-5, params,
    targets and log_alpha within 1e-4 after each step. Where the
    algorithm syncs a target (or SAC crosses an iteration), both sides do
    so after the fourth step; TD3's steps alternate critic-only and
    policy steps, CQL's target syncs on its fourth update."""
    pair = PAIRS[name](tmp_path)
    st = pair.state
    for i in range(2):
        st, _ = pair.ref_step(st, pair.batch(10 + i), i)
    learner = pair.port(st)
    for i in range(2, 5):
        b = pair.batch(10 + i)
        st, want = pair.ref_step(st, b, i)
        got = pair.port_step(learner, b, i)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(np.asarray(got[k]),
                                       np.asarray(want[k]), **FWD,
                                       err_msg=f"step {i}: {k}")
        for port_tree, ref_tree in pair.held(st, learner):
            _hold(port_tree, _np(ref_tree))
        if i == 3 and pair.sync is not None:
            st = pair.sync(st, learner)


def test_td3_critic_only_step_moves_the_actor_by_its_moments():
    """A critic-only TD3 step after a policy step: the actor moves (by
    Adam's decayed first moment, zero gradient), as the reference's does,
    and the targets stay."""
    pair = _td3_pair("td3")
    st = pair.state
    st, _ = pair.ref_step(st, pair.batch(1), 1)          # a policy step
    learner = pair.port(st)
    pi0 = _flat(learner.params["pi"])
    t0 = _flat(learner.target)
    b = pair.batch(2)
    st, _ = pair.ref_step(st, b, 2)                      # critic-only
    pair.port_step(learner, b, 2)
    assert all(not np.array_equal(_flat(learner.params["pi"])[k], v)
               for k, v in pi0.items())
    _hold(learner.params, _np(st["params"]))
    _equal(_flat(learner.target), t0)


def test_apex_new_priorities_are_the_reference_td_errors():
    """Ape-X's sgd step hands back |td| as the prioritized buffer's new
    priorities: the same indices and weights from the same seed, the same
    priorities within 2e-5 and max priority after an update."""
    pair = _dqn_pair("apex")
    learner = pair.port(pair.state)
    bufs = [jreplay.PrioritizedReplayBuffer(64, 4, seed=5),
            treplay.PrioritizedReplayBuffer(64, 4, seed=5)]
    rows = _transitions(20)
    rows.pop("weights", None)
    for buf in bufs:
        buf.add_batch(rows)
    samples = [buf.sample(B) for buf in bufs]
    _equal(samples[1], samples[0])
    batch = {k: v for k, v in samples[0].items() if k != "indices"}
    _st, want = pair.ref_step(pair.state, batch, 0)
    got = pair.port_step(learner, batch, 0)
    bufs[0].update_priorities(samples[0]["indices"],
                              np.abs(np.asarray(want["td_error"])))
    bufs[1].update_priorities(samples[1]["indices"],
                              np.abs(got["td_error"].numpy()))
    np.testing.assert_allclose(bufs[1].priorities, bufs[0].priorities, **FWD)
    np.testing.assert_allclose(bufs[1].max_priority, bufs[0].max_priority,
                               **FWD)


def test_sac_log_alpha_over_an_iteration_boundary():
    """SAC's temperature over 4 steps in two iterations: log_alpha (the
    reference's float between iterations, the port's tensor) within 1e-4
    after each, and the alpha metric the pre-step temperature."""
    pair = _sac_pair()
    st = pair.state
    learner = pair.port(st)
    for i in range(4):
        b = pair.batch(30 + i)
        st, want = pair.ref_step(st, b, i)
        got = pair.port_step(learner, b, i)
        np.testing.assert_allclose(got["alpha"].item(), float(want["alpha"]),
                                   **FWD)
        np.testing.assert_allclose(learner.log_alpha.item(),
                                   float(st["log_alpha"]), **GRAD)
        if i == 1:
            st = pair.sync(st, learner)
    assert learner.log_alpha.dtype == torch.float32
    assert float(st["log_alpha"]) != float(np.log(0.1))


def test_rainbow_projection_keeps_mass_and_lands_integral_points():
    """The categorical projection: every row's mass is kept (rows sum to
    1), and a point that is an atom (lo == hi, here r = 0 with done = 1)
    gives all its mass to that atom, as the reference's .at[].add does."""
    cfg = trainbow.RainbowConfig()
    z = torch.as_tensor(np.linspace(cfg.v_min, cfg.v_max, cfg.num_atoms)
                        .astype(np.float32))
    p = torch.softmax(torch.randn(3, cfg.num_atoms,
                                  generator=torch.Generator().manual_seed(0)),
                      -1)
    m = trainbow.categorical_projection(
        p, torch.tensor([0.0, 8.0, 1.3]), torch.tensor([1.0, 1.0, 0.0]), z,
        cfg.gamma ** cfg.n_step, cfg.v_min, cfg.v_max)
    np.testing.assert_allclose(m.sum(-1).numpy(), 1.0, **FWD)
    assert m[0, 0] == pytest.approx(1.0) and m[1, 2] == pytest.approx(1.0)


# ---------------- buffers, envs and MCTS, bitwise ----------------

def test_replay_buffers_sample_the_reference_rows():
    """ReplayBuffer, PrioritizedReplayBuffer (with priority updates),
    Rainbow's _NStepBuffer (n-step folding across resets and truncations)
    and R2D2's SequenceReplay: the same adds, the same seed, bitwise the
    same samples, ring wrap-around included."""
    rows = [_transitions(s) for s in range(3)]
    uni = [jdqn.ReplayBuffer(80, 4, seed=1), tdqn.ReplayBuffer(80, 4, seed=1)]
    per = [jreplay.PrioritizedReplayBuffer(80, 4, seed=2),
           treplay.PrioritizedReplayBuffer(80, 4, seed=2)]
    for r in rows:
        for buf in uni + per:
            buf.add_batch(r)
    for _ in range(3):
        _equal(uni[1].sample(B), uni[0].sample(B))
        want, got = per[0].sample(B), per[1].sample(B)
        _equal(got, want)
        td = np.random.default_rng(len(want)).standard_normal(B)
        for buf, s in zip(per, (want, got)):
            buf.update_priorities(s["indices"], td)
    rng = np.random.default_rng(9)
    frag = _transitions(40)
    frag["resets"] = (rng.random(B) < 0.2).astype(np.float32)
    frag["dones"] = frag["resets"] * (rng.random(B) < 0.5)
    nstep = [jrainbow._NStepBuffer(64, 4, seed=3),
             trainbow._NStepBuffer(64, 4, seed=3)]
    for buf in nstep:
        buf.add_nstep(frag, 3, 0.99)
        buf.add_nstep(frag, 3, 0.99)
    _equal(nstep[1].sample(B), nstep[0].sample(B))
    cfg = jr2d2.R2D2Config(burn_in=2, train_length=3)
    seqs = _sequences(41, cfg)
    seq_list = [{k: v[i] for k, v in seqs.items()} for i in range(B)]
    sr = [jr2d2.SequenceReplay(20, cfg.seq_len, 4, cfg.hidden_size, seed=4),
          tr2d2.SequenceReplay(20, cfg.seq_len, 4, cfg.hidden_size, seed=4)]
    for buf in sr:
        buf.add_sequences(seq_list)
    _equal(sr[1].sample(8), sr[0].sample(8))
    assert treplay.ReplayBuffer is tdqn.ReplayBuffer


def test_envs_and_mcts_match_reference():
    """CoopNav, SlateDocEnv and TicTacToe step as the reference's from the
    same seeds and actions; MCTS from the same params and seed gives the
    same visit-count policies and tree."""
    rng = np.random.default_rng(0)
    envs = [jmaddpg.CoopNav(), tmaddpg.CoopNav()]
    outs = [[e.reset(seed=3)] for e in envs]
    for _ in range(30):
        a = rng.uniform(-1.5, 1.5, 2).tolist()
        for e, o in zip(envs, outs):
            o.append(e.step(a))
    _equal(outs[1], outs[0])
    envs = [jslateq.SlateDocEnv(2), tslateq.SlateDocEnv(2)]
    _equal(envs[1].docs, envs[0].docs)
    outs = [[e.reset(seed=5)] for e in envs]
    params = jslateq.init_slateq_params(6, 16, seed=1)
    for _ in range(25):
        slate = jslateq.greedy_slate(params, envs[0].user, envs[0].docs, 3)
        _equal(tslateq.greedy_slate(params, envs[1].user, envs[1].docs, 3),
               slate)
        outs[0].append(jslateq.slate_value(params, envs[0].user,
                                           envs[0].docs, slate, 1.0))
        outs[1].append(tslateq.slate_value(params, envs[1].user,
                                           envs[1].docs, slate, 1.0))
        for e, o in zip(envs, outs):
            o.append(e.step(slate))
    _equal(outs[1], outs[0])
    for _ in range(200):
        board = rng.integers(-1, 2, 9).astype(np.float32)
        assert taz.TicTacToe.outcome(board) == jaz.TicTacToe.outcome(board)
        if (board == 0).any():
            a = int(np.flatnonzero(board == 0)[0])
            _equal(taz.TicTacToe.play(board, a), jaz.TicTacToe.play(board, a))
    params = jaz.init_az_params(hidden=16, seed=2)
    trees = [cls(params, 24, rng=np.random.default_rng(7))
             for cls in (jaz.MCTS, taz.MCTS)]
    board = taz.TicTacToe.initial()
    for temp in (1.0, 0.25, 0.0):
        pis = [t.policy(board, temperature=temp) for t in trees]
        _equal(pis[1], pis[0])
        board = taz.TicTacToe.play(board, int(np.argmax(pis[0])))
    for attr in ("P", "N", "W"):
        _equal(getattr(trees[1], attr), getattr(trees[0], attr))


WORKERS = {  # case -> (reference class, port class, constructor args, calls)
    "dqn": (jdqn.DQNRolloutWorker, tdqn.DQNRolloutWorker, ("CartPole-v1", 1),
            lambda: (jdqn.init_q_params(4, 2, 16, 0), 48, 0.3)),
    "rainbow": (jrainbow.RainbowRolloutWorker, trainbow.RainbowRolloutWorker,
                ("CartPole-v1", 1, np.linspace(0, 200, 11)),
                lambda: (jrainbow.init_rainbow_params(4, 2, 11, 16, 0), 48,
                         0.1)),
    "r2d2": (jr2d2.R2D2RolloutWorker, tr2d2.R2D2RolloutWorker,
             ("CartPole-v1", 1, 8, 6),
             lambda: (jr2d2.init_r2d2_params(4, 2, 8, 0), 4, 0.3)),
    "td3": (jddpg.TD3RolloutWorker, tddpg.TD3RolloutWorker,
            ("Pendulum-v1", 1, 0.1),
            lambda: (jddpg.init_td3_params(3, 1, 16, 0), 48)),
    "sac": (jsac.SACRolloutWorker, tsac.SACRolloutWorker, ("Pendulum-v1", 1),
            lambda: (jsac.init_sac_params(3, 1, 16, 0), 48)),
    "maddpg": (jmaddpg.MADDPGRolloutWorker, tmaddpg.MADDPGRolloutWorker,
               ("CoopNav", 1),
               lambda: (jmaddpg.init_maddpg_params(2, 4, 1, 16, 0), 48,
                        0.3)),
    "slateq": (jslateq.SlateQRolloutWorker, tslateq.SlateQRolloutWorker,
               (1, 0), lambda: (jslateq.init_slateq_params(6, 16, 0), 48,
                                0.3)),
}


def test_rollout_workers_match_reference(keep_threads):
    """Two fragments from each rollout actor's class in process, the same
    params: bitwise the reference's (its numpy forward, env and
    generator copied as they are). The self-play worker plays two games
    of 12-simulation MCTS."""
    for case, (jcls, tcls, args, call) in WORKERS.items():
        ref, ours = jcls._cls(*args), tcls._cls(*args)
        for _ in range(2):
            _equal(ours.sample(*call()), ref.sample(*call()))
    params = jaz.init_az_params(hidden=16, seed=0)
    ref, ours = jaz.SelfPlayWorker._cls(1, 12), taz.SelfPlayWorker._cls(1, 12)
    _equal(ours.play_games(params, 2), ref.play_games(params, 2))


# ---------------- the algorithms on the runtime ----------------

FRAG = dict(rollout_fragment_length=64, train_batch_size=32)
ONE = dict(num_rollout_workers=1)   # one rollout actor: all but Ape-X
RUNS = {  # algorithm -> (config, the result's loss key)
    "dqn": (lambda: trllib.DQNConfig(learning_starts=64, num_sgd_iter=2,
                                     **FRAG, **ONE), "loss"),
    "simple_q": (lambda: trllib.SimpleQConfig(
        learning_starts=64, num_sgd_iter=2, **FRAG, **ONE), "loss"),
    "apex": (lambda: trllib.ApexDQNConfig(
        num_rollout_workers=2, rollout_fragment_length=32, learning_starts=32,
        train_batch_size=32, batches_per_iter=3, sgd_steps_per_batch=2),
        "mean_loss"),
    "rainbow": (lambda: trllib.RainbowConfig(num_sgd_iter=2, **FRAG, **ONE),
                "loss"),
    "r2d2": (lambda: trllib.R2D2Config(
        sequences_per_rollout=4, train_batch_size=4, num_sgd_iter=2,
        burn_in=2, train_length=4, **ONE), "loss"),
    "td3": (lambda: trllib.TD3Config(
        learning_starts=64, num_updates_per_iter=2, **FRAG, **ONE),
        "critic_loss"),
    "ddpg": (lambda: trllib.DDPGConfig(
        learning_starts=64, num_updates_per_iter=2, **FRAG, **ONE),
        "actor_loss"),
    "sac": (lambda: trllib.SACConfig(
        learning_starts=64, num_updates_per_iter=2, **FRAG, **ONE),
        "critic_loss"),
    "maddpg": (lambda: trllib.MADDPGConfig(num_sgd_iter=2, **FRAG, **ONE),
               "critic_loss"),
    "slateq": (lambda: trllib.SlateQConfig(
        rollout_fragment_length=64, train_batch_size=16, num_sgd_iter=2,
        **ONE), "loss"),
    "alphazero": (lambda: trllib.AlphaZeroConfig(
        games_per_iteration=2, num_simulations=8, train_batch_size=8,
        num_sgd_iter=2, **ONE), "loss"),
}


def test_algorithms_train_on_the_runtime(rt):
    """One train() of each actor-based algorithm on the port's runtime,
    learners on the CPU: its learner took updates and reported a finite
    loss; its rollout actors hold one thread, no CUDA context and no
    banned package. DQN's first fragment is bitwise what the
    reference's worker gives for the same params and epsilon."""
    for name, (make, key) in RUNS.items():
        algo = make().build(device="cpu")
        try:
            params0 = algo.learner.get_params()
            result = algo.train()
            state = rt.get(algo.workers[0].process_state.remote())
        finally:
            algo.stop()
        assert result["training_iteration"] == 1, name
        assert algo.learner.updates > 0, (name, result)
        assert np.isfinite(result[key]), (name, result)
        assert not state["cuda_initialized"], name
        assert state["threads"] == 1, name
        assert not set(state["packages"]) & set(BANNED), \
            (name, state["packages"])
        if name == "dqn":
            want = jdqn.DQNRolloutWorker._cls("CartPole-v1", 0).sample(
                params0, 64, 1.0)
            for k in ("obs", "actions", "rewards", "next_obs", "dones"):
                np.testing.assert_array_equal(getattr(algo.buffer, k)[:64],
                                              want[k], err_msg=k)


def test_offline_algorithms_train(tmp_path):
    """CQL and CRR take one train() each on the port's JsonReader data, on
    the CPU: finite losses, the reference's result keys."""
    path = _offline_file(tmp_path, n=300)
    cql = tcql.CQLConfig(input_path=path, num_updates_per_iter=4,
                         train_batch_size=32).build(device="cpu")
    r = cql.train()
    assert sorted(r) == sorted(["training_iteration", "learn_time_s", "loss",
                                "bellman", "cql_penalty"])
    assert np.isfinite(r["loss"])
    crr = tcrr.CRRConfig(input_path=path, num_sgd_iter_per_train=3,
                         train_batch_size=32).build(device="cpu")
    r = crr.train()
    assert np.isfinite(r["critic_loss"]) and np.isfinite(r["policy_loss"])
    assert r["num_samples_trained"] == 96


def test_tree_helpers():
    """utils' trees: tree_copy snapshots tensors (a target), tree_numpy
    hands out host copies that no later update changes, polyak and
    tree_assign act leaf by leaf in place, lists included."""
    tree = {"a": torch.ones(2), "l": [{"w": torch.zeros(3)}]}
    snap = tutils.tree_copy(tree)
    host = tutils.tree_numpy(tree)
    tree["a"].add_(1.0)
    assert snap["a"].tolist() == [1.0, 1.0] and host["a"].tolist() == [1, 1]
    tutils.polyak(snap, tree, 0.25)
    assert snap["a"].tolist() == [1.25, 1.25]
    tutils.tree_assign(snap, tree)
    _equal(_flat(snap), _flat(tree))
    assert isinstance(host["l"], list) and host["l"][0]["w"].shape == (3,)
