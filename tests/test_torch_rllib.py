"""The port's RLlib learners (ray_tpu_torch/rllib) against the JAX
package's, on the CPU.

Both sides start from the same numpy params (the catalog's inits are
copies, so a seed gives both the same bits). Tolerances: f32 forward
and losses 2e-5, grads and parameters after Adam steps 1e-4 (the JAX
package's flash tests' bounds). Adam's first step moves an element by
lr g / (|g| + eps): where the two sides' first gradient differs and is
under eps on either side (a gradient 0 within rounding) the element may
move by up to lr either way, so such first-step ties are counted,
reported and held to 2 lr a step instead; they must stay under 1% of
a parameter's elements (a conv's or dense layer's gradients have a few
such elements, well under eps, each side's within rounding of the
other's)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.rllib import catalog as jcat  # noqa: E402
from ray_tpu.rllib import offline as joff  # noqa: E402
from ray_tpu.rllib import ppo as jppo  # noqa: E402
from ray_tpu_torch.rllib import catalog as tcat  # noqa: E402
from ray_tpu_torch.rllib import offline as toff  # noqa: E402
from ray_tpu_torch.rllib import ppo as tppo  # noqa: E402

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)
ADAM_EPS = 1e-8
# name -> (obs shape of one row, actions, hidden)
MODELS = {"mlp": ((4,), 2, 64), "resmlp": ((4,), 2, 128),
          "atari_cnn_42": ((42, 42, 1), 3, 256),
          "atari_cnn_84": ((84, 84, 4), 6, 256)}


def _spec_and_init(case: str, seed: int = 0):
    name = case.rsplit("_", 1)[0] if case.startswith("atari") else case
    shape, n_act, hidden = MODELS[case]
    obs_in = shape if name == "atari_cnn" else shape[0]
    params = tcat.get_model(name).init_params(obs_in, n_act, hidden, seed)
    return name, shape, n_act, params


def _obs(shape, n: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    if len(shape) == 3:   # uint8 frames, normalized by the forward
        return rng.integers(0, 256, (n, *shape), dtype=np.uint8)
    return rng.standard_normal((n, *shape)).astype(np.float32)


def _ppo_batch(shape, n_act: int, n: int, seed: int = 2) -> dict:
    rng = np.random.default_rng(seed)
    return {"obs": _obs(shape, n, seed + 1),
            "actions": rng.integers(0, n_act, n).astype(np.int32),
            "logp": (np.log(1.0 / n_act)
                     + 0.3 * rng.standard_normal(n)).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "returns": rng.standard_normal(n).astype(np.float32)}


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v.detach() if torch.is_tensor(v)
                                         else v)
    return out


def test_model_catalog_contract():
    spec = tcat.get_model("mlp")
    params = spec.init_params(4, 2, 32, 0)
    logits, value = spec.numpy_forward(params, np.zeros((3, 4), np.float32))
    assert logits.shape == (3, 2) and value.shape == (3,)
    spec2 = tcat.get_model("resmlp")
    p2 = spec2.init_params(4, 2, 32, 0)
    l2, v2 = spec2.numpy_forward(p2, np.zeros((5, 4), np.float32))
    assert l2.shape == (5, 2) and v2.shape == (5,)
    with pytest.raises(ValueError, match="unknown model"):
        tcat.get_model("nope")
    assert sorted(tcat.MODEL_REGISTRY) == sorted(jcat.MODEL_REGISTRY)
    for name in tcat.MODEL_REGISTRY:
        assert tcat.get_model(name).default_hidden == \
            jcat.get_model(name).default_hidden


@pytest.mark.parametrize("case", sorted(MODELS))
def test_init_and_torch_forward_match_jax(case):
    """The inits are bitwise the reference's; torch_forward is held to
    jax_forward (and the numpy forward) on the same params and obs."""
    name, shape, n_act, params = _spec_and_init(case)
    jspec = jcat.get_model(name)
    obs_in = shape if name == "atari_cnn" else shape[0]
    want_params = jspec.init_params(obs_in, n_act, MODELS[case][2], 0)
    for k, v in _flat(want_params).items():
        np.testing.assert_array_equal(_flat(params)[k], v, err_msg=k)
    obs = _obs(shape, 4)
    jl, jv = jspec.jax_forward(params, jnp.asarray(obs))
    tl, tv = tcat.get_model(name).torch_forward(
        tppo.tensor_params(params, "cpu"), torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FWD)
    nl, nv = tcat.get_model(name).numpy_forward(params, obs)
    np.testing.assert_allclose(tl.numpy(), nl, **FWD)
    np.testing.assert_allclose(tv.numpy(), nv, **FWD)
    if name == "atari_cnn":   # the batch-global /255 switch: floats pass
        f = (obs / 255.0).astype(np.float32)
        jl, _ = jspec.jax_forward(params, jnp.asarray(f))
        tl, _ = tcat.get_model(name).torch_forward(
            tppo.tensor_params(params, "cpu"), torch.from_numpy(f))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FWD)


@pytest.fixture(scope="module", params=["mlp", "atari_cnn_42"])
def ppo_case(request):
    """The reference's side of a PPO case, computed once: the loss, aux
    and grads of make_ppo_loss on the first minibatch, then 3 updates of
    its jitted update (PPO._build_update's, driven directly) on 3
    minibatches."""
    case = request.param
    name, shape, n_act, params = _spec_and_init(case)
    jcfg = jppo.PPOConfig(model=name, lr=1e-3)
    mbs = [_ppo_batch(shape, n_act, 32, seed=10 + i) for i in range(3)]
    jloss = jppo.make_ppo_loss(jcat.get_model(name).jax_forward,
                               jcfg.clip_param, jcfg.vf_coeff,
                               jcfg.entropy_coeff)
    (loss, aux), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, mbs[0])
    algo = _jax_ppo(jcfg, params)
    p, opt, updates = algo.params, algo._opt_state, []
    for mb in mbs:
        p, opt, jl, jaux = algo._update(p, opt, mb)
        updates.append((float(jl), {k: float(v) for k, v in jaux.items()}))
    return dict(case=case, name=name, shape=shape, n_act=n_act, algo=algo,
                params=params, mbs=mbs, loss=float(loss),
                aux={k: float(v) for k, v in aux.items()},
                grads=_flat(grads), updates=updates, final=p)


def test_ppo_loss_and_grads_match_jax(ppo_case):
    c = ppo_case
    cfg = tppo.PPOConfig()
    tparams = tppo.tensor_params(c["params"], "cpu", trainable=True)
    tloss = tppo.make_ppo_loss(tcat.get_model(c["name"]).torch_forward,
                               cfg.clip_param, cfg.vf_coeff,
                               cfg.entropy_coeff)
    tl, taux = tloss(tparams, {k: torch.from_numpy(v)
                               for k, v in c["mbs"][0].items()})
    tl.backward()
    np.testing.assert_allclose(tl.item(), c["loss"], **FWD)
    for k in ("pi_loss", "vf_loss", "entropy"):
        np.testing.assert_allclose(taux[k].item(), c["aux"][k], **FWD)
    tgrads = {k: v.grad for k, v in _leaf_items(tparams)}
    for k, v in c["grads"].items():
        np.testing.assert_allclose(tgrads[k].numpy(), v, **GRAD, err_msg=k)


def test_population_std():
    """The advantages are normalized by jnp.std's population std: with
    torch's default (n - 1) the loss would differ at this batch size."""
    adv = torch.tensor([1.0, 2.0, 4.0])
    assert adv.std(correction=0).item() == pytest.approx(
        float(jnp.std(jnp.asarray([1.0, 2.0, 4.0]))), rel=1e-7)


def _leaf_items(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _jax_ppo(cfg, params):
    """The reference's PPO with its jitted update built, no rollout
    workers: driven directly through _update."""
    algo = jppo.PPO.__new__(jppo.PPO)
    algo.config = cfg
    algo._spec = jcat.get_model(cfg.model)
    algo.params = params
    algo.policy_params = None
    algo._build_update()
    return algo


def _hold_params(got: dict, want: dict, first_grads, lr: float,
                 steps: int) -> int:
    """Parameters within GRAD but for first-step ties (see the module
    docstring); returns the number of ties."""
    ties = 0
    for k, w in _flat(want).items():
        g = got[k]
        jg, tg = first_grads[0][k], first_grads[1][k]
        tie = (jg != tg) & ((np.abs(jg) < ADAM_EPS) | (np.abs(tg) < ADAM_EPS))
        ties += int(tie.sum())
        assert tie.sum() <= max(1, tie.size // 100), k
        np.testing.assert_allclose(g[~tie], w[~tie], **GRAD, err_msg=k)
        np.testing.assert_allclose(g[tie], w[tie], rtol=0,
                                   atol=2 * lr * steps + GRAD["atol"])
    return ties


def test_ppo_learner_updates_match_jax(ppo_case):
    """3 PPOLearner.update calls against the reference's jitted update on
    the same minibatches: losses, aux and every parameter."""
    c = ppo_case
    cfg = tppo.PPOConfig(model=c["name"], lr=1e-3)
    obs_in = c["shape"] if c["name"] == "atari_cnn" else c["shape"][0]
    learner = tppo.PPOLearner(cfg, obs_in, c["n_act"], params=c["params"],
                              device="cpu")
    for i, (mb, (jl, jaux)) in enumerate(zip(c["mbs"], c["updates"])):
        tl, taux = learner.update(mb)
        if i == 0:
            first = (c["grads"], {k: v.grad.numpy() for k, v in
                                  _leaf_items(learner.params)})
        np.testing.assert_allclose(tl.item(), jl, **FWD)
        for k in jaux:
            np.testing.assert_allclose(taux[k].item(), jaux[k], **FWD)
    ties = _hold_params(_flat(learner.params), c["final"], first, cfg.lr, 3)
    print(f"{c['case']}: {ties} first-step ties")
    assert learner.updates == 3


def test_ppo_learner_learn_matches_jax_sgd_loop(ppo_case):
    """learn(): the SGD half of PPO.train, its epochs' permutations from
    default_rng(seed + iteration), against the reference's loop over its
    jitted update (the fixture's, whose minibatches are 32 rows)."""
    c = ppo_case
    cfg = tppo.PPOConfig(model=c["name"], num_sgd_iter=2,
                         sgd_minibatch_size=32, lr=1e-3, seed=3)
    batch = _ppo_batch(c["shape"], c["n_act"], 96)
    algo = c["algo"]
    jp, jopt = c["params"], algo._opt.init(c["params"])
    rng = np.random.default_rng(cfg.seed + 1)
    n = len(batch["obs"])
    for _ in range(cfg.num_sgd_iter):
        perm = rng.permutation(n)
        for s in range(0, n, cfg.sgd_minibatch_size):
            idx = perm[s: s + cfg.sgd_minibatch_size]
            jp, jopt, _jl, jaux = algo._update(
                jp, jopt, {k: v[idx] for k, v in batch.items()})
    obs_in = c["shape"] if c["name"] == "atari_cnn" else c["shape"][0]
    learner = tppo.PPOLearner(cfg, obs_in, c["n_act"], params=c["params"],
                              device="cpu")
    aux = learner.learn(batch, iteration=1)
    assert learner.updates == 6
    for k in jaux:
        np.testing.assert_allclose(aux[k], float(jaux[k]), **GRAD)
    for k, w in _flat(jp).items():
        np.testing.assert_allclose(_flat(learner.params)[k], w, **GRAD,
                                   err_msg=k)


def test_gae_is_the_reference():
    rng = np.random.default_rng(0)
    rews = rng.standard_normal(20).astype(np.float32)
    vals = rng.standard_normal(21).astype(np.float32)
    dones = rng.random(20) < 0.2
    for a, b in zip(tppo._gae(rews, vals, dones, 0.99, 0.95),
                    jppo._gae(rews, vals, dones, 0.99, 0.95)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def expert_json(tmp_path_factory):
    """Expert CartPole data from the 'lean-toward-the-pole' heuristic,
    written by the JAX package (tests/test_rllib_algorithms.py's fixture,
    8 episodes)."""
    from ray_tpu.rllib.env import CartPole

    env = CartPole()
    batches = []
    for ep in range(8):
        obs = env.reset(seed=ep)
        obs_l, act_l, rew_l, done_l = [], [], [], []
        done = False
        while not done:
            action = 1 if obs[2] + 0.5 * obs[3] > 0 else 0
            nxt, r, done, _ = env.step(action)
            obs_l.append(obs.tolist())
            act_l.append(action)
            rew_l.append(r)
            done_l.append(float(done))
            obs = nxt
        batches.append({"obs": obs_l, "actions": act_l, "rewards": rew_l,
                        "dones": done_l})
    path = tmp_path_factory.mktemp("offline") / "expert.jsonl"
    joff.write_offline_json(str(path), batches)
    ours = path.with_name("ours.jsonl")
    toff.write_offline_json(str(ours), batches)
    assert ours.read_bytes() == path.read_bytes()
    return str(path)


@pytest.mark.parametrize("beta", [0.0, 1.0])
def test_bc_and_marwil_match_jax(expert_json, beta):
    """Two train() iterations of BC (beta 0) and MARWIL (beta 1) on one
    JSONL file: the data read, each iteration's loss and aux, and the
    params after them."""
    kw = dict(beta=beta, num_sgd_iter_per_train=4, train_batch_size=128)
    jalgo = joff.MARWILConfig().offline_data(input_path=expert_json) \
        .training(**kw).build()
    talgo = toff.MARWILConfig().offline_data(input_path=expert_json) \
        .training(**kw).build(device="cpu")
    for k, v in jalgo.data.items():
        np.testing.assert_array_equal(talgo.data[k], v)
    for _ in range(2):
        jr, tr = jalgo.train(), talgo.train()
        assert tr["training_iteration"] == jr["training_iteration"]
        assert tr["num_samples"] == jr["num_samples"]
        for k in ("loss", "pi_loss", "vf_loss", "mean_weight"):
            np.testing.assert_allclose(tr[k], jr[k], **FWD, err_msg=k)
    want = jalgo.get_policy_params()
    got = talgo.get_policy_params()
    for k, w in _flat(want).items():
        np.testing.assert_allclose(_flat(got)[k], w, **GRAD, err_msg=k)
    np.testing.assert_array_equal(
        talgo.compute_single_action(talgo.data["obs"][0]),
        np.argmax(tcat.get_model("mlp").numpy_forward(
            got, talgo.data["obs"][:1])[0][0]))


def test_bc_clones_expert_from_rows(expert_json):
    """BC trained from a list of row dicts (the dataset input) balances
    the pole, the reference test's bar (tests/test_rllib_algorithms.py:
    evaluate(3) above 100)."""
    data = toff.JsonReader(expert_json).read_all()
    rows = [{"obs": o, "actions": a, "rewards": r, "dones": d}
            for o, a, r, d in zip(data["obs"], data["actions"],
                                  data["rewards"], data["dones"])]
    algo = toff.BCConfig().offline_data(input_dataset=rows).training(
        num_sgd_iter_per_train=40, lr=3e-3).build(device="cpu")
    for _ in range(5):
        result = algo.train()
    assert result["training_iteration"] == 5
    assert algo.evaluate(num_episodes=3)["episode_reward_mean"] > 100


def test_configs_match_jax():
    for t, j in ((tppo.PPOConfig(), jppo.PPOConfig()),
                 (toff.MARWILConfig(), joff.MARWILConfig()),
                 (toff.BCConfig(), joff.BCConfig())):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError, match="unknown PPO option"):
        tppo.PPOConfig().training(nope=1)
