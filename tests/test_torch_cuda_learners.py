"""Checkpoints and the RL learners on the card. Every test here needs a
CUDA device and skips without one. The file imports neither jax nor
ray_tpu, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_learners.py

A CUDA TrainState (TINY, bf16) saved through torch.distributed.checkpoint
after 2 steps and restored into a state drawn from another seed takes
its next step bitwise as the uninterrupted state does. PPOLearner and
MARWIL on the card against the same learners on the CPU from the same
numpy params, TF32 off: losses within 2e-5, parameters after the updates
within 1e-4 but at first-step ties (a first gradient that differs and is
under Adam's eps on either side), held to 2 lr a step. On the port's
runtime (ray_tpu_torch.init, 4 CPUs and the node's cards): a LearnerGroup
of two learners on the card (over gloo on one card, each a half share;
NCCL where there is a card each) against the same group on the CPU from
the same seed, two update_shards steps: losses within 2e-5, params
within 1e-4, the card's learners' fingerprints equal. IMPALA's learner on
the card against the CPU, three steps on seeded fragments.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ray_tpu_torch.models import TINY, cross_entropy_loss  # noqa: E402
from ray_tpu_torch.rllib import (MARWILConfig, PPOConfig,  # noqa: E402
                                 PPOLearner, get_model, write_offline_json)
from ray_tpu_torch.rllib.impala import ImpalaConfig, make_impala_loss  # noqa: E402
from ray_tpu_torch.rllib.learner_group import LearnerGroup  # noqa: E402
from ray_tpu_torch.rllib.ppo import TorchLearner, init_policy_params  # noqa: E402
from ray_tpu_torch.train import (adamw, init_train_state,  # noqa: E402
                                 make_train_step)
from ray_tpu_torch.train.checkpoint import restore_pytree, save_pytree  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_cuda_train_state_round_trip_is_bitwise(cuda, tmp_path):
    cfg = dataclasses.replace(TINY, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 65))).to(cuda)
    batch = (data[:, :-1], data[:, 1:])
    step = make_train_step(lambda m, b: cross_entropy_loss(m(b[0]), b[1]))
    a = init_train_state(cfg, adamw(1e-3, weight_decay=0.01), seed=0)
    for _ in range(2):
        a, _ = step(a, batch)
    save_pytree(a, str(tmp_path / "s"))
    b = init_train_state(cfg, adamw(1e-3, weight_decay=0.01), seed=1)
    restore_pytree(str(tmp_path / "s"), b)
    assert b.step == 2
    a, ma = step(a, batch)
    b, mb = step(b, batch)
    assert ma["loss"].item() == mb["loss"].item()
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert p.device.type == "cuda" and torch.equal(p, q), n
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        assert all(torch.equal(sa[k], sb[k]) for k in sa), n


def _batch(obs_shape, n_act, n, seed):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 256, (n, *obs_shape), dtype=np.uint8) \
        if len(obs_shape) == 3 else \
        rng.standard_normal((n, *obs_shape)).astype(np.float32)
    return {"obs": obs, "actions": rng.integers(0, n_act, n).astype(np.int32),
            "logp": np.full(n, np.log(1.0 / n_act), np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "returns": rng.standard_normal(n).astype(np.float32)}


def _leaves(params):
    return {f"{k}/{kk}": t for k, sub in params.items()
            for kk, t in sub.items()}


@pytest.mark.parametrize("model,obs_shape,n_act", [
    ("mlp", (4,), 2), ("atari_cnn", (42, 42, 1), 3)])
def test_ppo_learner_on_the_card_matches_the_cpu(cuda, model, obs_shape,
                                                 n_act):
    cfg = PPOConfig(model=model, lr=1e-3)
    spec = get_model(model)
    obs_in = obs_shape if model == "atari_cnn" else obs_shape[0]
    params = spec.init_params(obs_in, n_act, spec.default_hidden, 0)
    learners = [PPOLearner(cfg, obs_in, n_act, params=params, device=d)
                for d in ("cuda", "cpu")]
    firsts = []
    for i in range(3):
        mb = _batch(obs_shape, n_act, 64, seed=i)
        losses = [learner.update(mb)[0].item() for learner in learners]
        np.testing.assert_allclose(*losses, rtol=2e-5, atol=2e-5)
        if i == 0:
            firsts = [{k: t.grad.cpu().numpy() for k, t in
                       _leaves(learner.params).items()}
                      for learner in learners]
    got, want = (_leaves(learner.params) for learner in learners)
    for k, w in want.items():
        g, w = got[k].detach().cpu().numpy(), w.detach().numpy()
        a, b = firsts[0][k], firsts[1][k]
        tie = (a != b) & ((np.abs(a) < 1e-8) | (np.abs(b) < 1e-8))
        assert tie.sum() <= max(1, tie.size // 100), k
        np.testing.assert_allclose(g[~tie], w[~tie], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        np.testing.assert_allclose(g[tie], w[tie], rtol=0,
                                   atol=2 * cfg.lr * 3 + 1e-4, err_msg=k)


def test_marwil_on_the_card_matches_the_cpu(cuda, tmp_path):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "data.jsonl")
    write_offline_json(path, [{
        "obs": rng.standard_normal((200, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, 200),
        "rewards": np.ones(200, np.float32),
        "dones": (np.arange(200) % 50 == 49).astype(np.float32)}])
    results = [MARWILConfig(beta=1.0, num_sgd_iter_per_train=3,
                            train_batch_size=64)
               .offline_data(input_path=path).build(device=d).train()
               for d in ("cuda", "cpu")]
    for k in ("loss", "pi_loss", "vf_loss", "mean_weight"):
        np.testing.assert_allclose(results[0][k], results[1][k], rtol=2e-5,
                                   atol=2e-5, err_msg=k)


@pytest.fixture(scope="module")
def rt():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import ray_tpu_torch

    ray_tpu_torch.init(num_cpus=4)
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: np.asarray(v)})
    return out


def test_learner_group_on_the_card_matches_the_cpu(rt):
    shards = [[_batch((4,), 2, 32, seed=2 * i + j) for j in range(2)]
              for i in range(2)]
    groups = [LearnerGroup(num_learners=2, model="mlp", obs_size=4,
                           num_actions=2, hidden=64, lr=1e-3,
                           entropy_coeff=0.01, device=d)
              for d in (None, "cpu")]
    try:
        card, cpu = groups
        want = ("nccl", 1) if torch.cuda.device_count() >= 2 \
            else ("gloo", 0.5)
        assert (card.backend, card.num_gpus) == want
        for step in shards:
            got, ref = (g.update_shards(step) for g in groups)
            for k in ref:
                np.testing.assert_allclose(got[k], ref[k], rtol=2e-5,
                                           atol=2e-5, err_msg=k)
            fps = card.fingerprints()
            assert fps[0] == fps[1]
        got, ref = _flat(card.get_params()), _flat(cpu.get_params())
        for k, w in ref.items():
            np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
        assert all(s["updates"] == 2 and s["allreduce_bytes"] > 0
                   for s in card.comm_stats())
    finally:
        for g in groups:
            g.shutdown()


def test_impala_update_on_the_card_matches_the_cpu(cuda):
    cfg = ImpalaConfig()
    loss = make_impala_loss(gamma=cfg.gamma, vf_coeff=cfg.vf_coeff,
                            entropy_coeff=cfg.entropy_coeff,
                            clip_rho=cfg.vtrace_clip_rho,
                            clip_c=cfg.vtrace_clip_c)
    params = init_policy_params(4, 2, cfg.hidden_size, 0)
    learners = [TorchLearner(params, loss, cfg.lr, d) for d in (cuda, "cpu")]
    for i in range(3):
        rng = np.random.default_rng(i)
        n = cfg.rollout_fragment_length
        frag = {"obs": rng.standard_normal((n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, n).astype(np.int32),
                "behavior_logp": np.full(n, np.log(0.5), np.float32),
                "rewards": rng.standard_normal(n).astype(np.float32),
                "dones": (rng.random(n) < 0.05).astype(np.float32),
                "bootstrap_obs": rng.standard_normal(4).astype(np.float32)}
        outs = [learner.update(frag) for learner in learners]
        np.testing.assert_allclose(outs[0][0].item(), outs[1][0].item(),
                                   rtol=2e-5, atol=2e-5)
        for k, v in outs[1][1].items():
            np.testing.assert_allclose(outs[0][1][k].item(), v.item(),
                                       rtol=2e-5, atol=2e-5, err_msg=k)
    got, want = (_flat(learner.get_params()) for learner in learners)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-4, atol=1e-4,
                                   err_msg=k)
