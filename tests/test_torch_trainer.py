"""The port's training gang (ray_tpu_torch.train: TorchTrainer, the
session, the worker group) against the JAX package's training step.

One port cluster for the file (4 CPUs, no card). A 2-worker gloo gang
(`use_gpu=False`) trains tests/test_torch_train.py's tiny Llama in f32
for 3 steps: each rank takes half of each batch from a `split(2)`
Dataset whose map_batches stage forms inputs and targets, and averages
its gradients with `session.allreduce_gradients`. The weights reach the
workers through the device plane (`initial_weights`, broadcast_weights).
The first attempt fails after step 1's checkpoint, and the retry
resumes from it. The final parameters are held against JAX's
make_train_step on the full batches from the same flax weights, at
test_torch_train.py's tolerance for final parameters (1e-5).
The elastic gang has its own file, tests/test_torch_elastic.py.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import ray_tpu_torch  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.train import spmd as jspmd  # noqa: E402
from ray_tpu.train import worker_group as jwg  # noqa: E402
from ray_tpu_torch._private.config import Config as PortConfig  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402

SHAPE = dict(vocab_size=128, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
             d_ff=128, max_seq_len=128)
B, S, STEPS, WORKERS = 4, 16, 3, 2
FINAL_TOL = dict(rtol=1e-5, atol=1e-5)


def _fast(cfg):
    cfg.health_check_period_s = 0.2
    cfg.worker_lease_timeout_s = 10.0
    cfg.object_store_memory = 64 * 1024 * 1024
    cfg.idle_worker_keep_s = 0.2
    return cfg


@pytest.fixture(scope="module")
def port_rt():
    old = os.environ.pop("CUDA_VISIBLE_DEVICES", None)
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        ray_tpu_torch.init(num_cpus=4, config=_fast(PortConfig()))
    finally:
        if old is None:
            del os.environ["CUDA_VISIBLE_DEVICES"]
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = old
    yield ray_tpu_torch
    ray_tpu_torch.shutdown()


def _flax_weights(model, seed: int = 0):
    """Flax weights from a numpy seed: the tree's structure from tracing
    flax's init (no compile), each kernel a unit normal over
    sqrt(fan_in), each norm scale 1 + 0.1 n, every other leaf 0.1 n."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        a = rng.standard_normal(leaf.shape)
        if path[-1].key == "kernel":
            a /= np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            a = (path[-1].key == "scale") + 0.1 * a
        return a.astype(leaf.dtype)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def jax_side():
    """Flax weights, the token batches, and JAX's final parameters after
    STEPS full-batch AdamW steps."""
    # JAX's plain attention: its flash kernel in Pallas interpret mode
    # costs seconds of compile here, and tests/test_torch_train.py holds
    # the two flash paths against each other.
    jcfg = jl.LlamaConfig(**SHAPE, dtype=jnp.float32,
                          attention="reference", remat=False)
    model = jl.LlamaModel(jcfg)
    params = _flax_weights(model)
    tokens = np.random.default_rng(0).integers(
        0, SHAPE["vocab_size"], (STEPS, B, S + 1))

    def loss_fn(p, batch):
        inp, tgt = batch
        return jl.cross_entropy_loss(model.apply(p, inp), tgt)

    opt = optax.adamw(3e-4, weight_decay=0.01)
    step = jax.jit(jspmd.make_train_step(loss_fn, opt))
    state = jspmd.TrainState(params, opt.init(params),
                             jnp.zeros((), jnp.int32))
    losses = []
    for i in range(STEPS):
        batch = (jnp.asarray(tokens[i, :, :-1], jnp.int32),
                 jnp.asarray(tokens[i, :, 1:], jnp.int32))
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return params, tokens, jax.device_get(state.params), losses


@pytest.fixture(scope="module")
def gang(port_rt, jax_side, tmp_path_factory):
    """One fit of the 2-worker gloo gang; the first attempt fails after
    step 1's checkpoint."""
    from ray_tpu_torch import data as rd
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchTrainer)

    params, tokens, _, _ = jax_side
    tcfg = tl.LlamaConfig(**SHAPE, dtype=torch.float32, attention="flash",
                          remat=False)
    weights = convert.params_from_flax(params, tcfg)
    half = B // WORKERS
    # Rank r's i-th batch is the r-th half of full batch i: split(2) cuts
    # the rows in two contiguous halves.
    rows = [{"tokens": tokens[i, r * half + j]} for r in range(WORKERS)
            for i in range(STEPS) for j in range(half)]

    def shift(batch):
        tok = batch["tokens"]
        return {"inp": tok[:, :-1], "tgt": tok[:, 1:]}

    shards = rd.from_items(rows, override_num_blocks=4).map_batches(
        shift).split(WORKERS)
    root = str(tmp_path_factory.mktemp("gang"))

    def loop(config):
        import os

        from ray_tpu_torch.data import dataset as ds_mod
        from ray_tpu_torch.models import llama
        from ray_tpu_torch.train import Checkpoint, session, spmd

        from torch.distributed.device_mesh import init_device_mesh

        rank = session.get_world_rank()
        # A batch placed on a DeviceMesh over the gang: a DTensor,
        # Shard(0) over dp, each rank holding its row of the batch.
        mesh = init_device_mesh("cpu", (session.get_world_size(),),
                                mesh_dim_names=("dp",))
        placed = next(iter(config["shards"][0].iter_device_batches(
            batch_size=config["half"], device="cpu", mesh=mesh)))["inp"]
        placed = {"shape": list(placed.shape),
                  "shard0": [p.is_shard(0) for p in placed.placements],
                  "local": placed.to_local().tolist()}
        weights = session.get_broadcast_weights()
        state = spmd.init_train_state(
            config["cfg"], spmd.adamw(3e-4, weight_decay=0.01),
            {n: t.clone() for n, t in weights.items()}, device="cpu")
        start = 0
        ckpt = session.get_checkpoint()
        if ckpt is not None:
            ckpt.to_pytree(state)
            start = state.step
        batches = config["shards"][rank].iter_device_batches(
            batch_size=config["half"], device="cpu")
        for i, batch in enumerate(batches):
            if i < start:
                continue
            state.optimizer.zero_grad(set_to_none=True)
            loss = llama.cross_entropy_loss(state.model(batch["inp"]),
                                            batch["tgt"])
            loss.backward()
            session.allreduce_gradients(
                {n: p.grad for n, p in state.model.named_parameters()})
            state.optimizer.step()
            state.step += 1
            if state.step == 2 and ckpt is None:
                raise RuntimeError("injected failure after step 1")
            # The gang's mean of the half-batch losses: the full batch's.
            mean_loss = session.allreduce_gradients([loss.detach()])[0]
            path = os.path.join(config["root"], f"step-{state.step}")
            session.report({"step": state.step, "loss": mean_loss.item(),
                            "landing": ds_mod.landing_counters(),
                            "placed": placed},
                           checkpoint=Checkpoint.from_pytree(state, path))

    trainer = TorchTrainer(
        loop, train_loop_config={"cfg": tcfg, "shards": shards,
                                 "half": half, "root": root},
        scaling_config=ScalingConfig(num_workers=WORKERS, use_gpu=False),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
        initial_weights=weights)
    result = trainer.fit()
    return trainer, result, tcfg


def test_gang_final_params_match_jax_full_batch(gang, jax_side):
    _, result, tcfg = gang
    _, _, want_params, _ = jax_side
    final = result.checkpoint.to_pytree()
    want = convert.params_from_flax(want_params, tcfg)
    got = final["model"]
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   **FINAL_TOL, err_msg=name)


def test_gang_reports_one_metric_a_step_across_the_restart(gang, jax_side):
    trainer, result, _ = gang
    _, _, _, jlosses = jax_side
    assert trainer.telemetry["full_restarts"] == 1
    assert [m["step"] for m in result.metrics_history] == [1, 2, 3]
    assert result.metrics["step"] == STEPS
    # The gang's mean loss is the full batch's, JAX's at tolerance 1e-4
    # (tests/test_torch_train.py's).
    np.testing.assert_allclose([m["loss"] for m in result.metrics_history],
                               jlosses, rtol=1e-4, atol=1e-4)
    # No card on this cluster: the batches took the counted host path.
    assert result.metrics["landing"]["host_batches"] >= 1
    assert result.metrics["landing"]["device_landings"] == 0


def test_device_batches_on_a_mesh_are_dtensors_sharded_over_dp(gang,
                                                              jax_side):
    _, result, _ = gang
    _, tokens, _, _ = jax_side
    placed = result.metrics["placed"]
    assert placed["shape"] == [B // WORKERS, S]
    assert placed["shard0"] == [True]
    # Rank 0's shard of shard 0's first batch: token row 0 of batch 0.
    assert placed["local"] == tokens[0, :1, :-1].tolist()


def test_broadcast_weights_reports_what_the_reference_reports(gang,
                                                              jax_side):
    trainer, _, _ = gang
    params, _, _, _ = jax_side
    # The reference's receive_weights body on the same tree of
    # jax arrays, without its cluster.
    want = jwg.TrainWorker._cls.receive_weights(
        type("W", (), {"rank": 0})(), jax.tree_util.tree_map(jnp.asarray,
                                                             params))
    assert sorted(r["rank"] for r in trainer.weights_received) == [0, 1]
    for got in trainer.weights_received:
        assert (got["leaves"], got["bytes"]) == (want["leaves"],
                                                 want["bytes"])


def test_fit_with_use_gpu_on_a_cluster_without_a_card_raises(port_rt):
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer

    trainer = TorchTrainer(lambda: None,
                           scaling_config=ScalingConfig(num_workers=1))
    with pytest.raises(RuntimeError, match="GPU"):
        trainer.fit()


def test_elastic_and_strict_ici_raise():
    from ray_tpu_torch.train import ElasticConfig, ScalingConfig
    from ray_tpu_torch.train.worker_group import WorkerGroup

    # elastic= is taken (tests/test_torch_elastic.py drives it), and an
    # elastic gang refuses a STRICT_* placement, as the reference's does.
    sc = ScalingConfig(num_workers=2, elastic=ElasticConfig(min_workers=1))
    assert sc.elastic.min_workers == 1 and sc.elastic.max_workers is None
    with pytest.raises(ValueError, match="STRICT"):
        WorkerGroup(ScalingConfig(placement_strategy="STRICT_PACK",
                                  elastic=ElasticConfig()))
    with pytest.raises(ValueError, match="STRICT_ICI"):
        ScalingConfig(placement_strategy="STRICT_ICI")
