"""The port's mesh, sharding rules, sharded training step, sequence
parallelism, pipeline, collectives and expert-parallel MoE step against
the JAX package, on the CPU.

The multi-rank checks run the port on one gloo world of 8 processes
(tests/torch_parallel_ranks.py), spawned once by a module-scoped fixture
under a time limit; each check is its own test reading the results. The
JAX side runs in this process on the 8 CPU devices that tests/conftest.py
provides, from the same numpy seeds. Tolerances are the reference tests':
losses and attention outputs 2e-5, attention grads 1e-4, final parameters
1e-4 (absolute and relative), the pipeline 1e-5.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from ray_tpu import parallel as jpar  # noqa: E402
from ray_tpu.models import encoder as jenc  # noqa: E402
from ray_tpu.models import llama as jl  # noqa: E402
from ray_tpu.models import moe as jmoe  # noqa: E402
from ray_tpu.models import ssm as jssm  # noqa: E402
from ray_tpu.models import vit as jvit  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.train import spmd as jspmd  # noqa: E402
from ray_tpu_torch import parallel as tpar  # noqa: E402
from ray_tpu_torch import models as tmodels  # noqa: E402
from ray_tpu_torch.models import convert  # noqa: E402
from ray_tpu_torch.models import llama as tl  # noqa: E402
from ray_tpu_torch.models import moe as tmoe  # noqa: E402
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.parallel import sharding as tsh  # noqa: E402
from tests import torch_parallel_ranks as ranks  # noqa: E402
from tests.test_torch_models import _random_tree  # noqa: E402
from tests.test_torch_moe import _jax_forward_and_routing  # noqa: E402

WORLD = 8
SPAWN_TIMEOUT_S = 300
BATCH, SEQ = 8, 64
JCFG = jl.LlamaConfig(vocab_size=256, d_model=128, n_layers=2, n_heads=8,
                      n_kv_heads=8, d_ff=256, max_seq_len=128,
                      dtype=jnp.float32, attention="reference", remat=False)
PARAM_NAMES = sorted(tl.LlamaModel(ranks.DRYRUN_CFG, device="meta")
                     .state_dict())
MOE_PARAM_NAMES = sorted(tmoe.MoEModel(ranks.MOE_DRYRUN_CFG, device="meta")
                         .state_dict())
SP_CASES = [(fn, causal) for fn in ("ring", "ulysses")
            for causal in (False, True)]
# name: (JAX config, the port's, mesh, (batch, seq)). "dryrun" is the
# reference dryrun's part 4 (__graft_entry__.py:218-269), "tiny" the mesh
# of tests/test_moe_generate.py::test_moe_sharded_train_step_on_mesh, and
# "drops" the same with a capacity that drops choices on both data ranks.
MOE_CASES = {
    "dryrun": (jmoe.MoEConfig(vocab_size=128, d_model=64, n_layers=1,
                              n_heads=4, n_kv_heads=4, d_ff=128, n_experts=4,
                              experts_per_token=2, max_seq_len=32,
                              dtype=jnp.float32, attention="reference",
                              remat=False),
               ranks.MOE_DRYRUN_CFG, dict(dp=2, ep=2, tp=2), (4, 16)),
    "tiny": (jmoe.TINY_MOE, tmoe.TINY_MOE, dict(dp=2, ep=4), (4, 8)),
    "drops": (dataclasses.replace(jmoe.TINY_MOE, capacity_factor=0.5),
              dataclasses.replace(tmoe.TINY_MOE, capacity_factor=0.5),
              dict(dp=2, ep=4), (4, 8)),
}
# The other families' sharded steps, on the meshes of the reference's
# tests (tests/test_models.py::test_vit_forward_and_train_step,
# tests/test_models_ssm.py): name -> (JAX model, the port's config, the
# JAX rules, mesh).
FAMILY_CASES = {
    "vit": (jvit.ViT(jvit.VIT_TINY), tmodels.VIT_TINY,
            jpar.TRANSFORMER_RULES, dict(dp=4, tp=2)),
    "encoder": (jenc.Encoder(jenc.TINY_ENCODER), tmodels.TINY_ENCODER,
                jpar.TRANSFORMER_RULES, dict(dp=2, fsdp=2, tp=2)),
    "ssm": (jssm.SSMModel(jssm.TINY_SSM), tmodels.TINY_SSM, jssm.SSM_RULES,
            dict(dp=2, fsdp=2, tp=2)),
}
COLLECTIVES = ["allreduce", "allreduce_mean", "allreduce_max", "allgather",
               "reducescatter", "broadcast", "shift_right", "shift_left",
               "permute_partial", "axis_index", "allreduce_grad", "alltoall",
               "allreduce_two_axes", "allreduce_tp"]


def _jax_dryrun():
    """Part 1 of the reference dryrun (__graft_entry__.py:133-176), two
    steps: (initial params, batch data, losses, final params)."""
    mesh = jpar.make_mesh(jpar.MeshConfig(dp=2, fsdp=2, tp=2))
    model = jl.LlamaModel(JCFG)
    tokens = jnp.zeros((BATCH, SEQ), jnp.int32)
    opt = optax.adamw(ranks.LR)
    state, specs = jspmd.init_sharded_state(
        mesh, lambda t: model.init(jax.random.PRNGKey(0), t),
        jpar.TRANSFORMER_RULES, opt, tokens)
    params0 = jax.device_get(state.params)

    def loss_fn(params, batch):
        inp, tgt = batch
        return jl.cross_entropy_loss(model.apply(params, inp), tgt)

    spec = (JP(("dp", "fsdp"), None),) * 2
    step = jspmd.shard_train_step(jspmd.make_train_step(loss_fn, opt), mesh,
                                  specs, spec)
    data = np.random.default_rng(0).integers(0, JCFG.vocab_size,
                                             (BATCH, SEQ + 1))
    batch = jax.device_put(
        (jnp.asarray(data[:, :-1], jnp.int32),
         jnp.asarray(data[:, 1:], jnp.int32)),
        tuple(NamedSharding(mesh, s) for s in spec))
    losses = []
    for _ in range(ranks.DRYRUN_STEPS):
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    return params0, data, losses, jax.device_get(state.params)


def _jax_moe(jcfg, tcfg, mesh_kw, shape, seed):
    """The reference's sharded MoE loss and grads on conftest's 8 CPU
    devices (params laid out by MOE_RULES, the batch over dp), and its
    routing from one eager apply; with the port's inputs."""
    mesh = jpar.make_mesh(jpar.MeshConfig(**mesh_kw))
    model = jmoe.MoEModel(jcfg)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                       jnp.zeros(shape, jnp.int32)))
    data = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (shape[0], shape[1] + 1))
    batch = (jnp.asarray(data[:, :-1], jnp.int32),
             jnp.asarray(data[:, 1:], jnp.int32))

    def loss_fn(p, b):
        logits, st = model.apply(p, b[0], mutable=["intermediates"])
        return (jl.cross_entropy_loss(logits, b[1])
                + jmoe.moe_aux_loss(st["intermediates"]))

    sharded = jax.tree_util.tree_map(
        jax.device_put, params, jmoe.MOE_RULES.tree_shardings(mesh, params))
    on_mesh = jax.device_put(batch, NamedSharding(mesh, JP(("dp", "fsdp"),
                                                           None)))
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(sharded, on_mesh)
    _, _, routing = _jax_forward_and_routing(model, params, batch[0])
    return {"params": {n: t.numpy() for n, t in
                       convert.params_from_flax(params, tcfg).items()},
            "data": data, "loss": float(loss), "routing": routing,
            "grads": {n: t.numpy() for n, t in convert.params_from_flax(
                jax.device_get(grads), tcfg).items()}}


def _family_batch(name, rng):
    """The numpy batch of a family's case: (images, labels) for ViT,
    (inputs, targets, MLM mask) for the encoder, (inputs, targets) for
    the SSM; a batch of 4."""
    if name == "vit":
        return (rng.standard_normal((4, 32, 32, 3)).astype(np.float32),
                rng.integers(0, 10, (4,)).astype(np.int32))
    tgt = rng.integers(3, 256, (4, 17)).astype(np.int32)
    if name == "ssm":
        return tgt[:, :-1], tgt[:, 1:]
    mask = rng.random((4, 16)) < 0.3
    return np.where(mask, 1, tgt[:, :-1]).astype(np.int32), tgt[:, :-1], mask


def _jax_family_loss(name, jmodel):
    def loss_fn(p, b):
        if name == "vit":
            return jvit.vit_loss(jmodel.apply(p, b[0]), b[1])
        if name == "encoder":
            return jenc.mlm_loss(jmodel.apply(p, b[0])[1], b[1], b[2])
        return jl.cross_entropy_loss(jmodel.apply(p, b[0]), b[1])
    return loss_fn


def _jax_family(name, seed):
    """The reference's loss and grads of a family at its tiny config, on
    random weights (`tests.test_torch_models._random_tree`) and the
    port's batch, and each parameter's shard shape under its rules on the
    case's mesh of conftest's 8 CPU devices. The loss and grads are the
    single-device ones: the reference's own sharded step of the encoder
    and the SSM on (dp 2, fsdp 2, tp 2) there gives a loss 3% and 0.2%
    off them (from its init at PRNGKey(0): 6.2503 against 6.4346, 8.1878
    against 8.1725), where ViT's agrees."""
    jmodel, tcfg, rules, mesh_kw = FAMILY_CASES[name]
    mesh = jpar.make_mesh(jpar.MeshConfig(**mesh_kw))
    batch = _family_batch(name, np.random.default_rng(seed))
    params = _random_tree(name, seed)
    loss, grads = jax.jit(jax.value_and_grad(_jax_family_loss(name, jmodel)))(
        params, tuple(map(jnp.asarray, batch)))
    shards = jax.tree_util.tree_map(
        lambda a, sh: np.zeros(sh.shard_shape(a.shape), np.float32),
        params, rules.tree_shardings(mesh, params))
    return {"params": {n: t.numpy() for n, t in
                       convert.params_from_flax(params, tcfg).items()},
            "local": {n: tuple(t.shape) for n, t in
                      convert.params_from_flax(shards, tcfg).items()},
            "batch": batch, "loss": float(loss),
            "grads": {n: t.numpy() for n, t in convert.params_from_flax(
                jax.device_get(grads), tcfg).items()}}


def _qkv(seed, H):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, H, 256, 32), dtype=np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def jax_side():
    params0, data, losses, final = _jax_dryrun()
    port_params = {n: t.numpy() for n, t in
                   convert.params_from_flax(params0, ranks.DRYRUN_CFG).items()}
    want = convert.params_from_flax(final, ranks.DRYRUN_CFG)
    sp_inputs = {f"{fn}-{causal}": (fn, *_qkv(seed, 2 if fn == "ring" else 8),
                                    causal)
                 for seed, (fn, causal) in enumerate(SP_CASES)}
    rng = np.random.default_rng(1)
    pipe = {"ws": (rng.standard_normal((8, 16, 16)) * 0.3).astype(np.float32),
            "x": rng.standard_normal((8, 4, 16)).astype(np.float32)}
    moe = {name: _jax_moe(jcfg, tcfg, mesh_kw, shape, seed)
           for seed, (name, (jcfg, tcfg, mesh_kw, shape))
           in enumerate(MOE_CASES.items())}
    families = {name: _jax_family(name, seed)
                for seed, name in enumerate(FAMILY_CASES)}
    return {"params": port_params, "data": data, "losses": losses,
            "final": {n: t.numpy() for n, t in want.items()},
            "sp": sp_inputs, "pipe": pipe, "moe": moe,
            "families": families}


@pytest.fixture(scope="module")
def world(jax_side, tmp_path_factory):
    """One spawn of 8 gloo ranks running every multi-rank program."""
    return ranks.run_world(WORLD, {
        "dryrun": {"params": jax_side["params"], "data": jax_side["data"],
                   "ckpt_dir": str(tmp_path_factory.mktemp("dcp"))},
        "sequence_parallel": jax_side["sp"],
        "pipeline": jax_side["pipe"],
        "collectives": {},
        "moe": {name: {"cfg": tcfg, "mesh": mesh_kw,
                       "params": jax_side["moe"][name]["params"],
                       "data": jax_side["moe"][name]["data"]}
                for name, (_, tcfg, mesh_kw, _) in MOE_CASES.items()},
        "families": {name: {"cfg": tcfg, "mesh": mesh_kw,
                            "params": jax_side["families"][name]["params"],
                            "batch": jax_side["families"][name]["batch"]}
                     for name, (_, tcfg, _, mesh_kw) in FAMILY_CASES.items()},
    }, timeout=SPAWN_TIMEOUT_S)


@pytest.fixture(scope="module")
def one(jax_side):
    """A world of one, in its own process so no process group outlives it."""
    tiny = jax_side["moe"]["tiny"]
    return ranks.run_world(1, {"world_of_one": {
        "params": jax_side["params"], "data": jax_side["data"],
        "attentions": ["reference", "flash"],
        "moe": {"cfg": dataclasses.replace(tmoe.TINY_MOE, remat=True),
                "params": tiny["params"], "data": tiny["data"]}}},
        timeout=SPAWN_TIMEOUT_S)[0]["world_of_one"]


# ---------------------------------------------------------------------------
# (a) the dryrun's flagship step, dp 2 x fsdp 2 x tp 2
# ---------------------------------------------------------------------------


def test_dryrun_losses_match_jax(world, jax_side):
    got = world[0]["dryrun"]
    print("sharded steps (s; the first propagates the shardings): "
          + ", ".join(f"{t:.2f}" for t in got["step_s"]))
    np.testing.assert_allclose(got["losses"], jax_side["losses"], rtol=2e-5,
                               atol=0)


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_dryrun_params_match_jax(world, jax_side, name):
    np.testing.assert_allclose(world[0]["dryrun"]["params"][name],
                               jax_side["final"][name], rtol=1e-4, atol=1e-4)


def test_dryrun_state_is_laid_out_by_the_rules(world):
    got = world[0]["dryrun"]
    assert got["mesh"].startswith("DeviceMesh((dp=2, fsdp=2, tp=2)")
    lay = got["placements"]
    # flax (in, out) P("fsdp", "tp") is torch (out, in): out on tp, in on fsdp
    assert lay["layers.0.attn.q_proj.weight"] == \
        "(Replicate(), Shard(dim=1), Shard(dim=0))"
    assert lay["layers.1.mlp.down_proj.weight"] == \
        "(Replicate(), Shard(dim=0), Shard(dim=1))"
    assert lay["embed.weight"] == "(Replicate(), Shard(dim=0), Shard(dim=1))"
    assert lay["norm.scale"] == "(Replicate(), Replicate(), Replicate())"


def test_sharded_step_refuses_a_batch_that_does_not_split(world):
    assert "does not split into 4 equal shards" in \
        world[0]["dryrun"]["uneven_batch"]


@pytest.mark.parametrize("what", ["shard_tree", "with_rules_constraint"])
def test_rules_lay_out_a_tree_as_the_state(world, jax_side, what):
    got = world[0]["dryrun"]
    layout = got["layouts"][what]
    assert layout["placements"] == got["placements"]
    assert layout["unequal"] == []


@pytest.mark.parametrize("attention", ["ring", "ulysses", "flash"])
def test_sequence_sharded_model_matches_jax(world, jax_side, attention):
    """The Llama's ring, Ulysses and flash branches in a sharded step on an
    sp=8 mesh, the sequence sharded over sp, against JAX's dryrun."""
    got = world[0]["dryrun"]["sp_model"][attention]
    np.testing.assert_allclose(got["losses"], jax_side["losses"], rtol=2e-5,
                               atol=0)
    for name, want in jax_side["final"].items():
        np.testing.assert_allclose(got["params"][name], want, rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# (e) reshard_to_mesh
# ---------------------------------------------------------------------------


def test_reshard_keeps_every_tensor(world):
    got = world[0]["dryrun"]["reshard"]
    assert got["same_losses"] and got["names"]
    assert got["unequal"] == []
    assert got["mesh"].startswith("DeviceMesh((fsdp=8)")
    assert got["placements"] == "(Shard(dim=1),)"


def test_reshard_next_step_loss(world):
    got = world[0]["dryrun"]["reshard"]
    np.testing.assert_allclose(got["next_loss_resharded"], got["next_loss"],
                               rtol=2e-5, atol=0)


def test_checkpoint_restored_onto_another_mesh(world):
    """The (dp 2, fsdp 2, tp 2) state saved through DCP, each rank writing
    its shards, and restored onto a fresh state on (fsdp 8), each rank
    reading its new shards: every parameter and moment, and then one
    step's loss and state, bitwise reshard_to_mesh's."""
    got = world[0]["dryrun"]["restore"]
    print(f"save, restore and the restored step: "
          f"{world[0]['dryrun']['seconds']['checkpoint']:.2f} s")
    assert got["unequal_before_step"] == []
    assert got["placements"] == "(Shard(dim=1),)"
    assert got["steps"] == [ranks.DRYRUN_STEPS + 1] * 2
    assert got["next_loss"] == world[0]["dryrun"]["reshard"][
        "next_loss_resharded"]
    assert got["unequal_after_step"] == []


# ---------------------------------------------------------------------------
# (b) ring and Ulysses attention on an sp=8 mesh
# ---------------------------------------------------------------------------


def _sp_result(world, fn, causal):
    parts = [r["sequence_parallel"][f"{fn}-{causal}"] for r in world]
    return [np.concatenate(t, axis=2) for t in zip(*parts)]


@pytest.mark.parametrize("fn,causal", SP_CASES)
def test_sequence_parallel_forward_matches_jax(world, jax_side, fn, causal):
    _, q, k, v, _, _ = jax_side["sp"][f"{fn}-{causal}"]
    want = jattn.mha_reference(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
    out = _sp_result(world, fn, causal)[0]
    np.testing.assert_allclose(out, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("fn,causal", SP_CASES)
def test_sequence_parallel_grads_match_autograd(world, jax_side, fn, causal):
    _, q, k, v, do, _ = jax_side["sp"][f"{fn}-{causal}"]
    qkv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tattn.mha_reference(*qkv, causal=causal)
     * torch.from_numpy(do)).sum().backward()
    for got, t in zip(_sp_result(world, fn, causal)[1:], qkv):
        np.testing.assert_allclose(got, t.grad.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# (c) the pipeline, (d) the collectives
# ---------------------------------------------------------------------------


def test_pipeline_matches_sequential(world, jax_side):
    ws, x = jax_side["pipe"]["ws"], jax_side["pipe"]["x"]
    want = jnp.asarray(x)
    for w in ws:
        want = jnp.tanh(want @ w)
    mb = x.shape[1] // 2
    for r in world:
        got = r["pipeline"]
        np.testing.assert_allclose(
            got["y"], np.asarray(want)[:, got["dp"] * mb:(got["dp"] + 1) * mb],
            atol=1e-5, err_msg=f"stage {got['stage']}")


def _expected_collective(name, rank):
    x = np.arange(8.0)
    return {
        "allreduce": [28.0], "allreduce_mean": [3.5], "allreduce_max": [7.0],
        "allgather": x, "reducescatter": (np.arange(16.0) * 36)[2 * rank:
                                                                 2 * rank + 2],
        "broadcast": [3.0], "shift_right": [(rank - 1) % 8],
        "shift_left": [(rank + 1) % 8],
        "permute_partial": [2.0 if rank == 5 else 0.0],
        "axis_index": rank,
        "allreduce_grad": [36.0],     # the sum of every rank's (rank + 1)
        "allreduce_two_axes": [28.0],
        "allreduce_tp": [sum(range(4 * (rank // 4), 4 * (rank // 4) + 4))],
    }[name]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives(world, name):
    if name == "alltoall":
        # as tests/test_parallel.py: rows in over sp, columns out over sp
        got = np.concatenate([r["collectives"][name] for r in world], axis=1)
        x = np.arange(64.0).reshape(8, 8)
        np.testing.assert_array_equal(got, x.T.reshape(8, 8).T)
        return
    for rank, r in enumerate(world):
        np.testing.assert_array_equal(r["collectives"][name],
                                      _expected_collective(name, rank),
                                      err_msg=f"rank {rank}")


# ---------------------------------------------------------------------------
# (f) the expert-parallel MoE step (ep), against JAX's 8-device run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_sharded_loss_matches_jax(world, jax_side, case):
    got = world[0]["moe"][case]
    print(f"{case}: first sharded MoE step {got['step_s']:.2f} s")
    np.testing.assert_allclose(got["loss"], jax_side["moe"][case]["loss"],
                               rtol=2e-5, atol=0)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_sharded_grads_match_jax(world, jax_side, case):
    """Router, experts and every other parameter."""
    got, want = world[0]["moe"][case]["grads"], jax_side["moe"][case]["grads"]
    assert got.keys() == want.keys()
    for name, g in got.items():
        np.testing.assert_allclose(g, want[name], rtol=1e-4, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_expert_weights_shard_over_ep(world, case):
    got = world[0]["moe"][case]
    _, tcfg, mesh_kw, _ = MOE_CASES[case]
    names = [a for a in ("dp", "ep", "tp") if a in mesh_kw]
    assert got["mesh"].startswith(
        "DeviceMesh((" + ", ".join(f"{a}={mesh_kw[a]}" for a in names))
    placements, local = got["w_gate"]
    # (E, M, F) by P("ep", "fsdp", "tp"): experts over ep, F over tp
    want = {"dp": "Replicate()", "ep": "Shard(dim=0)", "tp": "Shard(dim=2)"}
    assert placements == "(" + ", ".join(want[a] for a in names) + ")"
    assert local == (tcfg.n_experts // mesh_kw["ep"], tcfg.d_model,
                     tcfg.d_ff // mesh_kw.get("tp", 1))


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_sharded_routing_is_global(world, jax_side, case):
    """Capacity and slot order over the global batch: the sharded
    routing is the reference's single-device routing, drops included."""
    got = world[0]["moe"][case]["routing"]
    want = jax_side["moe"][case]["routing"]
    _, tcfg, mesh_kw, (batch, seq) = MOE_CASES[case]
    for layer, (g, (_, top_e, slot, keep)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g["top_e"], top_e)
        np.testing.assert_array_equal(g["slot"], slot)
        np.testing.assert_array_equal(g["keep"], keep)
    if case == "drops":
        per_rank = np.split(keep, mesh_kw["dp"])
        assert all((k == 0).any() for k in per_rank), \
            [int((k == 0).sum()) for k in per_rank]


# ---------------------------------------------------------------------------
# (g) the other families' sharded steps: ViT on (dp 4, tp 2) by
# TRANSFORMER_RULES, the encoder by the same rules and the SSM by SSM_RULES
# on (dp 2, fsdp 2, tp 2)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(FAMILY_CASES))
def test_family_sharded_step_matches_jax(world, jax_side, case):
    """One sharded step's loss and every gradient against the reference's
    function (see `_jax_family`), and each parameter's local shard shape
    against the reference's layout of it on the same mesh."""
    got, want = world[0]["families"][case], jax_side["families"][case]
    print(f"{case}: first sharded step {got['step_s']:.2f} s")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-5, atol=0)
    assert got["grads"].keys() == want["grads"].keys()
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, want["grads"][name], rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    # each rank's shard of each parameter, as GSPMD shards it
    assert got["local"] == want["local"]


# ---------------------------------------------------------------------------
# A world of one: the sharded step is the single-device step, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", ["reference", "flash", "moe"])
def test_world_of_one_step_is_bitwise_the_plain_step(one, attention):
    """The Llama with each attention, and the MoE model under remat."""
    got = one[attention]
    assert got["mesh"].startswith("DeviceMesh((dp=1)")
    for step in got["steps"]:
        plain, sharded = step["loss"]
        assert plain == sharded
        assert step["unequal"] == []


# ---------------------------------------------------------------------------
# In-process: mesh config, rules and specs against the reference
# ---------------------------------------------------------------------------


def test_mesh_config_resolution_matches_jax():
    for kw, n in [(dict(dp=2, tp=4), 8), (dict(dp=-1, tp=2), 8),
                  (dict(dp=2, fsdp=2, tp=2), 8), (dict(sp=-1), 4),
                  (dict(pp=4, dp=2), 8), ({}, 1)]:
        assert tpar.MeshConfig(**kw).resolved(n) == \
            jpar.MeshConfig(**kw).resolved(n)
    for kw, n in [(dict(dp=3), 8), (dict(dp=-1, tp=-1), 8),
                  (dict(dp=-1, tp=3), 8)]:
        with pytest.raises(ValueError):
            jpar.MeshConfig(**kw).resolved(n)
        with pytest.raises(ValueError):
            tpar.MeshConfig(**kw).resolved(n)
    assert tpar.AXIS_ORDER == jpar.AXIS_ORDER
    assert tpar.data_axes() == jpar.data_axes()


@functools.lru_cache(maxsize=2)
def _flax_leaves(moe: bool = False):
    """{the port's name: (flax path, leaf)} of the dryrun's Llama or MoE
    model, found by converting a tree whose leaves hold their own index."""
    jmodel, tcfg = ((jmoe.MoEModel(MOE_CASES["dryrun"][0]),
                     ranks.MOE_DRYRUN_CFG) if moe
                    else (jl.LlamaModel(JCFG), ranks.DRYRUN_CFG))
    tree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, 8), jnp.int32)))
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(leaf.shape, i, np.float32)
                  for i, (_, leaf) in enumerate(leaves)])
    ported = convert.params_from_flax(tagged, tcfg)
    return {name: leaves[int(t.reshape(-1)[0])]
            for name, t in ported.items()}


def _check_spec(name, rules, jrules, model, moe):
    path, leaf = _flax_leaves(moe)[name]
    want = tuple(jrules.spec_for(path, leaf))
    if jax.tree_util.keystr(path).endswith("['kernel']"):
        want = tuple(reversed(want + (None,) * (2 - len(want))))
    got = rules.spec_for(name, model.state_dict()[name])
    assert tuple(got) == want, (name, jax.tree_util.keystr(path))


@pytest.mark.parametrize("name", PARAM_NAMES)
def test_spec_matches_jax_rules(name):
    _check_spec(name, tpar.TRANSFORMER_RULES, jpar.TRANSFORMER_RULES,
                tl.LlamaModel(ranks.DRYRUN_CFG, device="meta"), False)


@pytest.mark.parametrize("name", MOE_PARAM_NAMES)
def test_moe_spec_matches_jax_rules(name):
    """MOE_RULES on every parameter of the MoE model, the experts' raw
    (E, in, out) kernels untransposed."""
    _check_spec(name, tmoe.MOE_RULES, jmoe.MOE_RULES,
                tmoe.MoEModel(ranks.MOE_DRYRUN_CFG, device="meta"), True)


def test_spec_clipped_to_rank():
    rules = tsh.ShardingRules([(r"norm", tsh.P("fsdp", "tp"))])
    assert rules.spec_for("norm.scale", torch.zeros(8)) == tsh.P("fsdp")
    jrules = jpar.ShardingRules([(r"w", JP("fsdp", "tp"))])
    assert tuple(jrules.spec_for((jax.tree_util.DictKey("w"),),
                                 jnp.zeros((8,)))) == ("fsdp",)


def test_batch_spec_matches_jax():
    for extra in (1, 2, 3):
        assert tuple(tpar.batch_spec(extra)) == tuple(jpar.batch_spec(extra))


def test_spec_placements():
    from torch.distributed.tensor import Replicate, Shard

    class _Mesh:
        mesh_dim_names = ("dp", "fsdp", "sp", "tp")

    got = tsh.spec_placements(tpar.P(("dp", "fsdp"), "sp", None), _Mesh)
    assert got == (Shard(0), Shard(0), Shard(1), Replicate())
    assert tsh.spec_placements(tpar.P(None, "tp"), _Mesh) == \
        (Replicate(), Replicate(), Replicate(), Shard(1))
    with pytest.raises(ValueError, match="AXIS_ORDER"):
        tsh.spec_placements(tpar.P(("fsdp", "dp")), _Mesh)
    with pytest.raises(ValueError, match="twice"):
        tsh.spec_placements(tpar.P("tp", "tp"), _Mesh)


def test_pipeline_helpers_match_jax():
    x = np.arange(48.0, dtype=np.float32).reshape(12, 4)
    want = jpar.split_microbatches(jnp.asarray(x), 3)
    got = tpar.split_microbatches(torch.from_numpy(x), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tpar.merge_microbatches(got).numpy(), x)
    with pytest.raises(ValueError):
        tpar.split_microbatches(torch.from_numpy(x), 5)
    tree = {"w": np.arange(96.0, dtype=np.float32).reshape(8, 3, 4)}
    jwant = jpar.stage_slice_params({"w": jnp.asarray(tree["w"])}, 4)
    tgot = tpar.stage_slice_params({"w": torch.from_numpy(tree["w"])}, 4)
    np.testing.assert_array_equal(tgot["w"].numpy(), np.asarray(jwant["w"]))


def test_num_params_matches_jax():
    tree = {"a": np.zeros((3, 4)), "b": np.zeros((5,))}
    assert tpar.num_params({k: torch.from_numpy(v) for k, v in tree.items()}) \
        == jpar.num_params(tree) == 17
    model = tl.LlamaModel(ranks.DRYRUN_CFG, device="meta")
    assert tpar.num_params(model) == jpar.num_params(jax.eval_shape(
        lambda: jl.LlamaModel(JCFG).init(jax.random.PRNGKey(0),
                                         jnp.zeros((1, 8), jnp.int32))))
