"""The port's paged decode attention against the JAX package's kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as their own
tests run them; the port runs its plain PyTorch versions, which its CUDA
kernel is held against on the card (chip_smoke.py). Inputs come from a
seeded numpy generator. Tolerance 2e-4, as tests/test_paged_attention.py.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ray_tpu.ops import paged_attention as jpa  # noqa: E402
from ray_tpu_torch.ops import paged_attention as tpa  # noqa: E402

PAGE, D, NP = 8, 32, 5
LENGTHS = [1, 7, 16, 37, NP * PAGE]   # the last fills the whole table
HEADS = [pytest.param(8, 8, id="mha"), pytest.param(8, 4, id="gqa")]


def _inputs(H, Hkv, seed=0, lengths=LENGTHS):
    """A shuffled pool holding noise everywhere (so a page read past the
    length would show), tables padded with each sequence's last page (a
    sequence of length 0 owns one page)."""
    rng = np.random.default_rng(seed)
    B, pool_pages = len(lengths), len(lengths) * NP + 3
    k_pool = rng.standard_normal((pool_pages, Hkv, PAGE, D)).astype(np.float32)
    v_pool = rng.standard_normal((pool_pages, Hkv, PAGE, D)).astype(np.float32)
    free = list(rng.permutation(pool_pages))
    tables = np.zeros((B, NP), np.int32)
    for b, length in enumerate(lengths):
        own = [int(free.pop()) for _ in range(max(1, -(-length // PAGE)))]
        tables[b] = (own + [own[-1]] * NP)[:NP]
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, k_pool, v_pool, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("H,Hkv", HEADS)
@pytest.mark.parametrize("fused_heads", [False, True])
def test_batch_matches_jax(H, Hkv, fused_heads):
    """K3 (fused_heads=False) and K4 (fused_heads=True)."""
    arrays = _inputs(H, Hkv)
    want = jpa.paged_decode_attention_batch(
        *map(jnp.asarray, arrays), fused_heads=fused_heads)
    got = tpa.paged_decode_attention_batch(
        *map(torch.from_numpy, arrays), fused_heads=fused_heads)
    assert got.shape == (len(LENGTHS), H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def _split_pages_case(B, Hkv, NP, sm_count):
    """K4: pages in runs of `per`."""
    splits, per = tpa.split_pages(B, Hkv, NP, sm_count)
    covered = [p for s in range(splits)
               for p in range(s * per, min((s + 1) * per, NP))]
    assert covered == list(range(NP)), (B, Hkv, NP, splits, per)
    assert 1 <= splits <= NP and (splits - 1) * per < NP
    enough = [-(-NP // p) for p in range(1, NP + 1)
              if B * Hkv * -(-NP // p) >= min(2 * sm_count, B * Hkv * NP)]
    assert splits == min(enough), (B, Hkv, NP, splits, per)


def _cluster_splits_case(B, Hkv, NP, sm_count, per_sm=3):
    """K2/K3: NP chunks in balanced runs, one cluster of at most 8, with
    `per_sm` blocks an SM resident."""
    resident = [sm_count * per_sm // s for s in range(1, 9)]
    splits = tpa.cluster_splits(B * Hkv, NP, resident)
    runs = [range(s * NP // splits, (s + 1) * NP // splits)  # the kernel's
            for s in range(splits)]
    assert [u for r in runs for u in r] == list(range(NP)), (B, Hkv, NP)
    assert all(len(r) >= 1 for r in runs)
    assert max(map(len, runs)) - min(map(len, runs)) <= 1
    assert 1 <= splits <= min(tpa.MAX_CLUSTER, NP)
    fit = [s for s in range(1, min(tpa.MAX_CLUSTER, NP) + 1)
           if B * Hkv <= resident[s - 1]]
    assert splits == max(fit, default=1), (B, Hkv, NP, splits)


@pytest.mark.parametrize("chooser", [_split_pages_case, _cluster_splits_case],
                         ids=["split_pages", "cluster_splits"])
@pytest.mark.parametrize("sm_count", [1, 78, 114, 132])
def test_split_chooser_partitions_every_table(sm_count, chooser):
    """The split choosers of K4 (`split_pages`) and of K2/K3
    (`cluster_splits`, over a table's chunks): for every batch, KV-head
    count and table width tried, each page or chunk lies in exactly one
    split and no split is empty. K4 reaches two blocks an SM where the
    table allows it; K2/K3 take the most splits (up to the cluster's 8)
    that keep the grid resident at once. With the engine's shapes (Hkv 8,
    a 9-chunk table) on 132 SMs holding 3 blocks each, K2/K3 split 8 ways
    at B 1 (64 blocks), 6 at B 8 (384) and 1 at B 32 (256)."""
    for B in (1, 2, 3, 8, 32, 64, 257):
        for Hkv in (1, 2, 8):
            for NP in (1, 2, 5, 9, 17, 64):
                chooser(B, Hkv, NP, sm_count)
    if chooser is _cluster_splits_case and sm_count == 132:
        resident = [132 * 3 // s for s in range(1, 9)]
        assert [tpa.cluster_splits(B * 8, 9, resident)
                for B in (1, 8, 32)] == [8, 6, 1]


@pytest.mark.parametrize("H,Hkv", HEADS)
@pytest.mark.parametrize("fused_heads", [False, True])
def test_length_zero_matches_jax(H, Hkv, fused_heads):
    """At length 0 the JAX kernels average V over the table's pages
    (every score -1e30, p = exp(0)); the port's plain versions, which its
    CUDA kernels are held to on the card, give the same, batched (K3, K4)
    and single-sequence (K2)."""
    lengths = [0, 7, 0, 37, 0]
    arrays = _inputs(H, Hkv, seed=2, lengths=lengths)
    want = jpa.paged_decode_attention_batch(
        *map(jnp.asarray, arrays), fused_heads=fused_heads)
    got = tpa.paged_decode_attention_batch(
        *map(torch.from_numpy, arrays), fused_heads=fused_heads)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    if fused_heads:
        return
    q, k_pool, v_pool, tables, lens = arrays
    for b in (0, 2):
        want_one = jpa.paged_decode_attention(
            jnp.asarray(q[b]), jnp.asarray(k_pool), jnp.asarray(v_pool),
            jnp.asarray(tables[b]), jnp.asarray(lens[b]))
        got_one = tpa.paged_decode_attention(
            torch.from_numpy(q[b]), torch.from_numpy(k_pool),
            torch.from_numpy(v_pool), torch.from_numpy(tables[b]),
            torch.tensor(lens[b]))
        np.testing.assert_allclose(got_one.numpy(), np.asarray(want_one),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("H,Hkv", HEADS)
def test_single_sequence_matches_jax(H, Hkv):
    """K2, vmapped over the sequences on the JAX side as its tests do."""
    q, k_pool, v_pool, tables, lengths = _inputs(H, Hkv, seed=1)
    want = jax.vmap(jpa.paged_decode_attention,
                    in_axes=(0, None, None, 0, 0))(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(tables), jnp.asarray(lengths))
    kp, vp = torch.from_numpy(k_pool), torch.from_numpy(v_pool)
    for b in range(len(LENGTHS)):
        got = tpa.paged_decode_attention(
            torch.from_numpy(q[b]), kp, vp, torch.from_numpy(tables[b]),
            torch.tensor(lengths[b]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want[b]),
                                   rtol=2e-4, atol=2e-4)


def test_page_allocator_matches_jax():
    ops = [("allocate", "a", 40), ("allocate", "b", 17), ("allocate", "a", 70),
           ("table", "a", 8), ("free", "b", 0), ("allocate", "c", 33),
           ("table", "c", 4), ("table", "missing", 3), ("allocate", "d", 200),
           ("free", "a", 0), ("allocate", "d", 64), ("table", "d", 6)]
    ja, ta = jpa.PageAllocator(12, 16), tpa.PageAllocator(12, 16)
    for op, seq, n in ops:
        results = []
        for alloc in (ja, ta):
            try:
                results.append(getattr(alloc, op)(seq, n) if op != "free"
                               else alloc.free(seq))
            except MemoryError:
                results.append("MemoryError")
        want, got = results
        if op == "table":
            assert got.dtype == torch.int32 and got.device.type == "cpu"
            want, got = np.asarray(want).tolist(), got.tolist()
        assert got == want, (op, seq, n)
        assert ta.free_pages == ja.free_pages


def test_import_loads_no_jax_and_no_cuda():
    code = (
        "import sys, torch\n"
        "import ray_tpu_torch.serve.llm, ray_tpu_torch.models, "
        "ray_tpu_torch.ops, ray_tpu_torch.train.spmd, "
        "ray_tpu_torch.parallel, ray_tpu_torch.util.collective.ops, "
        "ray_tpu_torch.serve.llm_disagg, ray_tpu_torch.train.checkpoint, "
        "ray_tpu_torch.rllib.env, ray_tpu_torch.rllib.catalog, "
        "ray_tpu_torch.rllib.ppo, ray_tpu_torch.rllib.offline, "
        "ray_tpu_torch, ray_tpu_torch.serve, ray_tpu_torch._private.gcs, "
        "ray_tpu_torch._private.raylet, ray_tpu_torch._private.worker, "
        "ray_tpu_torch._private.worker_zygote, ray_tpu_torch._private.node, "
        "ray_tpu_torch.util.placement_group, "
        "ray_tpu_torch.util.scheduling_strategies, "
        "ray_tpu_torch.util.collective, ray_tpu_torch._private.device_objects, "
        "ray_tpu_torch.data, ray_tpu_torch.train, ray_tpu_torch.train.torch, "
        "ray_tpu_torch.train.trainer, ray_tpu_torch.train.worker_group, "
        "ray_tpu_torch.train.session, ray_tpu_torch.train.config, "
        "ray_tpu_torch.cluster_utils, ray_tpu_torch.test_utils, "
        "ray_tpu_torch.serve.rpc_ingress, ray_tpu_torch.serve.config_deploy, "
        "ray_tpu_torch.rllib, ray_tpu_torch.rllib.learner_group, "
        "ray_tpu_torch.rllib.impala, ray_tpu_torch.rllib.appo, "
        "ray_tpu_torch.rllib.pg, ray_tpu_torch.rllib.a2c, "
        "ray_tpu_torch.rllib.a3c, ray_tpu_torch.rllib.es, "
        "ray_tpu_torch.rllib.connectors, ray_tpu_torch.rllib.env_runner, "
        "ray_tpu_torch.rllib.bandit, ray_tpu_torch.rllib.random_agent, "
        "ray_tpu_torch.rllib.dqn, ray_tpu_torch.rllib.replay, "
        "ray_tpu_torch.rllib.utils, ray_tpu_torch.rllib.simple_q, "
        "ray_tpu_torch.rllib.rainbow, ray_tpu_torch.rllib.r2d2, "
        "ray_tpu_torch.rllib.ddpg, ray_tpu_torch.rllib.sac, "
        "ray_tpu_torch.rllib.maddpg, ray_tpu_torch.rllib.slateq, "
        "ray_tpu_torch.rllib.alphazero, ray_tpu_torch.rllib.cql, "
        "ray_tpu_torch.rllib.crr, ray_tpu_torch.rllib.dt, "
        "ray_tpu_torch.rllib.qmix, ray_tpu_torch.rllib.dreamerv3, "
        "ray_tpu_torch.util.actor_pool, ray_tpu_torch.util.queue, "
        "ray_tpu_torch.util.multiprocessing, ray_tpu_torch.tune, "
        "ray_tpu_torch.tune.search, ray_tpu_torch.tune.schedulers, "
        "ray_tpu_torch.tune.tuner, ray_tpu_torch._private.native_policy, "
        "ray_tpu_torch._private.native_scheduler, "
        "ray_tpu_torch._private.native_raylet_core, "
        "ray_tpu_torch._private.native_gcs_store, "
        "ray_tpu_torch._private.native_gcs_service, "
        "ray_tpu_torch._private.native_fastpath, "
        "ray_tpu_torch._private.fast_rpc, "
        "ray_tpu_torch._private.native_actor_plane, "
        "ray_tpu_torch._private.native_lease_plane, "
        "ray_tpu_torch._private.native_transfer\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                                  'orbax', 'ray_tpu', 'msgpack',\n"
        "                                  'cloudpickle'))\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from ray_tpu_torch.models import TINY, Generator, init_params
    from ray_tpu_torch.serve.llm import LLMEngine, LLMServer

    params = {}  # each raises while resolving its device, before the weights
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMEngine(TINY, params, max_len=64, page_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        LLMServer(TINY, params, max_len=64, page_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Generator(TINY, params, batch=1, max_len=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(TINY, seed=0)
    from ray_tpu_torch.parallel import initialize_multihost, make_mesh
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_multihost("localhost:1", 1, 0)
    from ray_tpu_torch.models import TINY_MOE
    from ray_tpu_torch.train import adamw, init_train_state
    with pytest.raises(RuntimeError, match="CUDA"):
        init_train_state(TINY_MOE, adamw(3e-4))
    from ray_tpu_torch.models import generate
    from ray_tpu_torch.rllib import BCConfig, MARWIL, MARWILConfig, PPOConfig
    from ray_tpu_torch.rllib import PPOLearner
    from ray_tpu_torch.serve.llm_disagg import PrefillEngine
    with pytest.raises(RuntimeError, match="CUDA"):
        generate(TINY, params, [[1, 2]])
    with pytest.raises(RuntimeError, match="CUDA"):
        PrefillEngine(TINY, params, max_len=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        PPOLearner(PPOConfig(), 4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MARWIL(MARWILConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        BCConfig().build()
    from ray_tpu_torch.rllib import (AlphaZeroConfig, CQLConfig, CRRConfig,
                                     DQNConfig, DreamerV3Config, DTConfig,
                                     QMIXConfig, SACConfig, TD3Config)
    from ray_tpu_torch.rllib.alphazero import AlphaZeroLearner
    from ray_tpu_torch.rllib.dqn import DQNLearner
    from ray_tpu_torch.rllib.maddpg import MADDPGConfig, MADDPGLearner
    from ray_tpu_torch.rllib.rainbow import RainbowConfig, RainbowLearner
    from ray_tpu_torch.rllib.sac import SACLearner
    from ray_tpu_torch.rllib.ddpg import TD3Learner
    for make in (lambda: DQNLearner(DQNConfig(), 4, 2),
                 lambda: RainbowLearner(RainbowConfig(), 4, 2),
                 lambda: TD3Learner(TD3Config(), 3, 1),
                 lambda: SACLearner(SACConfig(), 3, 1),
                 lambda: MADDPGLearner(MADDPGConfig(), 2, 4, 1),
                 lambda: AlphaZeroLearner(AlphaZeroConfig()),
                 lambda: CQLConfig(input_path="data.jsonl").build(),
                 lambda: CRRConfig(input_path="data.jsonl").build(),
                 lambda: DTConfig(input_path="data.jsonl").build(),
                 lambda: QMIXConfig().build(),
                 lambda: DreamerV3Config().build()):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    from ray_tpu_torch import data
    from ray_tpu_torch.util.collective import init_collective_group
    with pytest.raises(RuntimeError, match="CUDA"):
        next(data.range(4).iter_device_batches(batch_size=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        init_collective_group(1, 0, backend="nccl", group_name="card")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_collective_group(1, 0, backend="xla", group_name="card")


def test_cuda_wrappers_refuse_other_devices():
    """A tensor that is on neither the CPU nor a CUDA device is refused,
    never sent to the plain version."""
    q, k_pool, v_pool, tables, lengths = (
        torch.from_numpy(a).to("meta") for a in _inputs(8, 4))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tpa.paged_decode_attention_batch(q, k_pool, v_pool, tables, lengths)
    assert tpa.launch_counts["paged_decode_attention_batch"] == 0
