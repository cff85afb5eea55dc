"""The elastic gang on the card (ray_tpu_torch/train's elastic path):
tests/test_torch_elastic.py's tiny Llama gang, 2 -> 1 -> 2, at tiny
depth on one card, its losses bitwise an uninterrupted run of the same
steps in this process. Every test here needs a CUDA device and skips
without one. The file imports neither jax nor ray_tpu:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_elastic.py

A fake multi-node cluster (ray_tpu_torch.cluster_utils) whose gang nodes
carry a `trainer` resource and see the one card; the gang runs on gloo
(two NCCL ranks cannot share a card), every rank on the same batch, so
the gang's mean gradient is one rank's, exactly. The loop runs each
epoch's steps and waits at its kept step's boundary for the resize the
test drives; a grown rank is seeded from rank 0 by the ipc route.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda

PLAN = {0: 2, 1: 4, 2: 6}       # each epoch's last step
STEPS = PLAN[2] + 1


def _tiny_cfg():
    from ray_tpu_torch.models import llama as tl

    return tl.LlamaConfig(vocab_size=128, d_model=64, n_layers=2, n_heads=4,
                          n_kv_heads=2, d_ff=128, max_seq_len=256,
                          dtype=torch.float32, attention="flash",
                          remat=False)


def _batch(cfg, device):
    g = torch.Generator().manual_seed(0)
    tok = torch.randint(0, cfg.vocab_size, (2, 33), generator=g)
    return tok[:, :-1].to(device), tok[:, 1:].to(device)


def test_elastic_gang_on_the_card_2_1_2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.models import cross_entropy_loss, init_params
    from ray_tpu_torch.test_utils import NodePreempter, wait_for_condition
    from ray_tpu_torch.train import (ElasticConfig, ScalingConfig,
                                     TorchTrainer, adamw, init_train_state,
                                     make_train_step)

    cfg = _tiny_cfg()
    weights = init_params(cfg, seed=0, device="cpu")
    state = init_train_state(cfg, adamw(3e-4, weight_decay=0.01),
                             {k: v.cuda() for k, v in weights.items()})
    step = make_train_step(
        lambda m, b: cross_entropy_loss(m(b[0]), b[1]))
    batch = _batch(cfg, "cuda")
    want = [step(state, batch)[1]["loss"].item() for _ in range(STEPS)]
    del state

    def loop(config):
        import time as _t

        import torch as _torch

        from ray_tpu_torch.models import cross_entropy_loss as _ce
        from ray_tpu_torch.train import adamw as _adamw
        from ray_tpu_torch.train import init_train_state as _init
        from ray_tpu_torch.train import session

        c = config["cfg"]
        epoch = session.get_elastic_epoch()
        kept = session.get_elastic_state()
        start = kept if kept is not None else \
            session.get_peer_states().get(0)
        opt = _adamw(3e-4, weight_decay=0.01)
        if start is None:
            st = _init(c, opt, {k: v.cuda() for k, v in
                                session.get_broadcast_weights().items()})
            first = 0
        else:
            st = _init(c, opt, dict(start["params"]))
            st.optimizer.load_state_dict(start["opt"])
            first = start["step"] + 1
        g = _torch.Generator().manual_seed(0)
        tok = _torch.randint(0, c.vocab_size, (2, 33), generator=g)
        inp, tgt = tok[:, :-1].cuda(), tok[:, 1:].cuda()
        tree = None
        for s in range(first, config["plan"][epoch] + 1):
            st.optimizer.zero_grad(set_to_none=True)
            loss = _ce(st.model(inp), tgt)
            loss.backward()
            session.allreduce_gradients(
                {n: p.grad for n, p in st.model.named_parameters()})
            st.optimizer.step()
            session.report({"step": s, "loss": loss.item(),
                            "world": session.get_world_size()})
            tree = {"step": s, "params": {n: p.detach() for n, p in
                                          st.model.named_parameters()},
                    "opt": st.optimizer.state_dict()}
            session.keep_state(tree, step=s)
        if epoch < 2:
            while True:
                _t.sleep(0.05)
                session.keep_state(tree, step=config["plan"][epoch])

    cluster = Cluster(initialize_head=True, connect=True)
    try:
        gang = [cluster.add_node(num_cpus=4, resources={"trainer": 1})
                for _ in range(2)]
        cluster.wait_for_nodes()
        trainer = TorchTrainer(
            loop, train_loop_config={"cfg": cfg, "plan": PLAN},
            scaling_config=ScalingConfig(
                num_workers=2, use_gpu=True,
                resources_per_worker={"trainer": 1},
                elastic=ElasticConfig(min_workers=1, max_workers=2)),
            collective_backend="gloo", initial_weights=weights)
        holder = {}

        def fit():
            try:
                holder["result"] = trainer.fit()
            except BaseException as e:  # noqa: BLE001
                holder["error"] = e

        th = threading.Thread(target=fit, daemon=True)
        th.start()
        wait_for_condition(
            lambda: trainer.latest_metrics.get("step") == PLAN[0],
            timeout=300)
        # Either gang node may hold rank 1: the run is the same
        # whichever rank leaves.
        victim = gang[1]
        drain = NodePreempter(cluster, deadline_s=10).preempt(victim,
                                                              kill=False)
        assert drain["state"] == "DRAINED"
        wait_for_condition(
            lambda: trainer.telemetry["shrinks"] == 1
            and trainer.latest_metrics.get("step") == PLAN[1], timeout=300)
        cluster.remove_node(victim)
        cluster.add_node(num_cpus=4, resources={"trainer": 1})
        th.join(300)
        assert not th.is_alive() and "error" not in holder, holder
        hist = holder["result"].metrics_history
        assert [h["step"] for h in hist] == list(range(STEPS))
        assert [h["loss"] for h in hist] == want
        assert [h["world"] for h in hist] == \
            [2] * (PLAN[0] + 1) + [1] * (PLAN[1] - PLAN[0]) + \
            [2] * (PLAN[2] - PLAN[1])
        t = trainer.telemetry
        assert (t["shrinks"], t["grows"], t["elastic_fallbacks"],
                t["full_restarts"]) == (1, 1, 0, 0)
        seed = [h for r in t["resize_log"] for h in r["handoffs"]
                if "new rank" in h["what"]]
        # The tensors by ipc (AdamW's step counts are CPU tensors: host).
        assert seed and seed[0]["routes"]["ipc"] > 0
    finally:
        cluster.shutdown()
