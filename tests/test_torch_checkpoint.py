"""The port's checkpoints (ray_tpu_torch/train/checkpoint.py, on
torch.distributed.checkpoint) against the JAX package's (orbax), on the
CPU: the manager's names and kept set, dict checkpoints and metrics,
trees restored without a template, and a TrainState saved, restored
into a fresh state and stepped, bitwise the uninterrupted run."""

import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from ray_tpu.train import checkpoint as jck  # noqa: E402
from ray_tpu_torch.models import TINY, cross_entropy_loss  # noqa: E402
from ray_tpu_torch.train import (adamw, init_train_state,  # noqa: E402
                                 make_train_step)
from ray_tpu_torch.train import checkpoint as tck  # noqa: E402


@pytest.mark.parametrize("num_to_keep", [None, 1, 2])
def test_manager_keeps_what_jax_keeps(tmp_path, num_to_keep):
    """The same saves under both managers: the same checkpoint names, the
    same kept set and the same latest payload and metrics."""
    ours = tck.CheckpointManager(str(tmp_path / "torch"), num_to_keep)
    ref = jck.CheckpointManager(str(tmp_path / "jax"), num_to_keep)
    for i in range(4):
        tree = {"v": np.array([i]), "w": np.full((2, 3), i, np.float32)}
        ours.save(tree, metrics={"i": i})
        ref.save(tree, metrics={"i": i})
        assert [os.path.basename(c.path) for c in ours.list()] == \
            [os.path.basename(c.path) for c in ref.list()]
    got, want = ours.latest(), ref.latest()
    assert got.metrics() == want.metrics() == {"i": 3}
    for k, v in want.to_pytree().items():
        np.testing.assert_array_equal(got.to_pytree()[k].numpy(),
                                      np.asarray(v))
    assert repr(got).startswith("Checkpoint(") and \
        got.as_directory() == got.path


def test_from_dict_and_metrics_match_jax(tmp_path):
    data = {"w": np.arange(4.0), "b": np.ones((2, 3), np.float32)}
    ours = tck.Checkpoint.from_dict(data, str(tmp_path / "torch"))
    ref = jck.Checkpoint.from_dict(data, str(tmp_path / "jax"))
    got, want = ours.to_dict(), ref.to_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.from_numpy(np.asarray(want[k])).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert ours.metrics() == ref.metrics() == {}
    ck = tck.Checkpoint.from_pytree(data, str(tmp_path / "m"),
                                    metrics={"loss": 0.5})
    assert tck.Checkpoint.from_directory(ck.path).metrics() == {"loss": 0.5}
    assert os.path.isdir(tck.Checkpoint.from_pytree(data).path)


def test_restore_without_template_rebuilds_the_tree(tmp_path):
    """From the checkpoint's own metadata: CPU tensors (numpy arrays
    become tensors) and Python scalars, dicts and lists (a tuple comes
    back as a list), bf16 bitwise."""
    bf = torch.randn(3, 5, generator=torch.Generator().manual_seed(0)) \
        .to(torch.bfloat16)
    tree = {"a": {"x": bf, "n": 7, "s": "name"},
            "l": [np.arange(3, dtype=np.int32), 2.5, (torch.ones(2), 1)]}
    tck.save_pytree(tree, str(tmp_path / "t"))
    got = tck.restore_pytree(str(tmp_path / "t"))
    assert torch.equal(got["a"]["x"], bf) and got["a"]["x"].dtype == \
        torch.bfloat16
    assert got["a"]["n"] == 7 and got["a"]["s"] == "name"
    assert got["l"][0].dtype == torch.int32 and \
        got["l"][0].tolist() == [0, 1, 2]
    assert got["l"][1] == 2.5
    assert isinstance(got["l"][2], list) and got["l"][2][1] == 1
    tck.save_pytree([torch.zeros(2), 3], str(tmp_path / "root"))
    root = tck.restore_pytree(str(tmp_path / "root"))
    assert isinstance(root, list) and root[1] == 3


def test_plain_template_places_and_checks(tmp_path):
    """A plain template restores whole and is placed as its leaves are;
    a mismatch of keys or shapes raises, it is never passed over."""
    tree = {"w": np.arange(4.0, dtype=np.float32), "t": torch.ones(2, 2)}
    tck.save_pytree(tree, str(tmp_path / "t"))
    got = tck.restore_pytree(str(tmp_path / "t"), tree)
    assert isinstance(got["w"], np.ndarray) and \
        got["w"].tolist() == [0, 1, 2, 3]
    assert torch.is_tensor(got["t"]) and torch.equal(got["t"], tree["t"])
    with pytest.raises(ValueError, match="keys"):
        tck.restore_pytree(str(tmp_path / "t"), {"w": tree["w"]})
    with pytest.raises(ValueError, match="shape"):
        tck.restore_pytree(str(tmp_path / "t"),
                           {"w": np.zeros(5), "t": tree["t"]})


def _run(cfg, seed: int):
    return init_train_state(cfg, adamw(1e-2, weight_decay=0.01), seed=seed,
                            device="cpu")


def test_train_state_restored_and_stepped_is_bitwise(tmp_path):
    """Run A: 4 steps, saved after steps 1-3 under num_to_keep=2. Run B:
    step 2's checkpoint restored into a state drawn from another seed,
    then steps 3 and 4: losses, parameters and AdamW's moments and step
    counts bitwise run A's."""
    cfg = dataclasses.replace(TINY, dtype=torch.float32, n_layers=2)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 33)))
    batch = (data[:, :-1], data[:, 1:])
    step = make_train_step(lambda m, b: cross_entropy_loss(m(b[0]), b[1]))
    mgr = tck.CheckpointManager(str(tmp_path), num_to_keep=2)
    a, losses_a = _run(cfg, 0), []
    for i in range(4):
        a, m = step(a, batch)
        losses_a.append(m["loss"].item())
        if i < 3:
            mgr.save(a, metrics={"step": a.step})
        if i == 2:
            after3 = {n: p.detach().clone()
                      for n, p in a.model.named_parameters()}
    kept = mgr.list()
    assert [os.path.basename(c.path) for c in kept] == \
        ["checkpoint_000002", "checkpoint_000003"]
    assert kept[0].metrics() == {"step": 2}
    b = _run(cfg, 1)
    assert kept[0].to_pytree(b) is b and b.step == 2
    losses_b = []
    for _ in range(2):
        b, m = step(b, batch)
        losses_b.append(m["loss"].item())
    assert losses_b == losses_a[2:] and b.step == a.step == 4
    pa, pb = dict(a.model.named_parameters()), dict(b.model.named_parameters())
    assert all(torch.equal(pa[n], pb[n]) for n in pa)
    sa, sb = a.optimizer.state_dict()["state"], \
        b.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        assert all(torch.equal(sa[i][k], sb[i][k]) for k in sa[i])
    whole = kept[1].to_pytree()
    assert whole["step"] == 3 and set(whole) == {"model", "optim", "step"}
    assert all(torch.equal(whole["model"][n], t) for n, t in after3.items())


def test_train_state_of_another_model_raises(tmp_path):
    """A template with parameters the checkpoint lacks raises DCP's
    missing-key error."""
    from torch.distributed.checkpoint.api import CheckpointException

    cfg = dataclasses.replace(TINY, dtype=torch.float32, n_layers=2)
    tck.save_pytree(_run(cfg, 0), str(tmp_path / "s"))
    other = _run(dataclasses.replace(cfg, n_layers=3), 0)
    with pytest.raises(CheckpointException, match="Missing key"):
        tck.restore_pytree(str(tmp_path / "s"), other)
