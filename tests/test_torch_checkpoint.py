"""The port's checkpoint store against the JAX package's: one format.

A tree with dicts, a tuple, a list, Python scalars, None and float32 /
int32 arrays saved by either package loads bitwise in the other, and
both write the same bytes.  ``FederatedTrainer.run(checkpoint_dir=)``
saves at the rounds and under the file names of the reference's python
driver.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.checkpoint import store as jstore
from repro.configs.base import FederatedConfig as JConfig
from repro.core import FederatedTrainer as JTrainer
from repro.data import make_synthetic as j_make_synthetic
from repro.models.small import logreg_loss as j_logreg_loss
from repro_torch.checkpoint import (latest_checkpoint, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.core import pytree as pt
from repro_torch.data import make_synthetic
from repro_torch.models.small import logreg_loss


def _tree(rng):
    return {
        "params": {"w": rng.normal(size=(6, 3)).astype(np.float32),
                   "lstm": {"b": rng.normal(size=4).astype(np.float32)}},
        "ids": rng.integers(-5, 5, (2, 3)).astype(np.int32),
        "pair": (np.float32(1.5) * np.ones(2, np.float32), 7),
        "hist": [0.25, 3, "feddane", None, True],
        "round": 12, "lr": 0.01, "name": "x", "nothing": None,
    }


def _as_torch(tree):
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree)
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_as_torch(v) for v in tree)
    return tree


def _as_jax(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x) if isinstance(x, np.ndarray) else x, tree)


def _norm(tree, array_type=None):
    """A comparable form: arrays as (dtype, shape, bytes), containers
    with their types, scalars with theirs.  ``array_type``: the type
    every array must have."""
    if isinstance(tree, (torch.Tensor, np.ndarray, jax.Array)):
        if array_type is not None:
            assert isinstance(tree, array_type), type(tree)
        a = (tree.numpy() if isinstance(tree, torch.Tensor)
             else np.asarray(tree))
        return ("array", a.dtype.str, a.shape, a.tobytes())
    if isinstance(tree, dict):
        return {k: _norm(v, array_type) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return (type(tree), [_norm(v, array_type) for v in tree])
    return (type(tree), tree)


def _assert_same(got, want, array_type):
    assert _norm(got, array_type) == _norm(want)


def test_reference_saves_port_loads(tmp_path):
    tree = _tree(np.random.default_rng(0))
    path = jstore.save_checkpoint(str(tmp_path), _as_jax(tree), step=3)
    _assert_same(load_checkpoint(path, device="cpu"), tree, torch.Tensor)


def test_port_saves_reference_loads(tmp_path):
    tree = _tree(np.random.default_rng(1))
    path = save_checkpoint(str(tmp_path / "a.msgpack"), _as_torch(tree))
    _assert_same(jstore.load_checkpoint(path), tree, jax.Array)


def test_both_packages_write_the_same_bytes(tmp_path):
    tree = _tree(np.random.default_rng(2))
    a = save_checkpoint(str(tmp_path / "port"), _as_torch(tree), step=5)
    b = jstore.save_checkpoint(str(tmp_path / "ref"), _as_jax(tree), step=5)
    assert os.path.basename(a) == os.path.basename(b) == \
        "ckpt_00000005.msgpack"
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_latest_checkpoint(tmp_path):
    assert latest_checkpoint(str(tmp_path / "none")) is None
    tree = {"w": torch.ones(2)}
    save_checkpoint(str(tmp_path), tree, step=7)
    save_checkpoint(str(tmp_path), tree, step=12)
    save_checkpoint(str(tmp_path), tree, step=3)
    (tmp_path / "ckpt_99.tmp").write_text("")
    (tmp_path / "notes.msgpack").write_text("")
    assert latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "ckpt_00000012.msgpack")
    assert latest_checkpoint(str(tmp_path)) == jstore.latest_checkpoint(
        str(tmp_path))
    # no temporary file is left behind by a save
    assert sorted(os.listdir(tmp_path)) == [
        "ckpt_00000003.msgpack", "ckpt_00000007.msgpack",
        "ckpt_00000012.msgpack", "ckpt_99.tmp", "notes.msgpack"]


def test_unsupported_leaf_raises(tmp_path):
    with pytest.raises(TypeError, match="cannot checkpoint"):
        save_checkpoint(str(tmp_path / "x.msgpack"), {"f": object()})
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("chunk,rounds", [(2, 5), (0, 3), (4, 4)])
def test_run_saves_where_the_reference_does(tmp_path, chunk, rounds):
    """``run(checkpoint_dir=)``: ``{"params", "round"}`` every
    ``chunk_rounds`` rounds and after the last, under the reference's
    file names, with the reference's params (atol 1e-5)."""
    kw = dict(algorithm="feddane", mu=0.01, num_devices=5,
              devices_per_round=2, local_epochs=1, learning_rate=0.05,
              seed=3, chunk_rounds=chunk)
    zeros = {"w": np.zeros((60, 10), np.float32),
             "b": np.zeros(10, np.float32)}
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    JTrainer(j_logreg_loss, j_make_synthetic(1, 1, num_devices=5, seed=0),
             JConfig(round_driver="python", **kw)).run(
        jax.tree_util.tree_map(jnp.asarray, zeros), rounds,
        checkpoint_dir=str(jdir))
    FederatedTrainer(logreg_loss, make_synthetic(1, 1, num_devices=5,
                                                 seed=0, device="cpu"),
                     FederatedConfig(**kw), device="cpu").run(
        _as_torch(zeros), rounds, checkpoint_dir=str(tdir))
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert len(names) == len(set(list(range(chunk or rounds, rounds + 1,
                                            chunk or rounds)) + [rounds]))
    for n in names:
        got = load_checkpoint(str(tdir / n), device="cpu")
        want = jstore.load_checkpoint(str(jdir / n))
        assert got["round"] == want["round"] == int(n[5:13])
        for a, b in zip(pt.leaves(got["params"]),
                        jax.tree_util.tree_leaves(want["params"])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
