"""The port's data layer against the JAX package's: bitwise.

The generators are verbatim numpy copies and the padding is the same
numpy indexing, so every array must equal the reference's exactly.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401

from repro.data import batching as jbatch
from repro.data import leaf_like as jleaf
from repro.data import synthetic as jsyn
from repro_torch.core import pytree as pt
from repro_torch.data import batching, leaf_like, synthetic


def _assert_devices_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("alpha,beta,iid", [(1, 1, False),
                                            (0.5, 0.5, False),
                                            (0, 0, True)])
def test_synthetic_arrays_bitwise(alpha, beta, iid):
    kw = dict(iid=iid, num_devices=6, seed=3)
    _assert_devices_equal(synthetic.generate_synthetic(alpha, beta, **kw),
                          jsyn.generate_synthetic(alpha, beta, **kw))


def test_femnist_like_arrays_bitwise():
    _assert_devices_equal(leaf_like.generate_femnist_like(5, seed=1),
                          jleaf.generate_femnist_like(5, seed=1))


@pytest.mark.parametrize("n,bucket", [(7, True), (45, True), (45, False),
                                      (160, True)])
def test_pad_to_batches_bitwise(n, bucket):
    rng = np.random.default_rng(n)
    arrays = {"x": rng.normal(size=(n, 6)).astype(np.float32),
              "y": rng.integers(0, 3, n).astype(np.int32)}
    got = batching.pad_to_batches(arrays, 10, bucket, device="cpu")
    want = jbatch.pad_to_batches(arrays, 10, bucket)
    for k in arrays:
        assert got[k].dtype == torch.from_numpy(arrays[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.fixture(scope="module")
def datasets():
    dev = synthetic.generate_synthetic(0.5, 0.5, num_devices=8, seed=2)
    return (batching.FederatedData(dev, 10, device="cpu", eval_sample=5,
                                   eval_seed=4),
            jbatch.FederatedData(dev, 10, eval_sample=5, eval_seed=4))


def test_federated_data_matches_reference(datasets):
    tds, jds = datasets
    assert tds.weights == jds.weights
    assert tds.stats() == jds.stats()
    np.testing.assert_array_equal(tds.eval_ids(), jds.eval_ids())
    for (tw, tb), (jw, jb) in zip(tds.eval_batches(), jds.eval_batches()):
        assert tw == jw
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


@pytest.mark.parametrize("sel", [[0, 3, 5], [1, 2, 6, 7], [4, 4, 0]])
def test_stack_device_batches_bitwise(datasets, sel):
    tds, jds = datasets
    tb, tv = batching.stack_device_batches(tds, np.array(sel))
    jb, jv = jbatch.stack_device_batches(jds, np.array(sel))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert tv.dtype == torch.float32
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


def test_padded_cache_prefix_consistency(datasets):
    tds, _ = datasets
    big = tds.device_batches_padded(0, 64)
    small = tds.device_batches_padded(0, 16)
    for a, b in zip(pt.leaves(small), pt.leaves(big)):
        assert torch.equal(a, b[:16])
    with pytest.raises(ValueError, match="drop"):
        batching.pad_batch_stack(tds.device_batches(7), 0)


def test_batches_live_on_the_dataset_device(datasets):
    tds, _ = datasets
    for k in range(tds.num_devices):
        for leaf in pt.leaves(tds.device_batches(k)):
            assert leaf.device == tds.device == torch.device("cpu")


def test_num_batches_of_matches_reference(datasets):
    tds, jds = datasets
    for k in range(tds.num_devices):
        assert batching.num_batches_of(tds.device_batches(k)) == \
            jax.tree_util.tree_leaves(jds.device_batches(k))[0].shape[0]


def test_sent140_like_arrays_bitwise():
    _assert_devices_equal(leaf_like.generate_sent140_like(40, seed=1),
                          jleaf.generate_sent140_like(40, seed=1))


def test_shakespeare_like_arrays_bitwise():
    _assert_devices_equal(
        leaf_like.generate_shakespeare_like(10, seed=1, sample_cap=64),
        jleaf.generate_shakespeare_like(10, seed=1, sample_cap=64))


def test_leaf_like_constants_match_reference():
    for name in ("FEMNIST_CLASSES", "FEMNIST_DIM", "SENT_VOCAB", "SENT_SEQ",
                 "SHAKES_VOCAB", "SHAKES_SEQ"):
        assert getattr(leaf_like, name) == getattr(jleaf, name)


@pytest.mark.parametrize("make", ["make_femnist_like", "make_sent140_like",
                                  "make_shakespeare_like"])
def test_leaf_like_datasets_match_reference(make):
    kw = dict(num_devices=6, seed=2)
    if make == "make_shakespeare_like":
        kw["sample_cap"] = 64
    tds = getattr(leaf_like, make)(device="cpu", **kw)
    jds = getattr(jleaf, make)(**kw)
    assert tds.name == jds.name
    assert tds.stats() == jds.stats() and tds.weights == jds.weights
    for k in range(tds.num_devices):
        tb, jb = tds.device_batches(k), jds.device_batches(k)
        assert tb.keys() == jb.keys()
        for key in jb:
            assert str(tb[key].dtype).split(".")[-1] == str(jb[key].dtype)
            np.testing.assert_array_equal(tb[key].numpy(),
                                          np.asarray(jb[key]))


def test_paper_synthetic_suite_matches_reference():
    tsuite = synthetic.paper_synthetic_suite(seed=1, device="cpu")
    jsuite = jsyn.paper_synthetic_suite(seed=1)
    assert [d.name for d in tsuite] == [d.name for d in jsuite]
    for tds, jds in zip(tsuite, jsuite):
        assert tds.stats() == jds.stats() and tds.weights == jds.weights
        for k in (0, tds.num_devices - 1):
            for key in ("x", "y"):
                np.testing.assert_array_equal(
                    tds.device_batches(k)[key].numpy(),
                    np.asarray(jds.device_batches(k)[key]))
