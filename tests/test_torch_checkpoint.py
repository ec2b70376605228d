"""The port's checkpoints on the CPU: the reference's format (one .npz a
step keyed by tree paths, bf16 widened to f32, the manifest, GC, the
atomic rename), so each package restores the other's checkpoints, and
the async manager's snapshot, which must not alias the live tensors that
the next step updates in place."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
from repro.checkpoint import checkpoint as jckpt
from repro.models.api import build_model as jbuild_model
from repro.optim import adamw_init as jadamw_init
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint import (
    CheckpointManager,
    restore_latest,
    save_checkpoint,
)
from repro_torch.models import lm
from repro_torch.optim import adamw_init
from repro_torch.utils import pytree

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)


def _np32(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _assert_trees_equal(port_tree, ref_tree):
    """Exact: a checkpoint stores every value (bf16 widened exactly)."""
    got = list(pytree.tree_paths(port_tree))
    want = [(tuple(getattr(k, "key", getattr(k, "idx", k)) for k in p), v)
            for p, v in jax.tree_util.tree_flatten_with_path(ref_tree)[0]]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert str(g.dtype).split(".")[-1] == str(w.dtype)
        assert tuple(g.shape) == tuple(w.shape)
        np.testing.assert_array_equal(_np32(g), _np32(w))


def _state(arch):
    """A reference train state of a smoke model: params (the hybrid's
    ``groups`` is a list) in bf16 and the AdamW state (int32 step)."""
    cfg = jregistry.smoke_config(arch).replace(dtype="bfloat16")
    params = jbuild_model(cfg).init(jax.random.PRNGKey(0))
    opt = jadamw_init(params)
    opt["step"] = jnp.asarray(5, jnp.int32)
    opt["m"] = jax.tree_util.tree_map(lambda x: x + 0.25, opt["m"])
    return {"params": params, "opt": opt}


def _port(state):
    return pytree.tree_map(
        lambda a: lm._to_tensor(np.asarray(a), "cpu"), state)


def _zeros_like_port(state):
    return pytree.tree_map(torch.zeros_like, _port(state))


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, arch):
    state = _state(arch)
    jckpt.save_checkpoint(str(tmp_path), 5, state)
    step, tree = restore_latest(str(tmp_path), _zeros_like_port(state))
    assert step == 5
    _assert_trees_equal(tree, state)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-1.2b"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, arch):
    state = _state(arch)
    save_checkpoint(str(tmp_path), 5, _port(state))
    template = jax.tree_util.tree_map(jnp.zeros_like, state)
    step, tree = jckpt.restore_latest(str(tmp_path), template)
    assert step == 5
    _assert_trees_equal(_port(tree), state)


def test_port_files_match_the_reference_files(tmp_path):
    """The same state gives the same keys, dtypes and values in both
    packages' .npz files, and the same manifest entries."""
    state = _state("zamba2-1.2b")
    jckpt.save_checkpoint(str(tmp_path / "ref"), 3, state)
    save_checkpoint(str(tmp_path / "port"), 3, _port(state))
    with np.load(tmp_path / "ref" / "step-00000003.npz") as a, \
            np.load(tmp_path / "port" / "step-00000003.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert "params/groups/1/mixer/in_proj" in b.files


def test_checkpoint_roundtrip_bf16(tmp_path):
    state = {"params": {"w": torch.ones((4, 4), dtype=torch.bfloat16) * 1.5,
                        "b": torch.arange(3, dtype=torch.float32)},
             "step": torch.tensor(7)}
    save_checkpoint(str(tmp_path), 7, state)
    step, tree = restore_latest(str(tmp_path), state)
    assert step == 7
    assert tree["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["params"]["w"].float().numpy(),
                                  np.full((4, 4), 1.5))
    assert int(tree["step"]) == 7


def test_checkpoint_gc_keeps_n_and_leaves_no_tmp(tmp_path):
    state = {"x": torch.zeros(2)}
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(str(tmp_path), s, state, keep=2)
    files = sorted(os.listdir(tmp_path))
    assert [f for f in files if f.endswith(".npz")] == [
        "step-00000004.npz", "step-00000005.npz"]
    assert not [f for f in files if f.startswith(".tmp")]
    assert restore_latest(str(tmp_path), state)[0] == 5
    assert restore_latest(str(tmp_path / "none"), state) is None


def test_manager_async_snapshot_does_not_alias_the_live_state(tmp_path):
    """The async write happens after maybe_save returns, while the next
    step updates the params in place: the file holds the values at the
    save."""
    mgr = CheckpointManager(str(tmp_path), every=2, async_write=True)
    params = {"w": torch.arange(4, dtype=torch.float32)}
    state = {"params": params, "opt": adamw_init(params)}
    try:
        assert not mgr.maybe_save(1, state)
        assert mgr.maybe_save(2, state)
        params["w"].add_(100.0)  # the next step, in place
        state["opt"]["master"]["w"].mul_(-1.0)
    finally:
        mgr.wait()
    step, tree = mgr.restore_latest(
        pytree.tree_map(torch.zeros_like, state))
    assert step == 2
    np.testing.assert_array_equal(tree["params"]["w"].numpy(),
                                  np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(tree["opt"]["master"]["w"].numpy(),
                                  np.arange(4, dtype=np.float32))


def test_manager_sync_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=3, async_write=False)
    try:
        assert mgr.maybe_save(3, {"x": torch.ones(2)})
        assert not mgr.maybe_save(0, {"x": torch.ones(2)})
    finally:
        mgr.wait()
    assert os.path.exists(tmp_path / "step-00000003.npz")


def test_flatten_keys_are_the_reference_paths():
    tree = {"b": [torch.zeros(1), {"c": torch.zeros(2)}], "a": torch.ones(1)}
    jtree = {"b": [np.zeros(1), {"c": np.zeros(2)}], "a": np.ones(1)}
    assert sorted(ckpt._flatten(tree)) == sorted(jckpt._flatten(jtree))
