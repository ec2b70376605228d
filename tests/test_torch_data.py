"""The port's data pipeline on the CPU: ``SyntheticLMSource`` bitwise the
reference's host batches for every family, and ``StagedPipeline`` under
the three managements, with and without a transfer engine, delivering
those batches unchanged (held against the reference's pipeline)."""

import numpy as np
import pytest
import torch

import repro.configs.registry as jregistry
from repro.core.transfer import TransferPolicy as JTransferPolicy
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import StagedPipeline as JStagedPipeline
from repro.data.pipeline import SyntheticLMSource as JSyntheticLMSource
import repro_torch.configs.registry as registry
from repro_torch.core.channels import ChannelGroup
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.data.pipeline import (
    DataConfig,
    StagedPipeline,
    SyntheticLMSource,
)

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

FAMILIES = ["qwen2.5-3b", "granite-moe-1b-a400m", "mamba2-780m",
            "zamba2-1.2b", "pixtral-12b", "seamless-m4t-medium"]
POLICIES = ["user_level_polling", "user_level_scheduled", "kernel_level"]


def _sources(arch, batch=4, seq=40, seed=7):
    jsrc = JSyntheticLMSource(JDataConfig(batch, seq, seed),
                              jregistry.smoke_config(arch))
    src = SyntheticLMSource(DataConfig(batch, seq, seed),
                            registry.smoke_config(arch))
    return jsrc, src


@pytest.mark.parametrize("arch", FAMILIES)
def test_source_is_bitwise_the_reference(arch):
    """Exact: the same numpy draws in the same order."""
    jsrc, src = _sources(arch)
    for step in (0, 1, 5):
        want, got = jsrc.next_host_batch(step), src.next_host_batch(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_labels_are_shifted_tokens():
    _, src = _sources("qwen2.5-3b", batch=2, seq=8)
    b = src.next_host_batch(0)
    np.testing.assert_array_equal(b["labels"][:, :-1], b["tokens"][:, 1:])


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "pixtral-12b"])
def test_pipeline_modes_deliver_the_reference_batches(policy, arch):
    """All three managements deliver the reference pipeline's batches,
    exactly, with their dtypes, on the pipeline's device."""
    jsrc, src = _sources(arch)
    jpipe = JStagedPipeline(jsrc, getattr(JTransferPolicy, policy)())
    pipe = StagedPipeline(src, getattr(TransferPolicy, policy)(),
                          device="cpu")
    try:
        for _ in range(3):
            want, got = next(jpipe), next(pipe)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
        assert pipe.step == 3
    finally:
        jpipe.close()
        pipe.close()


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("transport", ["engine", "group"])
def test_pipeline_through_an_engine_delivers_the_host_batches(policy,
                                                              transport):
    """Batches staged through a TransferEngine or a ChannelGroup (cached
    layout, measured TX, striping) equal the host batches, and the layout
    is built once and reused."""
    _, src = _sources("mamba2-780m")
    eng = (TransferEngine(TransferPolicy.kernel_level(), device="cpu")
           if transport == "engine" else
           ChannelGroup(TransferPolicy.kernel_level_ring(2), n_channels=2,
                        devices=["cpu", "cpu"], min_stripe_bytes=1 << 8))
    pipe = StagedPipeline(src, getattr(TransferPolicy, policy)(), engine=eng)
    try:
        batches = [next(pipe) for _ in range(3)]
    finally:
        pipe.close()
    want = SyntheticLMSource(DataConfig(4, 40, 7),
                             registry.smoke_config("mamba2-780m"))
    for i, b in enumerate(batches):
        ref = want.next_host_batch(i)
        for k in ref:
            np.testing.assert_array_equal(b[k].numpy(), ref[k])
    # the prefetch thread may have staged a batch or two beyond the three
    assert eng.layouts.misses == 1 and eng.layouts.hits >= 2
    eng.close()


def test_pipeline_starts_at_start_step():
    _, src = _sources("qwen2.5-3b")
    pipe = StagedPipeline(src, TransferPolicy.kernel_level(), start_step=4,
                          device="cpu")
    try:
        got = next(pipe)
    finally:
        pipe.close()
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  src.next_host_batch(4)["tokens"])


def test_pipeline_with_shardings_raises(tmp_path):
    """``shardings=`` stages ``DTensor`` batches equal to the reference's
    ``jax.device_put(batch, shardings)`` ones (a gloo world of one, a
    (1, 1) mesh; the 4-rank shards are ``test_torch_dist.py``'s), and a
    plan with no mesh behind it raises."""
    import jax
    import torch.distributed as dist
    from jax.sharding import NamedSharding, PartitionSpec

    from repro_torch.dist.sharding import batch_sharding_tree
    from repro_torch.launch.mesh import make_local_mesh

    jsrc, src = _sources("qwen2.5-3b")
    plan = batch_sharding_tree(src.next_host_batch(0), {"data": 1, "model": 1})
    with pytest.raises(ValueError, match="meshes"):
        StagedPipeline(src, TransferPolicy.kernel_level(), shardings=plan,
                       device="cpu")
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jpipe = JStagedPipeline(jsrc, JTransferPolicy.user_level_polling(),
                            shardings={k: NamedSharding(jmesh, PartitionSpec())
                                       for k in ("tokens", "labels")})
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device_type="cpu")
        pipe = StagedPipeline(
            src, TransferPolicy.user_level_polling(), device="cpu",
            shardings=batch_sharding_tree(src.next_host_batch(0), mesh))
        try:
            for _ in range(2):
                want, got = next(jpipe), next(pipe)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert type(got[k]).__name__ == "DTensor"
                    np.testing.assert_array_equal(
                        got[k].full_tensor().numpy(), np.asarray(want[k]))
        finally:
            pipe.close()
            jpipe.close()
    finally:
        dist.destroy_process_group()


def test_prefetch_error_surfaces_at_next():
    """A staging error on the prefetch thread is raised by ``next``, not
    lost with the thread (the consumer would wait for ever)."""
    class Broken(SyntheticLMSource):
        def next_host_batch(self, step):
            raise RuntimeError("source failed")

    src = Broken(DataConfig(2, 8), registry.smoke_config("qwen2.5-3b"))
    pipe = StagedPipeline(src, TransferPolicy.kernel_level(), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="source failed"):
            next(pipe)
    finally:
        pipe.close()
    assert not pipe._thread.is_alive()


def test_close_stops_the_prefetch_thread():
    _, src = _sources("qwen2.5-3b")
    pipe = StagedPipeline(src, TransferPolicy.kernel_level_ring(3),
                          device="cpu")
    next(pipe)
    pipe.close()
    assert not pipe._thread.is_alive()
