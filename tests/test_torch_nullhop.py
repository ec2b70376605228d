"""The slice end to end on the CPU: RoShamBo at full width through the
port's NullHopExecutor, held against the reference's RoShamBoCNN.apply and
NullHopExecutor.run_frame on the same params and frames; the copied runtime
arbitrates like the reference's."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.qos as jqos
import repro.core.runtime as jruntime
import repro.core.transfer as jtransfer
from repro.accel.nullhop import NullHopExecutor as JNullHopExecutor
from repro.accel.roshambo import RoShamBoCNN as JRoShamBoCNN
import repro_torch.core.qos as tqos
import repro_torch.core.runtime as truntime
import repro_torch.core.transfer as ttransfer
from repro_torch.accel.nullhop import NullHopExecutor
from repro_torch.accel.roshambo import RoShamBoCNN, maxpool2, params_from_jax
from repro_torch.configs import roshambo as roshambo_configs

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def slice_inputs():
    jcnn = JRoShamBoCNN()
    jparams = jcnn.init(jax.random.PRNGKey(1))
    params_np = jax.tree_util.tree_map(np.asarray, jparams)
    frame = np.random.default_rng(1).standard_normal(
        (1, 64, 64, 1)).astype(np.float32)
    ref = np.asarray(jcnn.apply(jparams, jnp.asarray(frame)))
    return jcnn, jparams, params_from_jax(params_np, "cpu"), frame, ref


def _policies(mod):
    return [mod.TransferPolicy.user_level_polling(),
            mod.TransferPolicy(mod.Management.INTERRUPT, mod.Buffering.DOUBLE,
                               mod.Partitioning.BLOCKS, block_bytes=1 << 14)]


def test_params_from_jax_keeps_layout(slice_inputs):
    _, jparams, params, _, _ = slice_inputs
    for name, layer in jparams.items():
        for k, v in layer.items():
            assert tuple(params[name][k].shape) == tuple(v.shape)
            np.testing.assert_array_equal(params[name][k].numpy(),
                                          np.asarray(v))


def test_apply_matches_reference(slice_inputs):
    _, _, params, frame, ref = slice_inputs
    got = RoShamBoCNN().apply(params, torch.from_numpy(frame)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("i", [0, 1], ids=["polling-single-unique",
                                            "interrupt-double-blocks"])
def test_nullhop_frame_matches_reference(slice_inputs, i):
    jcnn, jparams, params, frame, ref = slice_inputs
    ex = NullHopExecutor(RoShamBoCNN(), _policies(ttransfer)[i], device="cpu")
    jex = JNullHopExecutor(jcnn, _policies(jtransfer)[i])
    try:
        for _ in range(2):  # second frame: cached layouts, copy-free pack
            res = ex.run_frame(params, frame)
        jres = jex.run_frame(jparams, frame)
    finally:
        ex.close()
        jex.close()
    np.testing.assert_allclose(res.logits, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(res.logits, jres.logits, rtol=1e-4, atol=1e-4)
    assert len(res.timing.layers) == 5
    assert [l.name for l in res.timing.layers] == \
        [l.name for l in jres.timing.layers]
    assert [(l.tx_bytes, l.rx_bytes) for l in res.timing.layers] == \
        [(l.tx_bytes, l.rx_bytes) for l in jres.timing.layers]
    np.testing.assert_allclose(res.sparsity, jres.sparsity, rtol=0, atol=1e-6)
    assert res.policy_tag == jres.policy_tag
    assert res.timing.frame_s > 0


def test_layer_transfer_bytes_match_reference(slice_inputs):
    jcnn, jparams, params, _, _ = slice_inputs
    assert RoShamBoCNN().layer_transfer_bytes(params, batch=3) == \
        jcnn.layer_transfer_bytes(jparams, batch=3)


def test_staged_frames_skip_the_pack_copy(slice_inputs):
    _, _, params, frame, _ = slice_inputs
    ex = NullHopExecutor(RoShamBoCNN(), _policies(ttransfer)[1], device="cpu")
    try:
        for _ in range(3):
            ex.run_frame(params, frame)
        layouts = list(ex.engine.layouts._layouts.values())
    finally:
        ex.close()
    assert len(layouts) == 5
    assert all(l.copy_count == 1 and l.pack_count == 3 for l in layouts)


def test_maxpool_drops_odd_edge():
    x = torch.arange(2 * 5 * 5 * 3, dtype=torch.float32).reshape(2, 5, 5, 3)
    from repro.accel.roshambo import maxpool2 as jmaxpool2
    np.testing.assert_array_equal(maxpool2(x).numpy(),
                                  np.asarray(jmaxpool2(jnp.asarray(x.numpy()))))


def test_configs_match_reference():
    from repro.configs import roshambo as jconfigs
    for mine, ref in ((roshambo_configs.config(), jconfigs.config()),
                      (roshambo_configs.smoke_config(),
                       jconfigs.smoke_config())):
        assert (mine.input_hw, mine.n_classes, mine.dtype) == \
            (ref.input_hw, ref.n_classes, ref.dtype)
        assert [vars(s) for s in mine.layers] == [vars(s) for s in ref.layers]


def _arbitration_order(runtime, qos, transfer) -> list:
    """tests/test_tenancy.py's contended workload: one busy worker, four
    BULK then two TOKEN descriptors queued; returns completion order."""
    P = runtime.PriorityClass
    classes = {P.TOKEN: runtime.ClassQos(weight=8.0, deadline_s=10.0),
               P.BULK: runtime.ClassQos(weight=1.0, deadline_s=10.0)}
    log: list = []
    with runtime.TransferRuntime(workers=1, qos=classes) as rt:
        kw = {"device": "cpu"} if transfer is ttransfer else {}
        eng = transfer.TransferEngine(transfer.TransferPolicy.kernel_level(),
                                      runtime=rt, priority=P.LAYER, **kw)
        gate, started = threading.Event(), threading.Event()
        h = rt.register("gate", P.LAYER)
        transfer.Ticket(*h.submit(lambda: (started.set(), gate.wait())[0]))
        assert started.wait(5.0)
        big, small = np.ones(1 << 18, np.uint8), np.ones(64, np.uint8)
        tickets = []
        for cls, arr, n in ((P.BULK, big, 4), (P.TOKEN, small, 2)):
            for i in range(n):
                tickets.append(eng.tx_async(
                    arr, callback=lambda r, c=cls.name, i=i: log.append((c, i)),
                    qos=qos.QosSpec(priority=cls)))
        gate.set()
        for t in tickets:
            t.wait(10.0)
        eng.close()
    return log


def test_runtime_dispatch_order_matches_reference():
    ref = _arbitration_order(jruntime, jqos, jtransfer)
    got = _arbitration_order(truntime, tqos, ttransfer)
    assert len(got) == 6 and got == ref


def test_init_is_seeded_and_shaped():
    cnn = RoShamBoCNN()
    a = cnn.init(torch.Generator().manual_seed(3), device="cpu")
    b = cnn.init(torch.Generator().manual_seed(3), device="cpu")
    ref = JRoShamBoCNN().init(jax.random.PRNGKey(0))
    for name, layer in ref.items():
        for k, v in layer.items():
            assert tuple(a[name][k].shape) == tuple(v.shape)
            assert torch.equal(a[name][k], b[name][k])
