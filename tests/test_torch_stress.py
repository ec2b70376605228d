"""The reference's five concurrency stress hammers on the port's transfer
stack, on the CPU, under validated locks (``repro_torch.analysis.stress``
holds the bodies; ``tests/test_torch_cuda.py`` runs the same bodies on the
card). Each test builds its own runtime, engines and groups after
``validated.enable(True)``, so every lock they take is order-validating;
a lock-order inversion or an unheld ``# requires-lock:`` fails it. The
counters a hammer leaves (bytes and descriptors per engine, tenant and
class) are held against the reference stack's after the same traffic on
one thread: they do not depend on the interleaving.

    PYTHONPATH=src python -m pytest tests/test_torch_stress.py
"""

import threading

import pytest
import torch

from repro.core import adaptive as jadaptive
from repro.core import channels as jchannels
from repro.core import cost_model as jcost_model
from repro.core import faults as jfaults
from repro.core import qos as jqos
from repro.core import runtime as jruntime
from repro.core import transfer as jtransfer
from repro_torch.analysis import stress
from repro_torch.analysis.validated import ValidatedLock
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import TransferEngine, TransferPolicy

torch.set_num_threads(1)

REFERENCE = stress.Stack(jruntime, jtransfer, jqos, jfaults, jchannels,
                         jadaptive, jcost_model)


@pytest.fixture
def order_graph():
    with stress.validated_locks() as graph:
        yield graph
    assert graph.violations == []


def _hold(hammer, graph):
    got = hammer(stress.port_stack("cpu"))
    assert graph.violations == []
    assert graph.edges(), "no lock was taken under another: not validated"
    want = hammer(REFERENCE, concurrent=False)
    assert got.counters == want.counters
    assert (got.transfers, got.bytes) == (want.transfers, want.bytes)
    return got


@pytest.mark.stress
def test_stress_four_classes_on_one_runtime(order_graph):
    got = _hold(stress.four_classes, order_graph)
    assert got.extra["background_runs"] > 0


@pytest.mark.stress
def test_stress_coalescing_four_class_hammer(order_graph):
    got = _hold(stress.coalescing, order_graph)
    assert got.extra["bulk_wakeups_saved"] > 0


@pytest.mark.stress
def test_chaos_hammer_exact_byte_accounting_under_qos_load(order_graph):
    got = _hold(stress.chaos, order_graph)
    assert got.extra["faults"] > 0


@pytest.mark.stress
def test_stress_multi_tenant_hammer_exact_byte_accounting(order_graph):
    _hold(stress.tenants, order_graph)


@pytest.mark.stress
def test_stress_mid_run_plan_swap(order_graph):
    got = _hold(stress.plan_swap, order_graph)
    assert got.extra["swaps"] >= 1


@pytest.mark.stress
def test_hammer_locks_are_validated_only_inside_the_block():
    """Locks made inside ``validated_locks`` validate their order; locks
    made before it (the process-shared runtime's) stay plain."""
    before = TransferRuntime(workers=1)
    try:
        with stress.validated_locks() as graph:
            rt = TransferRuntime(workers=1)
            eng = TransferEngine(TransferPolicy.kernel_level_ring(2),
                                 device="cpu", runtime=rt)
            try:
                assert isinstance(eng._ring_lock, ValidatedLock)
                assert isinstance(rt._cond._lock, ValidatedLock)
                assert not isinstance(before._cond._lock, ValidatedLock)
                eng.rx(eng.tx(torch.arange(64.0).numpy()))
            finally:
                eng.close()
                rt.close()
        assert graph.violations == []
    finally:
        before.close()
    assert not isinstance(threading.Lock(), ValidatedLock)


@pytest.mark.stress
def test_hammer_thread_error_fails_the_hammer():
    """A thread's error is raised from the hammer, not lost on its thread."""
    def boom():
        raise ValueError("boom")

    with pytest.raises(stress.HammerError, match="1 hammer thread"):
        stress._run([boom, lambda: None], True)
