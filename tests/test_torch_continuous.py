"""Continuous batching on the CPU: the port's ContinuousBatchingEngine
against the reference's on the same params (``params_from_jax``) and the
same requests (tokens, steps, completion order, the cache an idle slot
leaves past ``max_seq``), and the reference's own continuous-batching
tests mirrored on the port.

Every engine here moves its tokens through a transfer engine on a private
runtime: ``submit`` sheds a backlogged request when the runtime's TOKEN
class missed half its deadlines in the last 5 s, and the process-shared
runtime carries the misses of whatever ran before in this process."""

import contextlib
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.core.qos import AdmissionPolicy as JAdmissionPolicy
from repro.core.qos import QosSpec as JQosSpec
from repro.core.runtime import TransferRuntime as JTransferRuntime
from repro.core.transfer import TransferEngine as JTransferEngine
from repro.core.transfer import TransferPolicy as JTransferPolicy
from repro.models.api import build_model as jbuild_model
from repro.serve.continuous import ContinuousBatchingEngine as JEngine
from repro.serve.continuous import Request as JRequest
from repro_torch.configs.registry import smoke_config
from repro_torch.core.qos import AdmissionPolicy, QosSpec
from repro_torch.core.runtime import TransferRuntime
from repro_torch.core.transfer import TransferEngine, TransferPolicy
from repro_torch.examples import serve_lm
from repro_torch.models.api import build_model
from repro_torch.models.lm import params_from_jax
from repro_torch.serve import ContinuousBatchingEngine, Request
from repro_torch.serve.continuous import _splice_slot
from repro_torch.serve.engine import ServeConfig, ServingEngine

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

ARCHS = {"qwen": "qwen2.5-3b", "granite": "granite-moe-1b-a400m"}


def _pair(arch):
    """(reference model, reference params, port model, port params), f32."""
    jm = jbuild_model(jsmoke_config(arch).replace(dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(smoke_config(arch).replace(dtype="float32"))
    return jm, jp, m, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    return _pair(ARCHS[request.param])


@pytest.fixture(scope="module")
def qwen():
    return _pair(ARCHS["qwen"])


def _requests(vocab, specs, seed=0):
    """[(prompt, max_new_tokens)] from ``specs`` of (prompt length, new)."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, n).astype(np.int32), new)
            for n, new in specs]


# a few prompt lengths, so that the reference compiles few prefills; more
# requests than slots, ragged lengths and budgets
SPECS = [(9, 6), (14, 3), (9, 8), (14, 5), (9, 2)]


@contextlib.contextmanager
def _engine(engine_cls, model, params, policy="interrupt", **kw):
    """``engine_cls`` over a transfer engine of ``policy`` on a private
    runtime (the reference's or the port's, as ``engine_cls`` is)."""
    ref = engine_cls is JEngine
    rt = (JTransferRuntime if ref else TransferRuntime)(workers=2)
    make = (JTransferPolicy if ref else TransferPolicy)
    pol = (make.kernel_level() if policy == "interrupt"
           else make.user_level_polling())
    transfer = (JTransferEngine(pol, runtime=rt) if ref
                else TransferEngine(pol, device="cpu", runtime=rt))
    eng = engine_cls(model, params, transfer=transfer, **kw)
    try:
        yield eng
    finally:
        eng.close()
        transfer.close()
        rt.close()


def _serve(engine_cls, request_cls, model, params, reqs, **kw):
    with _engine(engine_cls, model, params, **kw) as eng:
        for i, (p, new) in enumerate(reqs):
            assert eng.submit(request_cls(rid=i, prompt=p,
                                          max_new_tokens=new)).admitted
        return eng, eng.run_to_completion()


@pytest.mark.parametrize("policy", ["interrupt", "polling"])
def test_tokens_steps_and_order_match_reference(pair, policy):
    jm, jp, m, tp = pair
    reqs = _requests(m.cfg.vocab, SPECS)
    jeng, jdone = _serve(JEngine, JRequest, jm, jp, reqs, n_slots=2,
                         max_seq=48, policy=policy)
    eng, done = _serve(ContinuousBatchingEngine, Request, m, tp, reqs,
                       n_slots=2, max_seq=48, policy=policy)
    assert len(done) == len(reqs)
    assert [r.rid for r in done] == [r.rid for r in jdone]
    assert [r.tokens for r in done] == [r.tokens for r in jdone]
    assert eng.steps == jeng.steps
    for d in ("tx", "rx"):
        assert (sum(s.direction == d for s in eng.transfer.stats)
                == sum(s.direction == d for s in jeng.transfer.stats))


def test_idle_slot_past_max_seq_drops_its_writes_as_the_reference(pair):
    """Every slot decodes every step: slot 0's request retires at once and
    its length keeps growing past max_seq while slot 1 decodes. Its writes
    there are dropped (no IndexError), and the cache, lengths and tokens
    equal the reference's."""
    jm, jp, m, tp = pair
    max_seq = 20
    reqs = _requests(m.cfg.vocab, [(14, 2), (4, 14)], seed=1)
    jeng, jdone = _serve(JEngine, JRequest, jm, jp, reqs, n_slots=2,
                         max_seq=max_seq)
    eng, done = _serve(ContinuousBatchingEngine, Request, m, tp, reqs,
                       n_slots=2, max_seq=max_seq)
    assert [r.tokens for r in done] == [r.tokens for r in jdone]
    lengths = eng.cache.length.numpy()
    np.testing.assert_array_equal(lengths, np.asarray(jeng.cache.length[0]))
    assert lengths[0] > max_seq + 1  # several writes past the end dropped
    np.testing.assert_allclose(eng.cache.k.numpy(),
                               np.asarray(jeng.cache.k), atol=1e-5)
    np.testing.assert_allclose(eng.cache.v.numpy(),
                               np.asarray(jeng.cache.v), atol=1e-5)


def test_per_slot_length_is_one_vector_for_every_layer(qwen):
    """The port keeps one [B] length tensor for all layers (the reference
    keeps [L, B], every row equal)."""
    jm, jp, m, tp = qwen
    reqs = _requests(m.cfg.vocab, [(9, 3), (14, 5), (9, 4)], seed=2)
    jeng, _ = _serve(JEngine, JRequest, jm, jp, reqs, n_slots=2, max_seq=32)
    eng, _ = _serve(ContinuousBatchingEngine, Request, m, tp, reqs,
                    n_slots=2, max_seq=32)
    ref = np.asarray(jeng.cache.length)
    assert ref.shape == (m.cfg.n_layers, 2) and (ref == ref[0]).all()
    assert tuple(eng.cache.length.shape) == (2,)
    np.testing.assert_array_equal(eng.cache.length.numpy(), ref[0])


def test_splice_slot_uses_the_batch_axis_when_slots_equal_layers(qwen):
    _, _, m, tp = qwen
    assert m.cfg.n_layers == 2
    batch = m.init_cache(2, 16, device="cpu")
    batch = batch._replace(length=torch.zeros(2, dtype=torch.int64))
    _, one = m.prefill(tp, {"tokens": torch.arange(5)[None]}, 16)
    _splice_slot(batch, one, 1)
    assert torch.equal(batch.k[:, 1], one.k[:, 0])
    assert torch.equal(batch.v[:, 1], one.v[:, 0])
    assert not batch.k[:, 0].any()
    assert batch.length.tolist() == [0, 5]


# ---- the reference's tests/test_continuous_batching.py, on the port ------

def test_continuous_matches_single_request(qwen):
    _, _, m, tp = qwen
    reqs = _requests(m.cfg.vocab, [(9, 6), (14, 6), (11, 6)])
    _, done = _serve(ContinuousBatchingEngine, Request, m, tp, reqs,
                     n_slots=2, max_seq=64)
    assert len(done) == 3
    for req in done:
        solo = ServingEngine(m, tp, ServeConfig(max_seq=64))
        try:
            res = solo.generate(req.prompt[None], max_new_tokens=6)
        finally:
            solo.close()
        np.testing.assert_array_equal(np.asarray(req.tokens), res[0].tokens)


def test_more_requests_than_slots_all_complete(qwen):
    _, _, m, tp = qwen
    reqs = _requests(m.cfg.vocab, [(8, 4)] * 5, seed=1)
    _, done = _serve(ContinuousBatchingEngine, Request, m, tp, reqs,
                     n_slots=2, max_seq=48)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3, 4]
    assert all(len(r.tokens) == 4 and r.done for r in done)


def test_run_to_completion_respects_max_steps(qwen):
    _, _, m, tp = qwen
    with _engine(ContinuousBatchingEngine, m, tp, n_slots=2,
                 max_seq=128) as eng:
        p, _ = _requests(m.cfg.vocab, [(8, 100)], seed=2)[0]
        eng.submit(Request(rid=0, prompt=p, max_new_tokens=100))
        eng.run_to_completion(max_steps=3)
        assert eng.steps == 3


def test_token_movement_rides_transfer_engine(qwen):
    """One TX an admitted prompt; one RX a decode step."""
    _, _, m, tp = qwen
    reqs = _requests(m.cfg.vocab, [(6, 3)], seed=3)
    eng, _ = _serve(ContinuousBatchingEngine, Request, m, tp, reqs,
                    n_slots=2, max_seq=64)
    assert eng.transfer.device.type == "cpu"
    assert sum(s.direction == "tx" for s in eng.transfer.stats) == 1
    assert sum(s.direction == "rx" for s in eng.transfer.stats) == 2


def test_submit_returns_the_reference_decisions(qwen):
    jm, jp, m, tp = qwen
    reqs = _requests(m.cfg.vocab, [(8, 3)] * 3)
    with _engine(JEngine, jm, jp, n_slots=2, max_seq=64,
                 admission=JAdmissionPolicy(queue_depth=1, shed_depth=2)
                 ) as jeng, _engine(
            ContinuousBatchingEngine, m, tp, n_slots=2, max_seq=64,
            admission=AdmissionPolicy(queue_depth=1, shed_depth=2)) as eng:
        got = [eng.submit(Request(rid=i, prompt=p, max_new_tokens=n,
                                  qos=QosSpec(tenant="flood")))
               for i, (p, n) in enumerate(reqs)]
        want = [jeng.submit(JRequest(rid=i, prompt=p, max_new_tokens=n,
                                     qos=JQosSpec(tenant="flood")))
                for i, (p, n) in enumerate(reqs)]
        assert [(d.action, d.admitted) for d in got] == [
            (d.action, d.admitted) for d in want] == [
            ("accept", True), ("queue", True), ("shed", False)]
        done = eng.run_to_completion()
        jdone = jeng.run_to_completion()
        assert [r.tokens for r in done] == [r.tokens for r in jdone]
        s, js = eng.admission_summary(), jeng.admission_summary()
        assert s["sheds"] == js["sheds"] == 1 and "flood" in s["by_tenant"]
        assert eng.fault_summary() == jeng.fault_summary()


def test_deprecated_kwargs_warn_and_fold_in(qwen):
    _, _, m, tp = qwen
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        eng = ContinuousBatchingEngine(m, tp, n_slots=2, max_seq=16,
                                       rx_timeout_s=5.0)
    eng.close()
    assert any(issubclass(w.category, DeprecationWarning) for w in seen)
    assert eng.qos.timeout_s == 5.0 == eng.rx_timeout_s


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_families_without_a_slot_cache_raise(arch):
    m = build_model(smoke_config(arch).replace(dtype="float32"))
    with pytest.raises(NotImplementedError, match="KV-cache families"):
        ContinuousBatchingEngine(m, {"embed": torch.zeros(1)}, n_slots=2)


def test_example_serve_lm_on_the_cpu(capsys):
    done = serve_lm.main(["--device", "cpu"])
    assert sorted(r.rid for r in done) == list(range(10))
    assert "served 10 requests" in capsys.readouterr().out
