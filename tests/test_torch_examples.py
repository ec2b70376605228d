"""The port's ``repro_torch.examples.transfer_modes`` against the
reference's ``examples/transfer_modes.py`` (loaded from its path), on the
CPU:

- the Table-I rows' names and policies, field by field;
- with the reference's ``PRNGKey(0)`` params carried over
  (``accel/roshambo.py:params_from_jax``), each policy's logits within 1e-4
  of the reference ``NullHopExecutor``'s on the same frame, and the
  per-layer sparsity equal to 1e-6;
- the fault demo's ledger, quarantines and injected events equal the
  reference's (read from its printed lines);
- the unified-runtime demo's TOKEN class and ``demo`` tenant counts equal
  the reference's (51 completions / 1632 bytes, 50 / 1600).

Times are printed by both and held by neither.
"""

import ast
import contextlib
import dataclasses
import enum
import importlib.util
import io
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.accel.nullhop import NullHopExecutor as JNullHopExecutor
from repro_torch.accel.roshambo import params_from_jax
from repro_torch.examples import transfer_modes as tm

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def ref():
    spec = importlib.util.spec_from_file_location(
        "reference_transfer_modes", ROOT / "examples" / "transfer_modes.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ported(ref):
    """The port's ``main`` on the CPU, its ``RoShamBoCNN.init`` giving the
    reference's ``PRNGKey(0)`` params, beside those params and frame."""
    jcnn = ref.RoShamBoCNN()
    jparams = jcnn.init(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm.RoShamBoCNN, "init", lambda self, gen, device: params)
        out = tm.main(["--device", "cpu"])
    frame = np.random.default_rng(0).standard_normal(
        (1, 64, 64, 1)).astype(np.float32)
    return out, jcnn, jparams, frame


def _fields(policy) -> dict:
    return {f.name: (v.value if isinstance(v, enum.Enum) else v)
            for f in dataclasses.fields(policy)
            for v in [getattr(policy, f.name)]}


def test_policies_match_reference(ref):
    assert [n for n, _ in tm.POLICIES] == [n for n, _ in ref.POLICIES]
    for (_, got), (_, want) in zip(tm.POLICIES, ref.POLICIES):
        assert _fields(got) == _fields(want)


def test_table_i_logits_and_sparsity_match_reference(ref, ported):
    out, jcnn, jparams, frame = ported
    rows = out["table_i"]["rows"]
    assert [r["mode"] for r in rows] == [n for n, _ in tm.POLICIES]
    for row, (_, policy), (_, jpolicy) in zip(rows, tm.POLICIES,
                                              ref.POLICIES):
        assert row["policy"] == policy.tag == jpolicy.tag
        assert all(np.isfinite(row[k]) for k in (
            "tx_us_per_B", "rx_us_per_B", "frame_ms"))
        jex = JNullHopExecutor(jcnn, jpolicy)
        try:
            jres = jex.run_frame(jparams, frame)
        finally:
            jex.close()
        np.testing.assert_allclose(row["logits"], jres.logits, rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_allclose(out["table_i"]["sparsity"], jres.sparsity,
                               rtol=0, atol=1e-6)


def _printed(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


def _after(text: str, prefix: str):
    line = next(ln for ln in text.splitlines() if prefix in ln)
    return line.split(prefix, 1)[1].strip()


def test_fault_demo_matches_reference(ref, ported):
    text = _printed(ref.demo_fault_injection)
    got = ported[0]["faults"]
    assert got["ledger"] == ast.literal_eval(_after(text, "fault ledger:"))
    assert got["events"] == ast.literal_eval(
        _after(text, "injected events:"))
    assert got["quarantined_after_tx"] == ast.literal_eval(
        _after(text, "quarantined=").split(" (")[0]) == [0]
    assert got["quarantined_after_probe"] == []
    assert got["ledger"]["faults"] == got["ledger"]["retries"] == \
        got["ledger"]["retry_successes"] == 2


def test_token_class_and_tenant_counts_match_reference(ref, ported):
    text = _printed(ref.demo_unified_runtime)
    token = _after(text, "token   n=").split()
    tenant = _after(text, "token tenant 'demo': n=").split()
    got = ported[0]["unified"]
    assert got["classes"]["token"] == {
        "completed": int(token[0]), "bytes_total": int(token[1][6:])} == {
        "completed": 51, "bytes_total": 1632}
    assert got["tenant_demo"] == {
        "completed": int(tenant[0]), "bytes_total": int(tenant[1][6:])} == {
        "completed": 50, "bytes_total": 1600}
    assert set(got["submit_ms"]) == {"polling", "scheduled", "interrupt"}


def test_coalescing_demo_runs_on_the_cpu(ported):
    got = ported[0]["coalescing"]
    assert got["wakeups_saved"] + got["bulk_wakeups"] == 64
    assert got["singles_us_per_desc"] > 0 and got["batched_us_per_desc"] > 0
    assert got["rx_bitwise"]
