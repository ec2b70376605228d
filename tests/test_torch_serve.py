"""Serving on the CPU: the port's ServingEngine on the same params and
prompts as the reference's gives the same greedy tokens under polling and
interrupt management, over a channel group, a calibrated one and an
online-adapted one."""

import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as jsmoke_config
from repro.core.qos import QosSpec as JQosSpec
from repro.core.transfer import TransferPolicy as JTransferPolicy
from repro.models.api import build_model as jbuild_model
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch.configs.registry import smoke_config
from repro_torch.core.qos import QosSpec
from repro_torch.core.transfer import Management, TransferPolicy
from repro_torch.launch import serve as launch_serve
from repro_torch.models.api import build_model
from repro_torch.models.lm import params_from_jax
from repro_torch.serve.engine import ServeConfig, ServingEngine

# the suite runs in several worker processes on one host: one intra-op
# thread each keeps torch from oversubscribing the cores that the
# timing-sensitive reference tests share
torch.set_num_threads(1)

POLICIES = {
    "polling": TransferPolicy.user_level_polling,
    "scheduled": TransferPolicy.user_level_scheduled,
    "interrupt": TransferPolicy.kernel_level,
    "interrupt-ring": TransferPolicy.kernel_level_ring,
}

@pytest.fixture(scope="module")
def lm_pair():
    cfg = jsmoke_config("qwen2.5-3b").replace(dtype="float32")
    jm = jbuild_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    m = build_model(smoke_config("qwen2.5-3b").replace(dtype="float32"))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (3, 8)).astype(np.int32)
    return jm, jp, m, tp, prompts


@pytest.fixture(scope="module")
def ref_tokens(lm_pair):
    jm, jp, _, _, prompts = lm_pair
    eng = JServingEngine(jm, jp, JServeConfig(max_seq=64))
    try:
        return np.stack([r.tokens for r in eng.generate(prompts, 10)])
    finally:
        eng.close()


@pytest.mark.parametrize("policy", list(POLICIES))
def test_greedy_tokens_match_reference(lm_pair, ref_tokens, policy):
    _, _, m, tp, prompts = lm_pair
    eng = ServingEngine(m, tp, ServeConfig(max_seq=64),
                        policy=POLICIES[policy]())
    try:
        assert eng.device.type == "cpu" and eng.engine.device.type == "cpu"
        res = eng.generate(prompts, 10)
        again = eng.generate(prompts, 10)
    finally:
        eng.close()
    got = np.stack([r.tokens for r in res])
    np.testing.assert_array_equal(got, ref_tokens)
    np.testing.assert_array_equal(np.stack([r.tokens for r in again]), got)
    assert all(r.prefill_s > 0 and r.decode_s > 0 for r in res)
    np.testing.assert_array_equal(res[1].prompt, prompts[1])


@pytest.mark.parametrize("rx_group", [1, 4])
def test_interrupt_token_rx_grouping_matches_reference(lm_pair, rx_group):
    """rx_group 1 submits one rx_async a step; 4 flushes rx_many groups
    (and a short last group): both land the reference's tokens."""
    jm, jp, m, tp, prompts = lm_pair
    jeng = JServingEngine(jm, jp, JServeConfig(
        max_seq=64, qos=JQosSpec(rx_group=rx_group)),
        policy=JTransferPolicy.kernel_level())
    eng = ServingEngine(m, tp, ServeConfig(
        max_seq=64, qos=QosSpec(rx_group=rx_group)))
    try:
        assert eng.policy.management is Management.INTERRUPT
        ref = [r.tokens for r in jeng.generate(prompts, 7)]
        got = [r.tokens for r in eng.generate(prompts, 7)]
        rx = eng.engine.rx_count
    finally:
        jeng.close()
        eng.close()
    np.testing.assert_array_equal(np.stack(got), np.stack(ref))
    # one RX record per rx_async; per rx_many group (tokens 0-3, 4-6)
    assert rx == (7 if rx_group == 1 else 2)


def test_prompt_tx_and_token_rx_are_measured(lm_pair):
    _, _, m, tp, prompts = lm_pair
    eng = ServingEngine(m, tp, ServeConfig(max_seq=64),
                        policy=TransferPolicy.user_level_polling())
    try:
        eng.generate(prompts, 5)
        assert eng.engine.tx_bytes_total == prompts.nbytes
        assert eng.engine.rx_bytes_total == 5 * prompts.shape[0] * 4
        assert eng.engine.tx_count == 1 and eng.engine.rx_count == 5
    finally:
        eng.close()


def test_side_inputs_ride_one_scatter_gather_slot(lm_pair, ref_tokens):
    # the dense model ignores side inputs; they still ride the prompt's
    # scatter-gather descriptor under INTERRUPT management
    _, _, m, tp, prompts = lm_pair
    eng = ServingEngine(m, tp, ServeConfig(max_seq=64))
    try:
        extra = {"patch_embeds": np.ones((3, 2, 4), np.float32)}
        batch = eng._tx_prompts(prompts, extra)
        assert set(batch) == {"tokens", "patch_embeds"}
        np.testing.assert_array_equal(batch["tokens"].numpy(), prompts)
        np.testing.assert_array_equal(batch["patch_embeds"].numpy(),
                                      extra["patch_embeds"])
        res = eng.generate(prompts, 10, extra_inputs=extra)
    finally:
        eng.close()
    np.testing.assert_array_equal(np.stack([r.tokens for r in res]),
                                  ref_tokens)


@pytest.mark.parametrize("kw", [{"n_channels": 2},
                                {"adaptive_transfer": True},
                                {"online_adaptation": True}])
def test_transfer_settings_match_reference(lm_pair, kw):
    """Striped, calibrated and online-adapted token transfer: the
    reference's greedy tokens under the same ServeConfig, and the same
    fault ledger."""
    jm, jp, m, tp, prompts = lm_pair
    jeng = JServingEngine(jm, jp, JServeConfig(max_seq=64, **kw))
    eng = ServingEngine(m, tp, ServeConfig(max_seq=64, **kw))
    try:
        assert eng.engine.device.type == "cpu"
        assert type(eng.engine).__name__ == type(jeng.engine).__name__
        ref = np.stack([r.tokens for r in jeng.generate(prompts, 6)])
        got = np.stack([r.tokens for r in eng.generate(prompts, 6)])
        assert eng.fault_summary() == jeng.fault_summary()
    finally:
        jeng.close()
        eng.close()
    np.testing.assert_array_equal(got, ref)


def test_summaries_match_reference_shape(lm_pair):
    jm, jp, m, tp, prompts = lm_pair
    jeng = JServingEngine(jm, jp, JServeConfig(max_seq=64))
    eng = ServingEngine(m, tp, ServeConfig(max_seq=64))
    try:
        eng.generate(prompts, 3)
        jeng.generate(prompts, 3)
        assert eng.fault_summary() == jeng.fault_summary()
        ours, ref = eng.admission_summary(), jeng.admission_summary()
        assert set(ours) == set(ref) and ours["accepts"] == ref["accepts"]
    finally:
        jeng.close()
        eng.close()


def test_deprecated_serve_knobs_warn_and_fold_in():
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        cfg = ServeConfig(rx_group=2)
    assert any(issubclass(w.category, DeprecationWarning) for w in seen)
    assert cfg.rx_group == 2


def test_sampling_with_temperature_is_seeded(lm_pair):
    _, _, m, tp, prompts = lm_pair
    runs = []
    for _ in range(2):
        eng = ServingEngine(m, tp, ServeConfig(max_seq=64, temperature=0.8,
                                               seed=3))
        try:
            runs.append(np.stack([r.tokens for r in eng.generate(prompts, 6)]))
        finally:
            eng.close()
    np.testing.assert_array_equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < m.cfg.vocab)).all()


def test_launch_serve_cli_on_the_cpu(capsys):
    res = launch_serve.main(["--device", "cpu", "--batch", "2",
                             "--prompt-len", "8", "--new-tokens", "4"])
    assert len(res) == 2 and res[0].tokens.shape == (4,)
    assert "req1: prefill=" in capsys.readouterr().out
