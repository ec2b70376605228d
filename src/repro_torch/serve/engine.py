"""Batched serving engine: prefill + decode, token traffic through a
:class:`~repro_torch.core.transfer.TransferEngine` or a group of them.

Request flow (the paper's accelerator serves frames streamed by the PS; here
the card serves prompts streamed by the host):

- the prompt batch goes host -> device as a measured TX;
- the engine prefills the decode cache (K/V, or the SSM state of the
  ssm and hybrid families) and decodes steps for the whole batch;
- each decoded token comes back device -> host as an RX. Under INTERRUPT
  management the RX of step t overlaps decode step t+1: a token's RX is
  submitted from the thread that sampled it, and the engine's D2H stream
  first waits on that thread's current stream (where the sampling ran), so
  a token is never copied before it exists.

The port runs prefill and decode eagerly (no ``jit``) and updates the
decode cache in place (the reference donates it to the jitted decode
step); the engine never looks inside the cache the model returns.

``ServeConfig(n_channels > 1)`` stripes the token traffic over a
:class:`~repro_torch.core.channels.ChannelGroup`; ``adaptive_transfer``
calibrates the link and builds the group the fitted cost model plans;
``online_adaptation`` keeps refitting that plan from live traffic through an
:class:`~repro_torch.core.adaptive.AdaptiveChannelGroup`, warm-started from
``transfer_state_path``. Every channel is on the serving device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core.adaptive import AdaptiveChannelGroup, AdaptiveConfig
from repro_torch.core.channels import ChannelGroup
from repro_torch.core.qos import (
    AdmissionController,
    AdmissionError,
    AdmissionPolicy,
    QosSpec,
    warn_deprecated_kwarg,
)
from repro_torch.core.runtime import PriorityClass
from repro_torch.core.transfer import (
    Management,
    TransferEngine,
    TransferPolicy,
    reassemble_chunks,
)
from repro_torch.models.api import Model


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 256
    temperature: float = 0.0  # 0 => greedy
    eos_token: int = -1  # -1 => run to max_new_tokens
    seed: int = 0
    # >1: stripe prompt TX across a ChannelGroup (with adaptive_transfer it
    # is the planner's channel CEILING; 1 there means "planner's choice")
    n_channels: int = 1
    adaptive_transfer: bool = False  # calibrate + fit policy at construction
    # keep refitting the fitted policy from live traffic and swap plans at
    # safe points (implies adaptive_transfer's construction-time calibration)
    online_adaptation: bool = False
    # warm-start persistence: with online_adaptation, load the first plan
    # from this file when it exists and save the fitted state on close()
    # — a restarted server skips the calibration sweep.
    transfer_state_path: str | None = None
    # DEPRECATED: class_caps / rx_timeout_s / rx_group now live on ``qos``
    # (QosSpec.class_caps / .timeout_s / .rx_group). Setting them away from
    # their defaults still works for one release — each folds into the
    # engine's base QosSpec and warns.
    class_caps: "dict[str, float] | None" = None
    rx_timeout_s: float | None = 60.0
    rx_group: int = 8
    # the engine's base submit context: per-class bandwidth ceilings, the
    # decoded-token RX liveness bound (timeout_s; None = unbounded waits),
    # the token-RX batching factor (rx_group; 1 = one rx_async per step),
    # plus tenant / weight / per-tenant cap defaults for every transfer
    # this engine submits. Per-call generate(qos=...) merges over it.
    qos: QosSpec | None = None
    # admission thresholds (tenant queue depth / deadline-miss rate) the
    # engine sheds on; None = default AdmissionPolicy.
    admission: AdmissionPolicy | None = None

    def __post_init__(self) -> None:
        if self.class_caps is not None:
            warn_deprecated_kwarg("ServeConfig(class_caps=...)",
                                  "ServeConfig(qos=QosSpec(class_caps=...))")
        if self.rx_timeout_s != 60.0:
            warn_deprecated_kwarg("ServeConfig(rx_timeout_s=...)",
                                  "ServeConfig(qos=QosSpec(timeout_s=...))")
        if self.rx_group != 8:
            warn_deprecated_kwarg("ServeConfig(rx_group=...)",
                                  "ServeConfig(qos=QosSpec(rx_group=...))")


def transfer_fault_summary(transfer) -> dict[str, Any]:
    """The fault ledger of a transfer surface: a group's or adaptive
    facade's own, or a bare engine's checksum failures with the recovery
    columns zeroed (no sibling channel to retry on)."""
    f = getattr(transfer, "fault_summary", None)
    if f is not None:
        return f()
    s = transfer.summary()
    csf = int(s.get("checksum_failures", 0))
    return {"faults": {"faults": csf, "timeouts": 0,
                       "checksum_failures": csf,
                       "retries": 0, "retry_successes": 0,
                       "quarantines": 0, "unquarantines": 0,
                       "faults_by_channel": {}},
            "quarantined": []}


@dataclass
class RequestResult:
    prompt: np.ndarray
    tokens: np.ndarray
    prefill_s: float
    decode_s: float

    @property
    def tokens_per_s(self) -> float:
        n = len(self.tokens)
        return n / self.decode_s if self.decode_s > 0 else float("inf")


class ServingEngine:
    """Serves ``model`` with ``params`` on the params' device (or
    ``device``, when given): the card unless the caller put the params on
    the CPU or names it."""

    def __init__(self, model: Model, params: Any, cfg: ServeConfig,
                 policy: TransferPolicy | None = None,
                 device: "torch.device | str | None" = None):
        self.model = model
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device if device is not None
                                   else params["embed"].device)
        # the engine's base submit context: legacy ServeConfig knobs fold
        # in first (they already warned at ServeConfig construction), then
        # cfg.qos overrides field-wise.
        self.qos = QosSpec(
            timeout_s=cfg.rx_timeout_s,
            rx_group=cfg.rx_group,
            class_caps=cfg.class_caps,
        ).merged(cfg.qos)
        if cfg.adaptive_transfer or cfg.online_adaptation:
            if policy is not None:
                raise ValueError(
                    "adaptive_transfer fits the policy from calibration; "
                    "passing an explicit policy alongside it would be "
                    "silently ignored — choose one")
            # fit the policy to THIS host and card: calibrate, then size
            # block / ring depth / channel count for the prompt-batch
            # payload. The default n_channels=1 leaves the count to the
            # planner (up to 4).
            prompt_bytes = cfg.max_batch * cfg.max_seq * 4  # int32 tokens
            max_ch = cfg.n_channels if cfg.n_channels > 1 else 4
            if cfg.online_adaptation:
                # construction-time calibration PLUS rolling refit from live
                # token/prompt traffic, plans swapped between requests (safe
                # points); a state_path warm-starts the first plan from the
                # last session's fit.
                self.engine = AdaptiveChannelGroup(
                    prompt_bytes, cfg=AdaptiveConfig(max_channels=max_ch),
                    devices=[self.device], priority=PriorityClass.TOKEN,
                    state_path=cfg.transfer_state_path)
            else:
                self.engine = ChannelGroup.auto(prompt_bytes,
                                                max_channels=max_ch,
                                                devices=[self.device])
            self.policy = self.engine.policy
        elif cfg.n_channels > 1:
            self.policy = policy or TransferPolicy.kernel_level_ring()
            self.engine = ChannelGroup(
                self.policy, n_channels=cfg.n_channels,
                devices=[self.device] * cfg.n_channels)
        else:
            self.policy = policy or TransferPolicy.kernel_level()
            self.engine = TransferEngine(self.policy, device=self.device)
        if self.qos.class_caps:
            for name, bps in self.qos.class_caps.items():
                self.engine.set_class_cap(PriorityClass(name), bps)
        # admission guards the TOKEN class (where decode-loop RXs queue):
        # runtime is read lazily — engines register with the shared runtime
        # on first submit, not at construction.
        self.admission = AdmissionController(
            runtime=lambda: self.engine.runtime,
            policy=cfg.admission, cls=PriorityClass.TOKEN)
        # sampling with temperature > 0 draws from this generator, so its
        # tokens differ from the reference's (greedy ones do not)
        self._gen = torch.Generator(self.device).manual_seed(cfg.seed)
        # decoded-token landing zone, reused across generate() calls: each
        # step's RX writes row t in place (rx out=), so the steady state
        # detokenize path allocates nothing per token.
        self._tok_buf = np.empty((0, 0), np.int32)

    def close(self) -> None:
        self.engine.close()

    def fault_summary(self) -> dict[str, Any]:
        """Fault / recovery rates of the transfer surface behind this
        engine: deadline misses (timeouts), stripe retries + successes,
        checksum failures, quarantine transitions. Channel groups and
        adaptive facades report their shared ledger; a bare engine reports
        its own checksum failures with the recovery columns zeroed (no
        sibling channel to retry on)."""
        return transfer_fault_summary(self.engine)

    def admission_summary(self) -> dict[str, Any]:
        """Accept/queue/shed counts of this engine's admission valve,
        with per-tenant rows for tenants that were ever queued or shed."""
        return self.admission.summary()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        logits = logits[:, -1, : self.model.cfg.vocab]
        if self.cfg.temperature <= 0:
            return logits.argmax(-1)[:, None].to(torch.int32)
        probs = torch.softmax(logits / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen).to(
            torch.int32)

    def _tx_prompts(self, prompts: np.ndarray,
                    extra_inputs: dict | None = None,
                    qos: QosSpec | None = None) -> dict:
        """Stage the prompt batch (and any side inputs) through the transfer
        engine as the prefill batch dict. With side inputs on an INTERRUPT
        engine, prompts + extras ride ONE scatter-gather ring slot."""
        arr = np.ascontiguousarray(prompts, dtype=np.int32)
        extra = {k: np.ascontiguousarray(v)
                 for k, v in (extra_inputs or {}).items()}
        if extra and self.engine.policy.management is Management.INTERRUPT:
            keys = sorted(extra)
            devs = self.engine.tx_sg([arr] + [extra[k] for k in keys],
                                     qos=qos).wait()
            batch = {"tokens": devs[0].reshape(arr.shape)}
            batch.update(dict(zip(keys, devs[1:])))
            return batch
        batch = {"tokens": reassemble_chunks(
            self.engine.tx(arr, qos=qos)).reshape(arr.shape)}
        batch.update({k: torch.as_tensor(v, device=self.device)
                      for k, v in extra.items()})
        return batch

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 extra_inputs: dict | None = None, *,
                 qos: QosSpec | None = None) -> list[RequestResult]:
        """prompts: [B, S_prompt] int32 (already padded/batched).

        ``qos`` merges over the engine's base spec. Admission runs first: a
        shed request raises :class:`AdmissionError`. NOT reentrant: one
        generate() at a time per ServingEngine (the sampling generator, the
        decode cache and the reused token matrix are engine state)."""
        spec = self.qos.merged(qos)
        tok_spec = QosSpec(priority=PriorityClass.TOKEN).merged(spec)
        decision = self.admission.decide(spec.effective_tenant,
                                         cls=tok_spec.priority)
        if not decision.admitted:
            raise AdmissionError(decision)
        b = prompts.shape[0]
        max_new_tokens = max(1, max_new_tokens)  # prefill always emits one
        batch = self._tx_prompts(prompts, extra_inputs, qos=spec)
        overlap_rx = self.engine.policy.management is Management.INTERRUPT
        model, params, s_max = self.model, self.params, self.cfg.max_seq

        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, s_max)
        tok = self._sample(logits)
        self._sync()
        prefill_s = time.perf_counter() - t0

        if self._tok_buf.shape != (max_new_tokens, b):
            self._tok_buf = np.empty((max_new_tokens, b), np.int32)

        t0 = time.perf_counter()
        if overlap_rx:
            # token t streams back on a completion worker while step t+1
            # decodes, landing in its reused row of _tok_buf. With
            # rx_group > 1 the pending tokens flush as ONE rx_many ring
            # transaction per group; tokens stay on the device until then
            # (decode reads them there).
            group = max(1, int(spec.rx_group or 1))
            batched = group > 1
            tickets: list = []
            pend_toks: list = [tok]
            pend_rows: list = [self._tok_buf[0]]

            def flush() -> None:
                if batched and len(pend_toks) > 1:
                    tickets.extend(self.engine.rx_many(
                        list(pend_toks), out=list(pend_rows), qos=tok_spec))
                else:
                    tickets.extend(self.engine.rx_async(
                        [p], out=[r], qos=tok_spec)
                        for p, r in zip(pend_toks, pend_rows))
                pend_toks.clear()
                pend_rows.clear()

            if not batched:
                flush()  # per-step submission: overlap every RX
            for step in range(max_new_tokens - 1):
                logits, cache = model.decode(params, tok, cache)
                tok = self._sample(logits)
                pend_toks.append(tok)
                pend_rows.append(self._tok_buf[step + 1])
                if not batched or len(pend_toks) >= group:
                    flush()
            if pend_toks:
                flush()
            for t in tickets:
                t.wait(spec.timeout_s)
        else:
            for step in range(max_new_tokens):
                if step:
                    logits, cache = model.decode(params, tok, cache)
                    tok = self._sample(logits)
                self.engine.rx([tok], out=[self._tok_buf[step]],
                               qos=tok_spec)
        toks = self._tok_buf.T
        decode_s = time.perf_counter() - t0
        self.engine.maybe_adapt()  # request boundary: a safe point

        # one copy per REQUEST: results must outlive the reused _tok_buf
        return [RequestResult(prompts[i], toks[i].copy(), prefill_s, decode_s)
                for i in range(b)]
