"""Continuous batching: slot-based decode with per-request admission.

The batched decode step never stops for stragglers: each of the B slots
holds an independent request; a finished slot is refilled by prefilling
the next queued prompt (batch 1) and splicing its KV cache into the slot.
This is the serving-side form of the paper's scheduled / interrupt modes:
the engine never blocks the whole batch on one request's completion, as
the driver never blocks the PS on one DMA.

Token movement rides the same :class:`~repro_torch.core.transfer.TransferEngine`
(or :class:`~repro_torch.core.channels.ChannelGroup`) as the rest of the
system: prompt admission is a measured TX, each decode step's token batch
a measured RX (``rx_async`` under INTERRUPT, so the device-to-host copy
overlaps the host's slot bookkeeping), with per-transfer stats in
``engine.stats``.

Serves the KV-cache families (dense / moe / vlm) and hybrid_moe, whose
cache holds its attention layers' K/V beside its Mamba2 layers' state
(``models.lm.HybridCache``). The port runs the model eagerly under
``torch.no_grad()`` (no ``jit``) and differs from the reference in two
ways:

- the per-slot length is ONE [B] int tensor on the device, shared by
  every layer (the port's cache has one length for all layers), not the
  reference's [L, B];
- ``_splice_slot`` copies a prefilled batch-1 cache into slot ``slot`` in
  place, along the stacked cache's explicit batch axis (1), where the
  reference guesses the axis from the shapes (the reference has no
  hybrid_moe family).

Every slot decodes every step, idle ones too, as in the reference: an idle
slot's length keeps growing, and its writes past ``max_seq`` are dropped
(``_cache_write``). Skipping idle slots would change the other requests'
tokens in the moe family, where an idle slot's token still takes an
expert seat.

While a ``torch.profiler`` records, a step is a ``serve.step`` span
holding ``serve.admit`` (``serve.admit.tx``, then for each admitted
request ``serve.prefill``, ``serve.first_token`` and ``serve.splice``
with its ``rid``), ``serve.decode``, ``serve.token_rx`` (the RX
submission until the last ticket returns) and ``serve.retire``; each
request marks ``serve.queue`` (submit to its slot) and ``serve.request``
(submit to done). See :mod:`repro_torch.utils.trace`.
"""

from __future__ import annotations

import collections
import time
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.qos import (
    AdmissionController,
    AdmissionDecision,
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
from repro_torch.models.layers.attention import KVCache
from repro_torch.models.lm import HybridCache
from repro_torch.serve.engine import transfer_fault_summary
from repro_torch.utils import trace


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S_prompt]
    max_new_tokens: int = 32
    tokens: list = field(default_factory=list)
    done: bool = False
    # submit context for this request's transfers (tenant, weight, caps);
    # merges over the engine's base qos. None = engine defaults.
    qos: QosSpec | None = None
    # when submit() queued it, on the tracer's clock (0 where no profiler
    # recorded then)
    t_submit_ns: int = field(default=0, repr=False, compare=False)


def _splice_slot(batch_cache: "KVCache | HybridCache",
                 one_cache: "KVCache | HybridCache", slot: int) -> None:
    """Copy a batch-1 stacked cache ([L, 1, S_max, ...], one int length)
    into slot ``slot`` of the batched one ([L, B, S_max, ...], [B]
    lengths), in place; a ``HybridCache``'s SSM state and conv tail too.
    Each row is copied whole: an idle slot keeps decoding, so nothing of
    the slot's last request may be left in it."""
    for name in batch_cache._fields:
        if name != "length":
            getattr(batch_cache, name)[:, slot].copy_(
                getattr(one_cache, name)[:, 0])
    batch_cache.length[slot] = one_cache.length


def _mark_request(name: str, req: Request) -> None:
    """``name`` from the request's submission until now."""
    if req.t_submit_ns and trace.enabled():
        trace.mark(name, req.t_submit_ns, time.time_ns(), id=req.rid)


class ContinuousBatchingEngine:
    """Admits requests into B decode slots; one decode step serves all.
    Runs on the params' device."""

    def __init__(self, model: Model, params: Any, *, n_slots: int = 4,
                 max_seq: int = 256, eos_token: int = -1,
                 transfer: "TransferEngine | Any | None" = None,
                 class_caps: "dict[str, float] | None" = None,
                 rx_timeout_s: float | None = 60.0,
                 qos: QosSpec | None = None,
                 admission: AdmissionPolicy | None = None):
        if model.cfg.family not in ("dense", "moe", "vlm", "hybrid_moe"):
            # the ssm and hybrid states carry no per-slot length, and the
            # audio family's dict cache cannot be spliced (the reference
            # raises for the first two and cannot splice the third)
            raise NotImplementedError(
                "continuous batching currently supports KV-cache families "
                "(dense / moe / vlm / hybrid_moe, whose cache holds its "
                f"Mamba2 state too), not {model.cfg.family!r}")
        self.model = model
        self.params = params
        self.n_slots = n_slots
        self.max_seq = max_seq
        self.eos = eos_token
        self.device = params["embed"].device
        # DEPRECATED kwargs fold into the base QosSpec: class_caps ->
        # qos.class_caps, rx_timeout_s -> qos.timeout_s (the liveness
        # bound on every decoded-token RX wait; None = unbounded).
        if class_caps is not None:
            warn_deprecated_kwarg(
                "ContinuousBatchingEngine(class_caps=...)",
                "ContinuousBatchingEngine(qos=QosSpec(class_caps=...))")
        if rx_timeout_s != 60.0:
            warn_deprecated_kwarg(
                "ContinuousBatchingEngine(rx_timeout_s=...)",
                "ContinuousBatchingEngine(qos=QosSpec(timeout_s=...))")
        self.qos = QosSpec(timeout_s=rx_timeout_s,
                           class_caps=class_caps).merged(qos)
        self.rx_timeout_s = self.qos.timeout_s
        # token RXs ride TOKEN class unless the base spec overrides.
        self._tok_qos = QosSpec(priority=PriorityClass.TOKEN).merged(
            self.qos)
        # callers may hand in a shared TransferEngine or ChannelGroup, which
        # close() then leaves alone (we only close what we created).
        self._owns_transfer = transfer is None
        self.transfer = transfer or TransferEngine(
            TransferPolicy.kernel_level(), device=self.device)
        if self.qos.class_caps:
            for name, bps in self.qos.class_caps.items():
                self.transfer.set_class_cap(PriorityClass(name), bps)
        # admission valve: submit() sheds a tenant whose backlog or whose
        # class's deadline-miss rate crosses the policy thresholds. Runtime
        # read lazily: engines register with the shared runtime on first
        # submit.
        self.admission = AdmissionController(
            runtime=lambda: self.transfer.runtime,
            policy=admission, cls=PriorityClass.TOKEN)
        self.queue: "collections.deque[Request]" = collections.deque()
        self.slots: list[Request | None] = [None] * n_slots
        cache = model.init_cache(n_slots, max_seq, device=self.device)
        # per-slot lengths: one [B] tensor for every layer
        self.cache = cache._replace(length=torch.zeros(
            n_slots, dtype=torch.int64, device=self.device))
        self.tokens = torch.zeros((n_slots, 1), dtype=torch.int32,
                                  device=self.device)
        self.lengths = np.zeros(n_slots, np.int64)
        # decoded-token landing zone: every step's RX writes this buffer in
        # place (out=), so steady-state decode allocates nothing per step
        # on the detokenize path.
        self._tok_host = np.empty(n_slots, np.int32)
        self.steps = 0
        self.completed: list[Request] = []

    def submit(self, req: Request) -> AdmissionDecision:
        """Enqueue ``req`` unless admission sheds it. Always returns the
        explicit :class:`AdmissionDecision`: a ``shed`` decision means the
        request was NOT enqueued (check ``decision.admitted``); the caller
        backs off ``retry_after_s`` and resubmits."""
        spec = self.qos.merged(req.qos)
        tenant = spec.effective_tenant
        backlog = sum(
            1 for r in self.queue
            if self.qos.merged(r.qos).effective_tenant == tenant)
        decision = self.admission.decide(
            tenant, cls=self._tok_qos.priority, extra_depth=backlog)
        if decision.admitted:
            self.queue.append(req)
            req.t_submit_ns = time.time_ns() if trace.enabled() else 0
        return decision

    def _admit(self) -> None:
        admits: list[tuple[int, Request]] = []
        for slot in range(self.n_slots):
            if self.slots[slot] is None and self.queue:
                admits.append((slot, self.queue.popleft()))
        if not admits:
            return
        prompts = [np.ascontiguousarray(r.prompt[None], dtype=np.int32)
                   for _s, r in admits]
        specs = [self.qos.merged(r.qos) for _s, r in admits]
        # several pending admissions with one submit context ride ONE
        # scatter-gather transaction (each ragged prompt its own segment);
        # mixed specs fall back to one TX a prompt, keeping tenant
        # attribution exact.
        with trace.span("serve.admit.tx"):
            if (len(admits) > 1 and all(s == specs[0] for s in specs)
                    and self.transfer.policy.management is Management.INTERRUPT
                    and hasattr(self.transfer, "tx_sg")):
                devs = self.transfer.tx_sg(prompts, qos=specs[0]).wait()
                prompt_devs = [d.reshape(p.shape)
                               for d, p in zip(devs, prompts)]
            else:
                prompt_devs = [
                    reassemble_chunks(
                        self.transfer.tx(p, qos=s)).reshape(p.shape)
                    for p, s in zip(prompts, specs)]
        vocab = self.model.cfg.vocab
        for (slot, req), prompt_dev in zip(admits, prompt_devs):
            with trace.span("serve.prefill", id=req.rid):
                logits, one_cache = self.model.prefill(
                    self.params, {"tokens": prompt_dev}, self.max_seq)
            with trace.span("serve.first_token", id=req.rid):
                trace.count("wait.first_token")
                first = int(logits[0, -1, :vocab].argmax(-1))
            with trace.span("serve.splice", id=req.rid):
                req.tokens.append(first)
                _splice_slot(self.cache, one_cache, slot)
                self.tokens[slot, 0] = first
                self.lengths[slot] = len(req.prompt) + 1
                self.slots[slot] = req
            _mark_request("serve.queue", req)

    def _retire(self) -> None:
        for slot, req in enumerate(self.slots):
            if req is None:
                continue
            hit_eos = self.eos >= 0 and req.tokens and req.tokens[-1] == self.eos
            if (len(req.tokens) >= req.max_new_tokens or hit_eos
                    or self.lengths[slot] >= self.max_seq - 1):
                req.done = True
                self.completed.append(req)
                self.slots[slot] = None
                _mark_request("serve.request", req)

    @torch.no_grad()
    def step(self) -> int:
        """Admit, decode one token for every slot, retire. Returns the
        number of active slots served."""
        with trace.span("serve.step"):
            return self._step()

    def _step(self) -> int:
        with trace.span("serve.admit"):
            self._admit()
        active = [s for s, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        with trace.span("serve.decode"):
            logits, self.cache = self.model.decode(self.params, self.tokens,
                                                   self.cache)
            tok_dev = logits[:, -1, : self.model.cfg.vocab].argmax(-1).to(
                torch.int32)
        # the next step's input stays on the device; only the bookkeeping
        # copy crosses back to the host, as a measured RX. Under INTERRUPT
        # it rides a runtime worker at TOKEN priority; with more than one
        # active slot the per-request tokens go as ONE rx_many transaction
        # (per-slot tickets, one completion hand-off).
        with trace.span("serve.token_rx"):
            nxt = self._token_rx(active, tok_dev)
        with trace.span("serve.retire"):
            nxt = np.asarray(nxt).reshape(-1)
            for slot in active:
                self.slots[slot].tokens.append(int(nxt[slot]))
                self.lengths[slot] += 1
            self.steps += 1
            self._retire()
            # the step's RX is retired: a drained-ring safe point for an
            # online-adaptive transfer engine to swap plans (no-op otherwise)
            self.transfer.maybe_adapt()
        return len(active)

    def _token_rx(self, active: list[int], tok_dev: torch.Tensor):
        """The step's tokens on the host; ``self.tokens`` becomes the next
        step's input, which stays on the device."""
        interrupt = (
            self.transfer.policy.management is Management.INTERRUPT)
        if (interrupt and len(active) > 1
                and hasattr(self.transfer, "rx_many")):
            tickets = self.transfer.rx_many(
                [tok_dev[s:s + 1] for s in active],
                out=[self._tok_host[s:s + 1] for s in active],
                qos=self._tok_qos)
            self.tokens = tok_dev[:, None]
            for t in tickets:
                t.wait(self.rx_timeout_s)
            # per-slot landings wrote _tok_host in place (inactive slots
            # keep stale values and are never read below)
            return self._tok_host
        out = [self._tok_host]  # reused every step: zero-copy detok
        ticket = (self.transfer.rx_async([tok_dev], out=out,
                                         qos=self._tok_qos)
                  if interrupt else None)
        self.tokens = tok_dev[:, None]
        return (ticket.wait(self.rx_timeout_s)[0] if ticket
                else self.transfer.rx([tok_dev], out=out,
                                      qos=self._tok_qos)[0])

    def run_to_completion(self, max_steps: int = 10_000) -> list[Request]:
        while (self.queue or any(s is not None for s in self.slots)):
            if self.steps >= max_steps:  # check BEFORE stepping: exactly
                break                    # max_steps decode steps, not +1
            if self.step() == 0 and not self.queue:
                break
        return self.completed

    def fault_summary(self) -> dict[str, Any]:
        """Deadline-miss / retry / quarantine rates of the transfer surface
        (zeroed recovery columns on a bare engine: no sibling channels)."""
        return transfer_fault_summary(self.transfer)

    def admission_summary(self) -> dict[str, Any]:
        """Accept/queue/shed counts of the submit() valve, with per-tenant
        rows for tenants that were ever queued or shed."""
        return self.admission.summary()

    def close(self) -> None:
        if self._owns_transfer:
            self.transfer.close()
