"""Data pipeline with policy-driven host->device staging.

The paper's PS side collects DVS events, normalises them into frames, and
DMAs them to the accelerator. Our equivalent: a host-side source produces
token batches (synthetic LM stream here — deterministic, seeded), a
normalisation stage packs them, and the staging stage moves them to the
card under a :class:`TransferPolicy`:

- POLLING   : copy + synchronise before the step (paper's user-level)
- SCHEDULED : staging tasks interleaved with source work on the cooperative
              scheduler
- INTERRUPT : background prefetch thread keeps a queue of ``policy.depth``
              device batches ready (single/double buffer are rings of depth
              1/2) — the kernel-driver mode, and the right default for
              training (stage batch k+1..k+depth during step k).

When a transfer ``engine`` (a :class:`~repro_torch.core.transfer.TransferEngine`
or multi-channel :class:`~repro_torch.core.channels.ChannelGroup`) is
supplied, batches stage through its cached
:class:`~repro_torch.core.transfer.StagedLayout` — one reused staging buffer
per batch shape, measured TX stats, and (for a group) the batch payload
striped across channels. Without one, a batch is copied on a copy stream of
the pipeline's own.

A batch staged on another thread or stream is read by the step on the
consumer's stream: ``__next__`` makes that stream wait on the batch's
ready event, and records the stream on each tensor, so the caching
allocator cannot hand the memory out again while the step still reads
it. The host batches are the reference's, bit for bit
(:class:`SyntheticLMSource` is numpy, copied)."""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.qos import QosSpec
from repro_torch.core.runtime import CooperativeScheduler, PriorityClass
from repro_torch.core.transfer import Management, TransferPolicy
from repro_torch.device import default_device
from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0


class SyntheticLMSource:
    """Deterministic synthetic token stream (zipfian-ish unigram mix with
    local structure, so loss curves are non-trivial but reproducible)."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self._rng = np.random.default_rng(cfg.seed)
        v = model_cfg.vocab
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)

    def next_host_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng(self.cfg.seed + step)
        b, s = self.cfg.global_batch, self.cfg.seq_len
        mc = self.model_cfg
        if mc.family == "vlm":
            s_text = s - mc.n_prefix_tokens
            toks = rng.choice(mc.vocab, size=(b, s_text), p=self._probs)
            return {
                "tokens": toks.astype(np.int32),
                "patch_embeds": rng.standard_normal(
                    (b, mc.n_prefix_tokens, mc.d_model)).astype(np.float32),
                "labels": np.roll(toks, -1, axis=1).astype(np.int32),
            }
        toks = rng.choice(mc.vocab, size=(b, s), p=self._probs)
        # local structure: repeat the previous token 20% of the time
        rep = rng.random((b, s)) < 0.2
        toks[:, 1:] = np.where(rep[:, 1:], toks[:, :-1], toks[:, 1:])
        batch = {
            "tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, axis=1).astype(np.int32),
        }
        if mc.family == "audio":
            batch["frames"] = rng.standard_normal(
                (b, s, mc.d_model)).astype(np.float32)
        return batch


class StagedPipeline:
    """Iterator of device-resident batches under a transfer policy.

    ``device``: where the batches go when there is no ``engine`` (an
    engine's own device otherwise); the card unless it names another.

    ``shardings``: a {key: :class:`~repro_torch.dist.sharding.Sharding`}
    tree over the batch's keys (``batch_sharding_tree``). Each rank then
    stages only its own shard of each leaf — sliced from the host batch,
    staged under the policy's management as a whole batch would be — and
    the step gets ``DTensor`` leaves made with ``DTensor.from_local``, as
    ``jax.device_put(host_batch, shardings)`` hands each device its shard
    and not the whole batch."""

    def __init__(self, source: SyntheticLMSource, policy: TransferPolicy,
                 shardings: Any | None = None, start_step: int = 0,
                 engine: Any | None = None, device=None):
        self.source = source
        self.policy = policy
        self.shardings = shardings
        self.engine = engine  # TransferEngine or ChannelGroup (optional)
        self.device = (engine.device if engine is not None
                       else default_device(device))
        if shardings is not None:
            meshes = {getattr(sh.mesh, "device_type", None)
                      for sh in shardings.values()}
            if meshes != {self.device.type}:
                raise ValueError(f"shardings on {meshes} meshes, batches "
                                 f"staged to {self.device}")
        self.step = start_step
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if engine is None and self.device.type == "cuda"
                             else None)
        # prefetch window = the policy's descriptor-ring depth (SINGLE=1,
        # DOUBLE=2, RING=N): batch k+depth stages while step k runs.
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=policy.depth)
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        self._sched = (CooperativeScheduler()
                       if policy.management is Management.SCHEDULED else None)
        if policy.management is Management.INTERRUPT:
            self._thread = threading.Thread(target=self._prefetch_loop,
                                            daemon=True)
            self._thread.start()

    def _put_device(self, host_batch: dict
                    ) -> tuple[dict, "torch.cuda.Event | None"]:
        """The batch on the device and the event that marks it ready (None
        on the host): this rank's shard of each leaf under ``shardings``."""
        if self.shardings is not None:
            host_batch = {k: _local_shard(v, self.shardings[k])
                          for k, v in host_batch.items()}
        if self.engine is not None:
            # stage through the engine's cached layout: the staging buffer
            # is reused every step (same batch shapes), the TX is measured,
            # and a ChannelGroup stripes it across its rings. BULK class:
            # prefetch is throughput traffic — the shared runtime must
            # never let it queue ahead of token RX or sensor ingest.
            keys = sorted(host_batch)
            arrays = [np.ascontiguousarray(host_batch[k]) for k in keys]
            lay = self.engine.layouts.get(("batch", tuple(keys)), arrays)
            if (hasattr(self.engine, "tx_sg")
                    and hasattr(self.engine, "prefer_sg")
                    and self.engine.policy.management is Management.INTERRUPT
                    and self.engine.layouts.decide_sg(
                        ("batch", tuple(keys)), lay,
                        self.engine.prefer_sg)):
                # few large batch arrays: scatter-gather skips the staging
                # memcpy — each array is its own descriptor segment.
                dev = self.engine.tx_sg(
                    lay.sg_segments(arrays),
                    qos=QosSpec(priority=PriorityClass.BULK)).wait()
            else:
                dev = lay.unpack(self.engine.tx(
                    lay.pack(arrays),
                    qos=QosSpec(priority=PriorityClass.BULK)))
            # batch boundary, TX retired: safe point for an online-adaptive
            # engine to refit its cost model and swap plan generations
            # (no-op on plain engines/groups).
            self.engine.maybe_adapt()
            batch = dict(zip(keys, dev))
            # the copies completed on the engine's streams; the unpack ran
            # on this thread's current stream
            stream = (torch.cuda.current_stream(self.device)
                      if self.device.type == "cuda" else None)
        elif self._copy_stream is not None:
            stream = self._copy_stream
            with torch.cuda.stream(stream):
                batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, non_blocking=True)
                    for k, v in host_batch.items()}
        else:
            return {k: torch.from_numpy(np.array(v))
                    for k, v in host_batch.items()}, None
        if stream is None:
            return batch, None
        ready = torch.cuda.Event()
        ready.record(stream)
        return batch, ready

    def _prefetch_loop(self) -> None:
        step = self.step
        while not self._stop.is_set():
            try:
                item = self._put_device(self.source.next_host_batch(step))
            except BaseException as e:  # surfaced by __next__
                item = e
            step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, BaseException):
                return

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        mgmt = self.policy.management
        if mgmt is Management.INTERRUPT:
            item = self._q.get()
            if isinstance(item, BaseException):
                raise item
            batch, ready = item
        elif mgmt is Management.SCHEDULED:
            out: list = []
            self._sched.submit(lambda: out.append(
                self._put_device(self.source.next_host_batch(self.step))))
            self._sched.drain()
            batch, ready = out[0]
        else:  # POLLING
            batch, ready = self._put_device(
                self.source.next_host_batch(self.step))
            if ready is not None:
                ready.synchronize()
        if ready is not None:
            # the step reads the batch on this thread's stream: wait for
            # its copies, and keep its memory from being reused early
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in batch.values():
                t.record_stream(consumer)
        self.step += 1
        if self.shardings is not None:
            batch = {k: _from_local(t, self.shardings[k])
                     for k, t in batch.items()}
        return batch

    def close(self) -> None:
        self._stop.set()
        # unblock a producer stuck on a full queue
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread is not None:
            self._thread.join(timeout=30.0)


def _local_shard(a: np.ndarray, sh) -> np.ndarray:
    """This rank's block of ``a`` under ``sh``'s placements: each mesh dim
    that shards tensor dim d cuts the block left by the dims before it, as
    ``DTensor`` lays out ``Shard(d)`` over several mesh dims (the rules
    shard only dims they divide evenly)."""
    from torch.distributed.tensor import Shard

    coord = sh.mesh.get_coordinate()
    block = [slice(0, n) for n in a.shape]
    for mdim, pl in enumerate(sh.placements):
        if isinstance(pl, Shard):
            d = pl.dim
            lo, hi = block[d].start, block[d].stop
            step = (hi - lo) // sh.mesh.size(mdim)
            block[d] = slice(lo + coord[mdim] * step,
                             lo + (coord[mdim] + 1) * step)
    return np.ascontiguousarray(a[tuple(block)])


def _from_local(t: torch.Tensor, sh):
    """The staged shard as a ``DTensor`` of the batch's global shape (the
    rules shard only dims they divide evenly)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t, sh.mesh, list(sh.placements),
                              run_check=False)
