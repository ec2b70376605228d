"""Closed-loop chat clients through ``ContinuousBatchingEngine``.

Traffic parameters (``traffic/<mix>.json``):

- ``n_slots``, ``max_seq``: the engine's decode slots and cache length;
- ``clients``: closed-loop clients with zero think time (a client submits
  its next request when its previous one completes);
- ``prompt``, ``output``: lognormal lengths, each ``{"median", "sigma",
  "min", "max"}``; outputs have no EOS and decode greedily;
- ``pool``: requests made from the seed; the lengths are the lognormal's
  quantiles at (i + 0.5) / pool, so every seed serves the same lengths in
  another order; ids uniform over the vocabulary;
- ``warmup_steps``: engine steps in set-up after the clients' first
  requests are admitted; each first request takes a residual output
  length (its quantile (i + 0.5) / clients of its full length, in a seed
  order), so retirements are spread over the window;
- ``check_requests``: requests finished in the window that the check
  compares (the one with the most served tokens and others drawn from the
  seed);
- ``trace_at``, ``trace_steps``: where the traced sub-window starts (a
  share of the window) and how many engine steps it holds.

A generated token's gap runs from the host's return from the step that
produced the request's previous token (its submission for the first
token) to the host's return from the step that produced it.
"""

from __future__ import annotations

import dataclasses
import math
import time
from statistics import NormalDist

import numpy as np

from perfbench.counts import lm as lm_counts
from perfbench.lib import spec
from perfbench.lib.stats import percentile
from perfbench.lib.trace import SubWindow, span

SEED_REQUESTS = 2
SEED_SAMPLE = 3


def lengths(dist: dict, n: int) -> np.ndarray:
    """The lognormal's quantiles at (i + 0.5) / n, clipped, as ints."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = dist["median"] * np.exp(dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(np.int64)


def make_requests(cfg: dict, traffic: dict, seed: int):
    """(prompts, output lengths, residual first outputs): the pool's
    prompts as int32 arrays and the max new tokens of each, in a seed
    order; the clients' first requests' residual lengths."""
    import torch

    n = traffic["pool"]
    g = torch.Generator().manual_seed((int(seed) * 16 + SEED_REQUESTS)
                                      % (1 << 63))
    p_len = lengths(traffic["prompt"], n)[torch.randperm(n, generator=g)]
    o_len = lengths(traffic["output"], n)[torch.randperm(n, generator=g)]
    ids = torch.randint(0, cfg["vocab_size"], (int(p_len.sum()),),
                        generator=g, dtype=torch.int32).numpy()
    prompts = np.split(ids, np.cumsum(p_len)[:-1])
    c = traffic["clients"]
    frac = ((torch.randperm(c, generator=g).numpy() + 0.5) / c)
    first = np.maximum(1, np.ceil(o_len[:c] * frac)).astype(np.int64)
    return prompts, o_len, first


class State:
    pass


class Served:
    """The ``Model`` handed to the engine. It keeps every prefill's and
    decode's logits as the timed path produced them (references, no copy)
    with the requests they belong to: a prefill's by the order the engine
    admits requests in (first in, first out), a decode's by the engine's
    slots at the call. In a traced run each call is also synchronised and
    timed, inside a harness range."""

    def __init__(self, model, sync=None):
        self.model, self.sync = model, sync
        self.engine = None
        self.admitted: list[int] = []  # rids in the order submit took them
        self.prefills: dict[int, object] = {}  # rid -> logits [1, 1, Vp]
        self.decodes: list = []  # (logits [B, 1, Vp], rid per slot)
        self.prefill_s: list[float] = []
        self.decode_s: list[float] = []

    def _call(self, fn, name, into, *a):
        if self.sync is None:
            return fn(*a)
        self.sync()
        t0 = time.perf_counter()
        with span(name):
            out = fn(*a)
        self.sync()
        into.append(time.perf_counter() - t0)
        return out

    def prefill(self, params, batch, s_max):
        out = self._call(self.model.prefill, "pb.prefill", self.prefill_s,
                         params, batch, s_max)
        self.prefills[self.admitted[len(self.prefills)]] = out[0]
        return out

    def decode(self, params, token, cache):
        out = self._call(self.model.decode, "pb.decode", self.decode_s,
                         params, token, cache)
        self.decodes.append((out[0], [None if q is None else q.rid
                                      for q in self.engine.slots]))
        return out

    def model_for_engine(self):
        return dataclasses.replace(self.model, prefill=self.prefill,
                                   decode=self.decode)

    def rows(self, rid: int, vocab: int):
        """The logits rows that produced request ``rid``'s tokens, in
        order, or None when they do not add up."""
        import torch

        if rid not in self.prefills:
            return None
        out = [self.prefills[rid][0, -1, :vocab]]
        for logits, rids in self.decodes:
            if rid in rids:
                out.append(logits[rids.index(rid), -1, :vocab])
        return torch.stack(out)


def setup(run) -> State:
    import torch

    from repro_torch.serve.continuous import ContinuousBatchingEngine, Request

    cfg, tr, dev = run.config, run.traffic, run.device
    cb = spec.load_module("configs", cfg["builder"])
    cuda = torch.device(dev).type == "cuda"
    st = State()
    t0 = time.perf_counter()
    st.params = cb.make_params(cfg, run.seed, dev)
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    sync = None
    if run.trace:
        sync = torch.cuda.synchronize if cuda else (lambda: None)
    st.served = Served(cb.program(cfg), sync)
    st.engine = ContinuousBatchingEngine(st.served.model_for_engine(),
                                         st.params, n_slots=tr["n_slots"],
                                         max_seq=tr["max_seq"])
    st.served.engine = st.engine
    st.prompts, st.outputs, first = make_requests(cfg, tr, run.seed)
    st.Request = Request
    st.next = 0  # the pool's next request
    st.pending: list = []  # shed by admission, to be submitted again
    st.live: dict = {}  # rid -> [request, tokens seen, time of the last]
    now = time.perf_counter()
    for c in range(tr["clients"]):
        _submit(st, now, max_new=int(first[c]))
    st.engine.step()  # every client's first prefill
    t2 = time.perf_counter()
    _after_step(st, t2, None)
    for _ in range(tr["warmup_steps"]):
        st.engine.step()
        _after_step(st, time.perf_counter(), None)
    st.phases = {"weights": t1 - t0, "engine and first prefills": t2 - t1,
                 "warm-up steps": time.perf_counter() - t2}
    return st


def _submit(st: State, now: float, max_new: int | None = None) -> None:
    i = st.next % len(st.prompts)
    st.next += 1
    req = st.Request(rid=st.next - 1, prompt=st.prompts[i],
                     max_new_tokens=int(max_new or st.outputs[i]))
    st.live[req.rid] = [req, 0, now]
    if st.engine.submit(req).admitted:
        st.served.admitted.append(req.rid)
    else:
        st.pending.append(req)


def _after_step(st: State, now: float, rec) -> None:
    """Token arrivals of the step that just returned; a client whose
    request completed submits its next one."""
    for p in st.pending[:]:
        if st.engine.submit(p).admitted:
            st.served.admitted.append(p.rid)
            st.pending.remove(p)
    done = []
    for rid, ent in st.live.items():
        req, seen, last = ent
        n = len(req.tokens)
        if n > seen:
            if rec is not None:
                rec["gaps"].append(now - last)
                rec["gaps"].extend([0.0] * (n - seen - 1))
                rec["new"].append((len(req.prompt), seen, n))
            ent[1], ent[2] = n, now
        if req.done:
            done.append(rid)
    for rid in done:
        req = st.live.pop(rid)[0]
        if rec is not None:
            rec["finished"].append(req)
        _submit(st, now)


def window(run, st: State) -> dict:
    tr = run.traffic
    eng = st.engine
    rx: list[float] = []

    def observe(stats):
        if stats.direction == "rx":
            rx.append(stats.wall_s)

    eng.transfer.add_observer(observe)
    st.served.prefill_s.clear()  # set-up's calls are not the window's
    st.served.decode_s.clear()
    rec = {"gaps": [], "new": [], "finished": []}
    active = []
    sub = None
    t_start = time.perf_counter()
    now = t_start
    steps = 0
    while now - t_start < run.seconds:
        if (run.trace and sub is None
                and now - t_start >= tr["trace_at"] * run.seconds):
            sub = SubWindow()
            with sub:
                for _ in range(tr["trace_steps"]):
                    with span("pb.step"):
                        active.append(eng.step())
                    now = time.perf_counter()
                    _after_step(st, now, rec)
                    steps += 1
            continue
        active.append(eng.step())
        now = time.perf_counter()
        _after_step(st, now, rec)
        steps += 1
    wall = now - t_start
    rx_s = sum(rx)
    n_rx = len(rx)
    eng.close()
    tokens = len(rec["gaps"])
    r = {"attempted": st.next, "failed": len(st.pending),
         "window_s": wall, "steps": steps,
         "tokens_per_s": tokens / wall,
         "token_gap_p95_ms": percentile(rec["gaps"], 95) * 1e3,
         "slot_occupancy": sum(active) / (len(active) * tr["n_slots"]),
         "finished": rec["finished"], "token_rx_s": rx_s,
         "rx_records": n_rx,
         "model_flops": sum(_flops(run.config, *t) for t in rec["new"])}
    if run.trace:
        r["prefill_s"] = list(st.served.prefill_s)
        r["decode_s"] = list(st.served.decode_s)
    if sub is not None:
        r["sub"] = sub
    return r


def _flops(cfg: dict, prompt: int, seen: int, n: int) -> int:
    """Model FLOPs of the tokens ``seen``..``n - 1`` of a request: the
    first is its prompt's prefill, each later one a decode step that sees
    the prompt and the tokens before it."""
    f = 0
    for j in range(seen, n):
        f += (lm_counts.prefill_flops(cfg, prompt) if j == 0
              else lm_counts.decode_flops(cfg, prompt + j))
    return f


def release(st: State) -> None:
    """Drops the engine (its cache and transfer state); keeps the weights
    and the logits the timed path produced."""
    del st.engine
    st.served.engine = None


def _sample(run, finished: list) -> list:
    """The request with the most served tokens and others drawn from the
    seed, ``check_requests`` in all."""
    import torch

    if not finished:
        return []
    finished = sorted(finished, key=lambda q: q.rid)
    longest = max(finished, key=lambda q: (len(q.tokens), -q.rid))
    rest = [q for q in finished if q is not longest]
    g = torch.Generator().manual_seed((int(run.seed) * 16 + SEED_SAMPLE)
                                      % (1 << 63))
    k = min(len(rest), run.traffic["check_requests"] - 1)
    pick = torch.randperm(len(rest), generator=g)[:k].tolist()
    return [longest] + [rest[i] for i in sorted(pick)]


def compare(run, st: State, req, control: bool = False):
    """One served request against the reference, run once over its prompt
    and its served tokens. At each served position: the RMS of the
    program's logits (as the timed path produced them) less the
    reference's, over the RMS of the reference's row; and the gap by which
    the served token's reference logit lies below the reference's best.
    With ``control``, the same of the fp8 control put in the program's
    place (its first token for the served one). Returns a list of
    ``(row errors, gaps)``, the program's first; None where the rows the
    timed path produced do not add up to the request's tokens."""
    import torch

    ref = spec.load_module("reference", run.config["builder"])
    v = run.config["vocab_size"]
    dev = st.params["embed"].device
    got = st.served.rows(req.rid, v)
    served = torch.tensor(req.tokens, dtype=torch.long, device=dev)
    if got is None or got.shape[0] != served.numel():
        return None
    seq = torch.cat([torch.from_numpy(req.prompt).long().to(dev),
                     served[:-1]])
    rows = torch.arange(len(req.prompt) - 1, seq.numel(), device=dev)
    lg = ref.logits(run.config, st.params, seq, rows)
    rms = lg.square().mean(-1).sqrt()
    best = lg.max(-1).values

    def readings(p, pick):
        err = (p.float() - lg).square().mean(-1).sqrt() / rms
        return err.cpu(), (best - lg.gather(1, pick[:, None])[:, 0]).cpu()

    out = [readings(got, served)]
    if control:
        low = ref.logits(run.config, st.params, seq, rows, fp8=True)
        out.append(readings(low, low.argmax(-1)))
    return out


def numbers(per_request: list) -> dict:
    """The compared numbers over the sampled requests: the worst request's
    median row error (``logits_rms_err_median``) and the mean served-token
    gap over every position (``served_gap_mean``); beside them, for the
    record, the worst row's error, the widest gap and the share of
    positions whose served token is not the reference's first."""
    import torch

    if not per_request or any(x is None for x in per_request):
        return {"logits_rms_err_median": math.inf,
                "served_gap_mean": math.inf}
    err = [e for e, _ in per_request]
    gaps = torch.cat([g for _, g in per_request])
    return {"logits_rms_err_median": max(float(e.median()) for e in err),
            "served_gap_mean": float(gaps.mean()),
            "logits_rms_err_max": max(float(e.max()) for e in err),
            "served_gap_max": float(gaps.max()),
            "flip_share": float((gaps > 0).float().mean())}


def _side(got: list, i: int) -> list:
    return [None if g is None else g[i] for g in got]


def check(run, st: State, r: dict) -> dict:
    got = [compare(run, st, q) for q in _sample(run, r["finished"])]
    nums = numbers(_side(got, 0))
    return {k: nums[k] for k in run.limits}


def control(run) -> dict:
    """The program's numbers and the fp8 control's over the requests a
    run of ``run.seconds`` at the cell's own load finishes."""
    st = setup(run)
    r = window(run, st)
    release(st)
    sample = _sample(run, r["finished"])
    got = [compare(run, st, q, control=True) for q in sample]
    out = numbers(_side(got, 0))
    out.update({f"{k}[fp8]": x for k, x in numbers(_side(got, 1)).items()})
    out.update(requests=len(sample),
               positions=sum(len(q.tokens) for q in sample))
    return out
