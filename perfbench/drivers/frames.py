"""Closed-loop DVS frames through ``NullHopExecutor.run_frame``.

Traffic parameters (``traffic/<mix>.json``):

- ``frames_per_call``: the batch handed to one ``run_frame`` call;
- ``pool``: distinct frames made from the seed (a multiple of the batch),
  handed over in a seed-shuffled order and cycled;
- ``events_per_frame``, ``blob_fraction``, ``blob_sd``, ``orbit_radius``,
  ``orbit_frames``, ``clip``: the event model of ``make_frames``;
- ``policy``: the ``TransferPolicy`` constructor the executor runs under;
- ``warmup_calls``, ``warmup_s``: set-up makes at least this many calls,
  for at least this long (the rate still climbs over the first seconds of
  a process's calls); ``trace_at``, ``trace_calls``:
  where the traced sub-window starts (a share of the window) and how many
  calls it holds.

A call's time runs from handing its frames to ``run_frame`` until its
logits are on the host; the next call starts when the previous one ends
(the sensor always has a frame ready). An untraced run also records the
card's activity over the whole window (``lib/trace.py``'s
``DeviceWindow``): the card's busy time a frame.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from perfbench.lib import spec
from perfbench.lib.stats import percentile
from perfbench.lib.trace import DeviceWindow, SubWindow, span

SEED_FRAMES = 2
SEED_ORDER = 3


def make_frames(cfg: dict, traffic: dict, seed: int, device):
    """[pool, H, W, 1] float32 frames on ``device``: each a histogram of
    ``events_per_frame`` events, most of them around a blob that moves
    along a circle (one turn every ``orbit_frames`` frames, from a phase
    drawn from the seed), the rest uniform noise; counts clipped at
    ``clip`` and divided by it. Every seed draws the same number of
    events a frame."""
    import torch

    cb = spec.load_module("configs", cfg["builder"])
    n, hw = traffic["pool"], cfg["input_hw"]
    e = traffic["events_per_frame"]
    n_blob = int(round(e * traffic["blob_fraction"]))
    g = cb.generator(seed, SEED_FRAMES, device)
    phase = torch.rand((), generator=g, device=device) * 2 * math.pi
    ang = phase + 2 * math.pi * torch.arange(
        n, device=device) / traffic["orbit_frames"]
    r = traffic["orbit_radius"] * hw / 64
    centre = torch.stack([hw / 2 + r * torch.cos(ang),
                          hw / 2 + r * torch.sin(ang)], -1)  # [n, 2]
    sd = traffic["blob_sd"] * hw / 64
    blob = centre[:, None, :] + sd * torch.randn(
        (n, n_blob, 2), generator=g, device=device)
    noise = torch.rand((n, e - n_blob, 2), generator=g, device=device) * hw
    xy = torch.cat([blob, noise], 1).floor().long().clamp_(0, hw - 1)
    flat = (torch.arange(n, device=device)[:, None] * hw * hw
            + xy[..., 0] * hw + xy[..., 1])
    counts = torch.bincount(flat.reshape(-1), minlength=n * hw * hw)
    clip = traffic["clip"]
    frames = counts.clamp(max=clip).float() / clip
    return frames.reshape(n, hw, hw, 1)


class State:
    pass


def setup(run) -> State:
    import torch

    from repro_torch.accel.nullhop import NullHopExecutor
    from repro_torch.core.transfer import TransferPolicy

    cfg, tr, dev = run.config, run.traffic, run.device
    b = tr["frames_per_call"]
    if tr["pool"] % b:
        raise ValueError("the frame pool must be a multiple of the batch")
    cb = spec.load_module("configs", cfg["builder"])
    st = State()
    t0 = time.perf_counter()
    st.params = cb.make_params(cfg, run.seed, dev)
    frames = make_frames(cfg, tr, run.seed, dev)
    order = torch.randperm(tr["pool"], generator=cb.generator(
        run.seed, SEED_ORDER, dev), device=dev)
    st.frames_dev = frames[order]  # the order calls hand them over in
    st.frames = st.frames_dev.cpu().numpy()
    t1 = time.perf_counter()
    st.executor = NullHopExecutor(cb.program(cfg),
                                  getattr(TransferPolicy, tr["policy"])(),
                                  device=dev)
    c = 0
    while c < tr["warmup_calls"] or time.perf_counter() - t1 < tr["warmup_s"]:
        _call(st, c, b)
        c += 1
    st.phases = {"weights and frames": t1 - t0,
                 "warm-up calls": time.perf_counter() - t1}
    return st


def _call(st: State, c: int, b: int):
    s = (c * b) % st.frames.shape[0]
    return st.executor.run_frame(st.params, st.frames[s:s + b])


def window(run, st: State) -> dict:
    """The measured window; returns the readings of the end-to-end and
    per-layer metrics."""
    tr = run.traffic
    b = tr["frames_per_call"]
    lat, starts, outs, timings = [], [], [], []
    sub = None
    c = 0
    whole = (DeviceWindow().start()
             if not run.trace and run.device.type == "cuda" else None)
    t_start = time.perf_counter()
    now = t_start
    while now - t_start < run.seconds:
        if (run.trace and sub is None
                and now - t_start >= tr["trace_at"] * run.seconds):
            sub = SubWindow()
            sub_first = c
            n0 = _conv_launches()
            t_sub = time.perf_counter()
            with sub:
                for _ in range(tr["trace_calls"]):
                    with span("pb.frame"):
                        res = _call(st, c, b)
                    starts.append(c)
                    outs.append(res.logits)
                    c += 1
            sub_calls = c - sub_first
            sub_launches = _conv_launches() - n0
            now = time.perf_counter()
            sub_wall = now - t_sub
            continue
        t0 = time.perf_counter()
        res = _call(st, c, b)
        now = time.perf_counter()
        lat.append(now - t0)
        starts.append(c)
        outs.append(res.logits)
        timings.append(res.timing)
        c += 1
    t_end = now
    dev = whole.stop() if whole is not None else None
    st.executor.close()
    wall = t_end - t_start
    _fifths(lat, b)
    loop_wall = wall - (sub_wall if sub is not None else 0.0)
    r = {"attempted": c, "window_s": wall,
         "frames_per_s.loop": len(lat) * b / loop_wall,
         "frame_p95_ms.loop": percentile(lat, 95) * 1e3,
         "outs": outs, "starts": starts, "batch": b}
    if timings:
        r["tx_s"] = sum(l.tx_s for t in timings for l in t.layers)
        r["tx_bytes"] = sum(l.tx_bytes for t in timings for l in t.layers)
        r["rx_s"] = sum(l.rx_s for t in timings for l in t.layers)
        r["rx_bytes"] = sum(l.rx_bytes for t in timings for l in t.layers)
        r["compute_s_per_call"] = [sum(l.compute_s for l in t.layers)
                                   for t in timings]
    if dev is not None:
        r["device_us_per_frame"] = dev.busy_s * 1e6 / (c * b)
        print(f"perfbench: the card over the window: busy {dev.busy_s:.6f} s, "
              f"kernels {dev.kernel_s:.6f} s, copies {dev.copy_s:.6f} s, "
              f"{dev.n_ops} ops; {r['device_us_per_frame']:.3f} us busy and "
              f"{dev.kernel_s * 1e6 / (c * b):.3f} us of kernels a frame",
              file=sys.stderr)
    if sub is not None:
        r["sub"] = sub
        r["sub_calls"] = sub_calls
        r["sub_frames"] = sub_calls * b
        r["sub_conv_launches"] = sub_launches
    return r


def _conv_launches() -> int:
    """The port's own count of conv2d launches (``CudaLibrary.launches``)."""
    from repro_torch.kernels.conv2d.kernel import CONV2D

    return sum(CONV2D.launches.values())


def _fifths(lat: list[float], b: int) -> None:
    """Frames a second in each fifth of the untraced calls, on standard
    error: whether the rate drifts within a window."""
    n = len(lat) // 5
    if n:
        rates = [b * n / sum(lat[i * n:(i + 1) * n]) for i in range(5)]
        print("perfbench: frames/s by fifth of the window: "
              + " ".join(f"{x:.1f}" for x in rates), file=sys.stderr)


def release(st: State) -> None:
    """Drops the program's state; keeps what the reference reads."""
    del st.executor
    del st.frames


def check(run, st: State, r: dict) -> dict:
    """Every call's logits against the reference's for its frames: the
    widest gap, over the RMS of the reference's logits over the pool."""
    import torch

    ref_mod = spec.load_module("reference", run.config["builder"])
    ref = torch.cat([ref_mod.logits(run.config, st.params, blk)
                     for blk in torch.split(st.frames_dev, 1024)]).cpu()
    b = r["batch"]
    n = ref.shape[0]
    rows = torch.cat([torch.arange(c * b, c * b + b) % n
                      for c in r["starts"]])
    try:
        got = torch.from_numpy(np.concatenate(r["outs"])).float()
    except ValueError:  # ragged answers: some call returned another shape
        got = None
    if got is None or got.shape != (rows.numel(), ref.shape[1]):
        err = math.inf
    else:
        err = float((got - ref[rows]).abs().max()
                    / ref.square().mean().sqrt())
    return {"logits_rel_err": err}


def control(run) -> dict:
    """The control's readings at the cell's size: the reference put in the
    program's place at the precision below the configuration's, over the
    frames a run hands over, against the reference."""
    import torch

    cb = spec.load_module("configs", run.config["builder"])
    ref_mod = spec.load_module("reference", run.config["builder"])
    params = cb.make_params(run.config, run.seed, run.device)
    frames = make_frames(run.config, run.traffic, run.seed, run.device)
    out = {}
    ref = torch.cat([ref_mod.logits(run.config, params, blk)
                     for blk in torch.split(frames, 1024)])
    scale = ref.square().mean().sqrt()
    precisions = ("tf32", "tf32_cores") if frames.is_cuda else ("tf32",)
    for p in precisions:
        low = torch.cat([ref_mod.logits(run.config, params, blk, precision=p)
                         for blk in torch.split(frames, 1024)])
        out[f"logits_rel_err[{p}]"] = float((low - ref).abs().max() / scale)
    return out
