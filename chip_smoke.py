#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before a result is printed:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel of the path from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all started together);
3. TF32 off for the plain references (a float32 matmul or convolution on
   the card must stay float32 to be held against a float32 kernel);
4. each kernel against its plain PyTorch version on the card: conv2d at the
   five RoShamBo layer shapes for B = 1 and B = 32, ReLU on and off, f32 and
   bf16; the streamed matmul under UNIQUE and BLOCKS, f32 and bf16;
5. the main path: ``NullHopExecutor.run_frame`` on the card for a few
   frames under each policy of the Table I scenario plus the interrupt-
   driven ring, logits held against the port's ``RoShamBoCNN.apply`` (plain
   conv on the card); a Table-I row per policy, with the median per-chunk
   copy time and, from one more frame under ``torch.profiler``, the device
   time a frame holds; the conv kernel's launch count must rise by 10 per
   frame (5 layers + the 5-layer sparsity pass);
6. the streamed-matmul path: the RoShamBo classifier head of the same
   frames through ``streamed_matmul`` under each policy's partitioning;
7. each kernel timed at the path's shapes beside its bound, its plain
   version and one library call (the yardstick; the port never calls it);
8. a ``kernels`` JSON line, the card line, and the ``ok`` line last.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM published peaks (data sheet, 700 W part)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # CUDA-core float32: both kernels use f32 FMAs

CONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
MATMUL_TOL = {"float32": (2e-4, 2e-3), "bfloat16": (2e-2, 2e-1)}
LOGIT_TOL = (1e-4, 1e-4)
FRAMES_PER_POLICY = 4  # one warm-up frame + 3 timed (+1 profiled)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int = 50) -> float:
    """Mean device time of one ``fn()`` over ``iters`` back-to-back calls,
    by CUDA events, after a warm-up call (L2 warm, as in the streamed
    path where each layer's inputs were just written)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, flops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(torch, got, ref, tol) -> float:
    """Max |got - ref|; fails unless |got - ref| <= atol + rtol*|ref|."""
    g, r = got.float(), ref.float()
    if not bool(torch.isfinite(g).all()):
        fail("kernel output is not finite")
    diff = (g - r).abs()
    rtol, atol = tol
    if bool((diff > atol + rtol * r.abs()).any()):
        fail(f"kernel disagrees with its plain version: max err "
             f"{float(diff.max())} (rtol {rtol}, atol {atol})")
    return float(diff.max())


def main() -> None:
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the port's path needs a card")

    # 1. the card
    card = card_line()

    # 2. build
    from repro_torch.kernels._build import build_all
    from repro_torch.kernels.conv2d.kernel import CONV2D
    from repro_torch.kernels.conv2d.ops import conv2d_relu
    from repro_torch.kernels.conv2d.ref import conv2d_relu_ref
    from repro_torch.kernels.streamed_matmul.kernel import (
        MATMUL, matmul_blocks, matmul_unique, TILES, unique_fits)
    from repro_torch.kernels.streamed_matmul.ops import (
        block_dims_for, streamed_matmul)
    from repro_torch.kernels.streamed_matmul.ref import matmul_ref

    t0 = time.perf_counter()
    build_all([CONV2D, MATMUL])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for lib in (CONV2D, MATMUL):
        for line in lib.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {lib.name}: {line.strip()}")

    # 3. TF32 off for every plain reference and library call below
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    from repro_torch.accel.nullhop import NullHopExecutor
    from repro_torch.accel.roshambo import RoShamBoCNN
    from repro_torch.core.transfer import (
        Buffering, Management, Partitioning, TransferPolicy)

    cnn = RoShamBoCNN()
    layer_shapes = []  # (H, W, Cin, Cout) of each RoShamBo conv
    hw = cnn.cfg.input_hw
    for spec in cnn.cfg.layers:
        layer_shapes.append((hw, hw, spec.c_in, spec.c_out))
        hw = hw // 2 if spec.pool else hw

    # 4. kernels against their plain versions
    # max |kernel - plain| per kernel and dtype
    errs = {(kern, dt): 0.0 for kern in ("conv2d", "matmul_blocks",
                                         "matmul_unique")
            for dt in ("float32", "bfloat16")}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        tol = CONV_TOL[dt]
        for bsz in (1, 32):
            for h, w, cin, cout in layer_shapes:
                x = torch.randn((bsz, h, w, cin), generator=gen).to(dev, dtype)
                wt = (torch.randn((3, 3, cin, cout), generator=gen)
                      * (2.0 / (9 * cin)) ** 0.5).to(dev, dtype)
                b = (torch.randn((cout,), generator=gen) * 0.1).to(dev, dtype)
                for relu in (True, False):
                    got = conv2d_relu(x, wt, b, relu=relu)
                    ref = conv2d_relu_ref(x, wt, b, relu=relu)
                    torch.cuda.synchronize()
                    errs["conv2d", dt] = max(errs["conv2d", dt],
                                             max_err(torch, got, ref, tol))
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        tol = MATMUL_TOL[dt]
        for m, k, n in ((128, 128, 128), (256, 384, 512), (100, 70, 33),
                        (1, 2048, 4)):
            x = torch.randn((m, k), generator=gen).to(dev, dtype)
            w = torch.randn((k, n), generator=gen).to(dev, dtype)
            ref = matmul_ref(x, w)
            for bm, bn, bk in TILES:
                got = matmul_blocks(x, w, block_m=bm, block_n=bn, block_k=bk)
                errs["matmul_blocks", dt] = max(errs["matmul_blocks", dt],
                                                max_err(torch, got, ref, tol))
            if unique_fits(m, k, n, x.element_size()):
                got = matmul_unique(x, w)
                errs["matmul_unique", dt] = max(errs["matmul_unique", dt],
                                                max_err(torch, got, ref, tol))
    torch.cuda.synchronize()
    print(f"kernels vs plain: max abs err "
          f"{ {f'{k}/{d}': e for (k, d), e in errs.items()} } "
          f"(conv tol {CONV_TOL}, matmul tol {MATMUL_TOL})")

    # 5. the main path
    policies = [
        ("user-level polling", TransferPolicy.user_level_polling()),
        ("user-level drv scheduled", TransferPolicy.user_level_scheduled()),
        ("kernel-level drv", TransferPolicy.kernel_level()),
        ("kernel drv + double/blocks", TransferPolicy(
            Management.INTERRUPT, Buffering.DOUBLE, Partitioning.BLOCKS,
            block_bytes=1 << 16)),
        ("kernel drv ring (d4)", TransferPolicy.kernel_level_ring()),
    ]
    params = cnn.init(torch.Generator().manual_seed(1), device=dev)
    rng = np.random.default_rng(0)
    frames = [rng.standard_normal((1, 64, 64, 1)).astype(np.float32)
              for _ in range(FRAMES_PER_POLICY)]
    oracle = [cnn.apply(params, torch.from_numpy(f).to(dev)).cpu().numpy()
              for f in frames]
    rows, logits_seen = [], []
    n_frames = 0
    for lib in (CONV2D, MATMUL):
        lib.launches = dict.fromkeys(lib.launches, 0)
    for name, policy in policies:
        ex = NullHopExecutor(cnn, policy)
        if ex.engine.device.type != "cuda":
            fail(f"engine for {policy.tag} is on {ex.engine.device}")
        best = None

        def run_checked(i: int):
            nonlocal n_frames
            before = CONV2D.launches["conv2d_bias_act"]
            res = ex.run_frame(params, frames[i])
            n_frames += 1
            step = CONV2D.launches["conv2d_bias_act"] - before
            if step != 10:
                fail(f"{policy.tag}: conv kernel launched {step} times "
                     f"in one frame, expected 10")
            if not np.isfinite(res.logits).all() or res.logits.shape != (1, 4):
                fail(f"{policy.tag}: bad logits {res.logits}")
            np.testing.assert_allclose(res.logits, oracle[i],
                                       rtol=LOGIT_TOL[0], atol=LOGIT_TOL[1])
            if len(res.timing.layers) != 5:
                fail(f"{policy.tag}: {len(res.timing.layers)} layer timings")
            if not all(0.0 <= s <= 1.0 for s in res.sparsity):
                fail(f"{policy.tag}: sparsity {res.sparsity}")
            logits_seen.append((policy, frames[i], res.logits))
            return res

        try:
            for i in range(len(frames)):
                res = run_checked(i)
                if i and (best is None or res.timing.frame_s < best.timing.frame_s):
                    best = res
            # per-chunk copy times (the engine's own samples, _one only):
            # what the copy costs apart from queueing and completion
            samples = list(ex.engine.chunk_samples)
            # one more frame under the profiler, for the device time a frame
            # holds (kernels + copies); its wall time is not used
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                run_checked(1)
                torch.cuda.synchronize()
            device_ms = sum(getattr(e, "self_device_time_total", 0.0)
                            for e in prof.key_averages()) / 1e3
        finally:
            ex.close()
        chunk_us = {d: sorted(dt * 1e6 for dd, _m, _n, dt in samples
                              if dd == d) for d in ("tx", "rx")}
        t = best.timing
        rows.append({"mode": name, "policy": policy.tag,
                     "tx_us_per_B": t.tx_us_per_byte,
                     "rx_us_per_B": t.rx_us_per_byte,
                     "frame_ms": t.frame_s * 1e3,
                     "layers_ms": [[l.name, l.tx_s * 1e3, l.compute_s * 1e3,
                                    l.rx_s * 1e3] for l in t.layers],
                     "sparsity": best.sparsity,
                     "chunks_per_frame": {d: len(v) // len(frames)
                                          for d, v in chunk_us.items()},
                     "chunk_us_median": {d: v[len(v) // 2]
                                         for d, v in chunk_us.items()},
                     # device time of one (profiled) frame over the best
                     # frame's wall time; null when the trace held none
                     "device_ms": device_ms or None,
                     "device_busy_share": (device_ms / (t.frame_s * 1e3)
                                           if device_ms else None)})
    main_launches = dict(CONV2D.launches)
    if main_launches["conv2d_bias_act"] != 10 * n_frames:
        fail(f"conv launches {main_launches} over {n_frames} frames")
    print(f"main path: {n_frames} frames, launches {main_launches}")
    print(f"{'mode':28s} {'TX us/B':>10s} {'RX us/B':>10s} {'frame ms':>10s} "
          f"{'device ms':>10s}")
    for r in rows:
        print(f"{r['mode']:28s} {r['tx_us_per_B']:10.6f} "
              f"{r['rx_us_per_B']:10.6f} {r['frame_ms']:10.4f} "
              f"{r['device_ms'] or float('nan'):10.4f}")
    print("table_i " + json.dumps(rows))

    # 6. the streamed-matmul path: the classifier head on the card
    feats = []
    for policy, f, _ in logits_seen:
        x = torch.from_numpy(f).to(dev)
        for spec in cnn.cfg.layers:
            x = cnn.layer_apply(spec, params[spec.name], x,
                                conv=conv2d_relu_ref)
        feats.append(x.reshape(1, -1).contiguous())
    MATMUL.launches = dict.fromkeys(MATMUL.launches, 0)
    for (policy, _f, logits), feat in zip(logits_seen, feats):
        head = streamed_matmul(feat, params["fc"]["w"], policy) + params["fc"]["b"]
        np.testing.assert_allclose(head.cpu().numpy(), logits,
                                   rtol=LOGIT_TOL[0], atol=LOGIT_TOL[1])
    mm_launches = dict(MATMUL.launches)
    if min(mm_launches.values()) == 0:
        fail(f"streamed-matmul path skipped a kernel: {mm_launches}")
    print(f"streamed-matmul path: {len(feats)} heads, launches {mm_launches}")

    # 7. timing at the path's shapes (B = 1 frame)
    conv_in = []
    for h, w, cin, cout in layer_shapes:
        conv_in.append((
            torch.randn((1, h, w, cin), generator=gen).to(dev),
            (torch.randn((3, 3, cin, cout), generator=gen) * 0.1).to(dev),
            torch.zeros(cout).to(dev)))
    conv_kernel_ms = conv_plain_ms = conv_lib_ms = conv_bound = 0.0
    per_layer = []
    for (x, w, b), (h, wd, cin, cout) in zip(conv_in, layer_shapes):
        k_ms = time_ms(torch, lambda: conv2d_relu(x, w, b))
        p_ms = time_ms(torch, lambda: conv2d_relu_ref(x, w, b))
        xn, wn = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
        l_ms = time_ms(torch, lambda: F.conv2d(xn, wn, b, padding=1))
        nbytes = (x.numel() + w.numel() + b.numel() + h * wd * cout) * 4
        b_ms, _ = bound_ms(nbytes, 2 * h * wd * cout * 9 * cin)
        per_layer.append([h, wd, cin, cout, k_ms, p_ms, l_ms, b_ms])
        conv_kernel_ms += k_ms
        conv_plain_ms += p_ms
        conv_lib_ms += l_ms
        conv_bound += b_ms
    print("conv2d per layer [H, W, Cin, Cout, kernel_ms, plain_ms, "
          "library_ms, bound_ms]: " + json.dumps(per_layer))
    conv_bytes = sum((h * wd * cin + 9 * cin * cout + cout + h * wd * cout) * 4
                     for h, wd, cin, cout in layer_shapes)
    conv_flops = sum(2 * h * wd * cout * 9 * cin
                     for h, wd, cin, cout in layer_shapes)
    conv_by = bound_ms(conv_bytes, conv_flops)[1]

    fx = feats[0]
    fw = params["fc"]["w"]
    m, k = fx.shape
    n = fw.shape[1]
    bm, bn, bk = block_dims_for(policies[3][1], m, k, n, 4)
    mm_bound, mm_by = bound_ms((m * k + k * n + m * n) * 4, 2 * m * k * n)
    mm = {
        "matmul_blocks": time_ms(torch, lambda: matmul_blocks(
            fx, fw, block_m=bm, block_n=bn, block_k=bk)),
        "matmul_unique": time_ms(torch, lambda: matmul_unique(fx, fw)),
    }
    mm_plain = time_ms(torch, lambda: matmul_ref(fx, fw))
    mm_lib = time_ms(torch, lambda: torch.matmul(fx, fw))

    kernels = [{
        "name": "conv2d", "route": "cuda",
        "source": "src/repro_torch/kernels/conv2d/csrc/conv2d.cu",
        "replaces": "src/repro/kernels/conv2d/kernel.py:63",
        "launches": main_launches["conv2d_bias_act"],
        "max_abs_err": errs["conv2d", "float32"],
        "max_abs_err_bf16": errs["conv2d", "bfloat16"],
        "ms": conv_kernel_ms, "plain_ms": conv_plain_ms,
        "bound_ms": conv_bound, "bound_by": conv_by,
        "library_ms": conv_lib_ms,
    }]
    for sym, line in (("matmul_blocks", 61), ("matmul_unique", 92)):
        kernels.append({
            "name": sym, "route": "cuda",
            "source": "src/repro_torch/kernels/streamed_matmul/csrc/matmul.cu",
            "replaces": f"src/repro/kernels/streamed_matmul/kernel.py:{line}",
            "launches": mm_launches[sym],
            "max_abs_err": errs[sym, "float32"],
            "max_abs_err_bf16": errs[sym, "bfloat16"],
            "ms": mm[sym], "plain_ms": mm_plain, "bound_ms": mm_bound,
            "bound_by": mm_by, "library_ms": mm_lib,
        })
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
