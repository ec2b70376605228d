#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before a result is printed:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel from ``src/repro_torch/kernels/*/csrc``
   (one ``nvcc`` per source, all started together);
3. TF32 off for the plain references (a float32 matmul or convolution on
   the card must stay float32 to be held against a float32 kernel);
4. each kernel against its plain PyTorch version on the card: conv2d at the
   five RoShamBo layer shapes for B = 1 and B = 32, ReLU on and off, f32 and
   bf16; the streamed matmul under UNIQUE and BLOCKS, f32 and bf16; flash
   attention at qwen2.5-3b's heads (16/2, D 128, causal, S 128 and 2048,
   B 2), h2o-danube's (32/8, D 80, S 4096, window 0 / 1024 / 4096), one
   non-causal case with Sq != Skv and ragged causal S = 1000 (D 160 and a
   D 64 window), f32 and bf16 (the bf16 limit scales with each output
   row's RMS; a ``flash_cases`` line gives each case's error);
5. the NullHop path: ``NullHopExecutor.run_frame`` on the card for a few
   frames under each policy of the Table I scenario plus the interrupt-
   driven ring, logits held against the port's ``RoShamBoCNN.apply`` (plain
   conv on the card); a Table-I row per policy, with the median per-chunk
   copy time and, from one more frame under ``torch.profiler``, the device
   time a frame holds; the conv kernel's launch count must rise by 10 per
   frame (5 layers + the 5-layer sparsity pass);
6. the streamed-matmul path: the RoShamBo classifier head of the same
   frames through ``streamed_matmul`` under each policy's partitioning;
7. the LM scoring path: qwen2.5-3b at full width (36 layers, weights from a
   CUDA generator seeded with 0), ``Model.forward`` / ``Model.loss`` over
   B 2 x S 2048 tokens with ``use_pallas_attention`` on: exactly 36 flash
   launches a forward, f32 logits held against the plain-attention forward,
   bf16 losses and forward wall times of both (an ``lm_score`` line);
8. the serving path: ``ServingEngine.generate`` on the same model in bf16,
   4 prompts x 128 tokens, 32 new tokens, greedy, under the kernel-level
   (interrupt) and the user-level polling policies, twice each: identical
   tokens across all four (an ``lm_serve`` line);
9. each kernel timed at its path's shapes beside its bound, its plain
   version and one library call (the yardstick; the port never calls it);
10. a ``kernels`` JSON line, the card line, and the ``ok`` line last.
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
FP32_FLOPS = 67e12  # CUDA-core float32 (the conv and matmul work is f32)
BF16_FLOPS = 989e12  # dense bf16 tensor cores (the flash path's bf16 work)

CONV_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-2)}
MATMUL_TOL = {"float32": (2e-4, 2e-3), "bfloat16": (2e-2, 2e-1)}
LOGIT_TOL = (1e-4, 1e-4)
# flash, f32: tests/test_kernels.py's rtol = atol = 2e-4. bf16: a fixed
# 5e-2 would be as large as the outputs of the long-sequence cases (a late
# row averages thousands of randn values: RMS ~ 0.02), and one RMS for the
# whole case is too small for the early rows (row 0 is v itself, RMS ~ 1,
# where p's bf16 rounding moves the sum most). So the bf16 limit scales
# with each output row: |d| <= 2e-2 |ref| + 0.05 RMS(ref row over D). The
# ``flash_cases`` line gives each case's max |d| / RMS(row) and its max
# (|d| - 2e-2 |ref|) / RMS(row), the reading held to 0.05.
FLASH_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (2e-2, None)}
FLASH_BF16_ATOL_ROW_RMS = 0.05
# (B, Sq, Skv, H, Hkv, D, causal, window)
FLASH_CASES = [(2, 128, 128, 16, 2, 128, True, 0),
               (2, 2048, 2048, 16, 2, 128, True, 0),
               (1, 4096, 4096, 32, 8, 80, True, 0),
               (1, 4096, 4096, 32, 8, 80, True, 1024),
               (1, 4096, 4096, 32, 8, 80, True, 4096),
               (2, 200, 333, 8, 2, 64, False, 0),
               (2, 1000, 1000, 8, 4, 160, True, 0),
               (1, 1000, 1000, 4, 4, 64, True, 96)]
# full-width LM logits, flash kernel vs plain attention_unique, both f32 on
# the card (tests/test_pallas_wiring.py holds the smoke model at atol 1e-3)
LM_LOGIT_ATOL = 1e-3
LM_BATCH, LM_SEQ = 2, 2048
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 32
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


def bound_ms(nbytes: int, flops: int,
             peak_flops: float = FP32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
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


def device_events(torch, prof) -> list[tuple[str, float, int]]:
    """(name, ms, count) of the device-side entries of a ``torch.profiler``
    trace: kernels, copies and fills. A CPU op's own
    ``self_device_time_total`` repeats the time of the kernels it launched,
    so summing every entry would count that time twice."""
    cuda = torch.autograd.DeviceType.CUDA
    return [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == cuda]


def device_profile(torch, fn, top: int = 6) -> dict:
    """One ``fn()`` under ``torch.profiler``: its wall time, the device
    time the trace holds and the costliest device entries."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ev = device_events(torch, prof)
    device = sum(t for _, t, _ in ev)
    return {"wall_ms": wall, "device_ms": device,
            "device_busy_share": device / wall,
            "device_launches": sum(n for _, _, n in ev),
            "top_ms": [[k[:72], t, n] for k, t, n in
                       sorted(ev, key=lambda e: -e[1])[:top]]}


def _cast_weights(params: dict, dtype) -> dict:
    """The same weights in ``dtype``; norm params stay f32, as the
    reference keeps them in every dtype."""
    return {k: (v if k in ("ln1", "ln2", "final_norm")
                else _cast_weights(v, dtype)) if isinstance(v, dict)
            else v.to(dtype) for k, v in params.items()}


def lm_paths(np, torch, dev, libs, flash_lib):
    """7. the LM scoring path and 8. the serving path, qwen2.5-3b at full
    width; each driven with every launch count set to 0 just before it and
    read just after. Returns the scoring path's flash launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.transfer import TransferPolicy
    from repro_torch.models.api import build_model
    from repro_torch.serve.engine import ServeConfig, ServingEngine

    sym = "flash_attention_fwd"
    cfg = get_config("qwen2.5-3b", dtype="float32")
    t0 = time.perf_counter()
    # drawn on the card by a CUDA generator (Philox) seeded with 0: 3.4e9
    # normal draws on the host's CPU would take minutes
    params = build_model(cfg).init(torch.Generator(dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    seq = rng.integers(0, cfg.vocab, (LM_BATCH, LM_SEQ + 1), dtype=np.int64)
    batch = {"tokens": torch.from_numpy(seq[:, :-1]).to(dev),
             "labels": torch.from_numpy(seq[:, 1:]).to(dev)}
    flash_m = {dt: build_model(cfg.replace(dtype=dt, use_pallas_attention=True))
               for dt in ("float32", "bfloat16")}
    plain_m = {dt: build_model(cfg.replace(dtype=dt))
               for dt in ("float32", "bfloat16")}

    def flash_run(fn):
        """One forward through the flash kernel: exactly one launch a
        layer."""
        before = flash_lib.launches[sym]
        out = fn()
        torch.cuda.synchronize()
        if flash_lib.launches[sym] - before != cfg.n_layers:
            fail(f"flash kernel launched {flash_lib.launches[sym] - before} "
                 f"times in one forward, expected {cfg.n_layers}")
        return out

    def wall_ms(fn, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3)
        return best

    score = {"model": cfg.name, "params": cfg.param_count(),
             "batch": LM_BATCH, "seq": LM_SEQ, "init_s": init_s}
    for lib in libs:
        lib.launches = dict.fromkeys(lib.launches, 0)
    with torch.no_grad():
        lf, _ = flash_run(lambda: flash_m["float32"].forward(params, batch))
        lp, _ = plain_m["float32"].forward(params, batch)
        torch.cuda.synchronize()
        want = (LM_BATCH, LM_SEQ, cfg.vocab_padded)
        if tuple(lf.shape) != want or not bool(torch.isfinite(lf).all()):
            fail(f"LM logits {tuple(lf.shape)} (want {want}) or not finite")
        err = float((lf - lp).abs().max())
        score["f32"] = {"max_abs_err": err, "atol": LM_LOGIT_ATOL,
                        "logit_absmax": float(lp.abs().max())}
        if err > LM_LOGIT_ATOL:
            fail(f"f32 logits, flash vs plain attention: max abs err {err} "
                 f"> atol {LM_LOGIT_ATOL}")
        del lf, lp
        score["f32"]["loss_flash"] = float(flash_run(
            lambda: flash_m["float32"].loss(params, batch))[0])
        score["f32"]["loss_plain"] = float(
            plain_m["float32"].loss(params, batch)[0])
        params16 = _cast_weights(params, torch.bfloat16)
        del params
        torch.cuda.empty_cache()
        lfl = float(flash_run(lambda: flash_m["bfloat16"].loss(params16,
                                                               batch))[0])
        lpl = float(plain_m["bfloat16"].loss(params16, batch)[0])
        if not (np.isfinite(lfl) and np.isfinite(lpl)):
            fail(f"bf16 losses not finite: {lfl}, {lpl}")
        score["bf16"] = {
            "loss_flash": lfl, "loss_plain": lpl,
            "forward_ms_flash": wall_ms(lambda: flash_run(
                lambda: flash_m["bfloat16"].forward(params16, batch))),
            "forward_ms_plain": wall_ms(
                lambda: plain_m["bfloat16"].forward(params16, batch)),
            "profile_flash_forward": device_profile(torch, lambda: flash_run(
                lambda: flash_m["bfloat16"].forward(params16, batch)))}
    torch.cuda.synchronize()
    lm_launches = flash_lib.launches[sym]
    score["launches"] = {lib.name: dict(lib.launches) for lib in libs}
    score["forwards_through_flash"] = lm_launches // cfg.n_layers
    if lm_launches == 0:
        fail("the LM scoring path never launched the flash kernel")
    print("lm_score " + json.dumps(score))

    # 8. serving, bf16, the reference's default config (its decode steps
    # read the KV cache, so they never reach the flash kernel)
    model = plain_m["bfloat16"]
    prompts = rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           dtype=np.int32)
    scfg = ServeConfig(max_batch=SERVE_BATCH,
                       max_seq=SERVE_PROMPT + SERVE_NEW + 8)
    rows, first = [], None
    for lib in libs:
        lib.launches = dict.fromkeys(lib.launches, 0)
    for name, policy in (("kernel-level", TransferPolicy.kernel_level()),
                         ("user-level polling",
                          TransferPolicy.user_level_polling())):
        eng = ServingEngine(model, params16, scfg, policy=policy)
        if eng.engine.device.type != "cuda":
            fail(f"serving engine for {policy.tag} is on {eng.engine.device}")
        try:
            for rep in range(2):
                res = eng.generate(prompts, max_new_tokens=SERVE_NEW)
                toks = np.stack([r.tokens for r in res])
                if toks.shape != (SERVE_BATCH, SERVE_NEW) or not (
                        (toks >= 0) & (toks < cfg.vocab)).all():
                    fail(f"{policy.tag}: bad tokens {toks}")
                if first is None:
                    first = toks
                elif not np.array_equal(toks, first):
                    fail(f"{policy.tag} run {rep}: greedy tokens differ "
                         f"from the first run's")
                r0 = res[0]
                rows.append({"policy": policy.tag, "run": rep,
                             "prefill_ms": r0.prefill_s * 1e3,
                             "decode_ms": r0.decode_s * 1e3,
                             "tokens_per_s": SERVE_BATCH * SERVE_NEW
                             / r0.decode_s,
                             "tokens_per_s_per_request": r0.tokens_per_s,
                             "tx_bytes": eng.engine.tx_bytes_total,
                             "rx_bytes": eng.engine.rx_bytes_total})
        finally:
            eng.close()
    # where a decode step's time goes: one step after a prefill of the
    # same prompts, under the profiler
    with torch.no_grad():
        tok = torch.from_numpy(prompts).to(dev)
        _, cache = model.prefill(params16, {"tokens": tok}, scfg.max_seq)
        step = device_profile(torch, lambda: model.decode(
            params16, tok[:, -1:], cache))
    print("lm_serve " + json.dumps({
        "model": cfg.name, "dtype": "bfloat16", "batch": SERVE_BATCH,
        "prompt": SERVE_PROMPT, "new_tokens": SERVE_NEW, "runs": rows,
        "tokens_head": first[:, :8].tolist(), "profile_decode_step": step,
        "launches": {lib.name: dict(lib.launches) for lib in libs}}))
    del params16
    torch.cuda.empty_cache()
    return lm_launches


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

    from repro_torch.kernels.flash_attention.kernel import FLASH
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_plain)

    t0 = time.perf_counter()
    build_all([CONV2D, MATMUL, FLASH])
    print(f"build: {time.perf_counter() - t0:.2f} s")
    for lib in (CONV2D, MATMUL, FLASH):
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
                                         "matmul_unique", "flash_attention")
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
    flash_cases, flash_bad = [], []
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype).split(".")[1]
        for case in FLASH_CASES:
            b, sq, skv, h, hkv, d, causal, window = case
            q = torch.randn((b, sq, h, d), generator=gen).to(dev, dtype)
            k = torch.randn((b, skv, hkv, d), generator=gen).to(dev, dtype)
            v = torch.randn((b, skv, hkv, d), generator=gen).to(dev, dtype)
            got = flash_attention(q, k, v, causal=causal,
                                  window=window).float()
            ref = flash_attention_plain(q, k, v, causal=causal,
                                        window=window).float()
            if not bool(torch.isfinite(got).all()):
                fail(f"flash {dt} {case}: output is not finite")
            diff = (got - ref).abs()
            row_rms = ref.pow(2).mean(-1, keepdim=True).sqrt()
            rtol, atol = FLASH_TOL[dt]
            if atol is None:
                atol = FLASH_BF16_ATOL_ROW_RMS * row_rms
            if bool((diff > atol + rtol * ref.abs()).any()):
                flash_bad.append((dt, case))
            err = float(diff.max())
            errs["flash_attention", dt] = max(errs["flash_attention", dt],
                                              err)
            flash_cases.append({
                "dtype": dt, "case": list(case), "max_abs_err": err,
                "max_err_over_row_rms": float((diff / row_rms).max()),
                "max_excess_over_row_rms": float(
                    ((diff - rtol * ref.abs()) / row_rms).max())})
    torch.cuda.synchronize()
    print("flash_cases " + json.dumps(flash_cases))
    if flash_bad:
        fail(f"flash kernel disagrees with its plain version in {flash_bad} "
             f"(tol {FLASH_TOL}, bf16 atol {FLASH_BF16_ATOL_ROW_RMS} x the "
             f"row's RMS)")
    print(f"kernels vs plain: max abs err "
          f"{ {f'{k}/{d}': e for (k, d), e in errs.items()} } "
          f"(conv tol {CONV_TOL}, matmul tol {MATMUL_TOL}, "
          f"flash tol {FLASH_TOL})")

    # 5. the NullHop path
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
    for lib in (CONV2D, MATMUL, FLASH):
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
            device_ms = sum(t for _, t, _ in device_events(torch, prof))
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
    for lib in (CONV2D, MATMUL, FLASH):
        lib.launches = dict.fromkeys(lib.launches, 0)
    for (policy, _f, logits), feat in zip(logits_seen, feats):
        head = streamed_matmul(feat, params["fc"]["w"], policy) + params["fc"]["b"]
        np.testing.assert_allclose(head.cpu().numpy(), logits,
                                   rtol=LOGIT_TOL[0], atol=LOGIT_TOL[1])
    mm_launches = dict(MATMUL.launches)
    if min(mm_launches.values()) == 0:
        fail(f"streamed-matmul path skipped a kernel: {mm_launches}")
    print(f"streamed-matmul path: {len(feats)} heads, launches {mm_launches}")

    # 7. the LM scoring path, 8. the serving path
    lm_launches = lm_paths(np, torch, dev, (CONV2D, MATMUL, FLASH),
                           FLASH)

    # 9. timing at the paths' shapes (B = 1 frame for conv and matmul)
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
    # flash at the LM path's shape: qwen2.5-3b heads, B 2, S 2048, causal,
    # bf16 (the f32 kernel's time at the same shape beside it)
    b, s_, h, hkv, d = LM_BATCH, LM_SEQ, 16, 2, 128
    fq = torch.randn((b, s_, h, d), generator=gen).to(dev, torch.bfloat16)
    fk = torch.randn((b, s_, hkv, d), generator=gen).to(dev, torch.bfloat16)
    fv = torch.randn((b, s_, hkv, d), generator=gen).to(dev, torch.bfloat16)
    fl_ms = time_ms(torch, lambda: flash_attention(fq, fk, fv), iters=20)
    fl_plain = time_ms(torch, lambda: flash_attention_plain(fq, fk, fv),
                       iters=20)
    qt, kt, vt = (t.transpose(1, 2) for t in (fq, fk, fv))
    fl_lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), iters=20)
    fq32, fk32, fv32 = fq.float(), fk.float(), fv.float()
    fl_ms32 = time_ms(torch, lambda: flash_attention(fq32, fk32, fv32),
                      iters=20)
    # causal: the (q, k) pairs this run visits, S (S + 1) / 2 per head, two
    # products of 2 D FLOPs each; q, k, v read and o written once
    fl_flops = 4 * b * h * d * s_ * (s_ + 1) // 2
    fl_bytes = (2 * b * s_ * h * d + 2 * b * s_ * hkv * d) * 2
    fl_bound, fl_by = bound_ms(fl_bytes, fl_flops, BF16_FLOPS)
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:115",
        "launches": lm_launches,
        "max_abs_err": errs["flash_attention", "float32"],
        "max_abs_err_bf16": errs["flash_attention", "bfloat16"],
        "ms": fl_ms, "ms_f32": fl_ms32, "plain_ms": fl_plain,
        "bound_ms": fl_bound, "bound_by": fl_by, "library_ms": fl_lib,
    })
    torch.cuda.synchronize()
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
