"""Each plain reference agrees with the port at smoke size on the CPU, and
its control (the precision below the configuration's) does not."""

from __future__ import annotations

import dataclasses

import torch

from perfbench.lib import spec
from perfbench.tests import helpers

SEED = 2**31 + 3


def test_roshambo_reference_matches_the_port():
    from repro_torch.accel.roshambo import ConvSpec  # noqa: F401

    run = helpers.smoke_run("roshambo.kdrv.b1", SEED)
    cb = spec.load_module("configs", "roshambo")
    ref = spec.load_module("reference", "roshambo")
    params = cb.make_params(run.config, SEED, "cpu")
    frames = spec.load_module("drivers", "frames").make_frames(
        run.config, run.traffic, SEED, torch.device("cpu"))[:16]
    got = cb.program(run.config).apply(params, frames)
    want = ref.logits(run.config, params, frames)
    scale = want.square().mean().sqrt()
    assert float((got - want).abs().max() / scale) < 1e-5
    low = ref.logits(run.config, params, frames, precision="tf32")
    assert float((low - want).abs().max() / scale) > 1e-4


def test_lm_reference_matches_the_port():
    run = helpers.smoke_run("granite.chat", SEED)
    cb = spec.load_module("configs", "lm")
    ref = spec.load_module("reference", "lm")
    params = cb.make_params(run.config, SEED, "cpu")
    model = cb.program(run.config)
    model = dataclasses.replace(model, cfg=model.cfg.replace(remat=False))
    g = torch.Generator().manual_seed(SEED)
    tokens = torch.randint(0, run.config["vocab_size"], (1, 40), generator=g)
    with torch.no_grad():
        got = model.forward(params, {"tokens": tokens})[0][0]
    v = run.config["vocab_size"]
    rows = torch.arange(40)
    want = ref.logits(run.config, params, tokens[0], rows)
    assert float((got[:, :v] - want).abs().max()) < 1e-4
    low = ref.logits(run.config, params, tokens[0], rows, fp8=True)
    assert float((low - want).abs().max()) > 1e-2


def test_lm_decode_through_the_cache_matches_the_reference():
    """The serving path (prefill, then decode through the KV cache) at
    smoke size against the reference's whole-sequence logits."""
    run = helpers.smoke_run("granite.chat", SEED)
    cb = spec.load_module("configs", "lm")
    ref = spec.load_module("reference", "lm")
    params = cb.make_params(run.config, SEED, "cpu")
    model = cb.program(run.config)
    g = torch.Generator().manual_seed(SEED + 1)
    seq = torch.randint(0, run.config["vocab_size"], (24,), generator=g)
    v = run.config["vocab_size"]
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": seq[None, :16]}, 32)
        rows = [lg[0, -1, :v]]
        for t in seq[16:]:
            lg, cache = model.decode(params, t.view(1, 1), cache)
            rows.append(lg[0, -1, :v])
    want = ref.logits(run.config, params, seq, torch.arange(15, 24))
    assert float((torch.stack(rows) - want).abs().max()) < 1e-4
