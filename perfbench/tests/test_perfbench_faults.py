"""The comparison that decides ``correct`` fails when the timed path is
broken: a run at smoke size on the CPU, past the look for a card, with
each fault the cell can have planted where the program produces its
answers; and the control (the reference at the precision below the
configuration's) reads above each cell's limit."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from perfbench.lib import spec
from perfbench.tests import helpers


def test_sound_runs_are_correct():
    for cell in ("roshambo.kdrv.b1", "roshambo.kdrv.b32", "granite.chat"):
        out = helpers.execute(helpers.smoke_run(cell))
        assert out["correct"], (cell, out["checks"])
        assert out["attempted"] > 0 and out["failed"] == 0
        assert list(out)[-1] == "checks"


def _frames_fault(monkeypatch, kind):
    from repro_torch.accel import nullhop

    real = nullhop.NullHopExecutor.run_frame
    calls = {"n": 0}

    def broken(self, params, frame):
        calls["n"] += 1
        if kind == "half_batch":
            b = frame.shape[0]
            res = real(self, params, frame[: b // 2])
            mean = res.logits.mean(0, keepdims=True)
            res.logits = np.concatenate(
                [res.logits, np.repeat(mean, b - b // 2, 0)])
            return res
        res = real(self, params, frame)
        if calls["n"] % 7 == 3:  # an answer altered where it is produced
            res.logits = res.logits.copy()
            res.logits[0, 1] += 0.01 * np.abs(res.logits).max()
        return res

    monkeypatch.setattr(nullhop.NullHopExecutor, "run_frame", broken)


@pytest.mark.parametrize("cell,kind", [
    ("roshambo.kdrv.b1", "altered_answer"),
    ("roshambo.kdrv.b32", "altered_answer"),
    ("roshambo.kdrv.b32", "half_batch"),
])
def test_a_broken_frame_path_is_not_correct(monkeypatch, cell, kind):
    _frames_fault(monkeypatch, kind)
    out = helpers.execute(helpers.smoke_run(cell))
    assert not out["correct"], out["checks"]


def test_an_altered_token_is_not_correct(monkeypatch):
    """Every third decode step, each slot's token is moved off the
    program's argmax where the step produces it."""
    cb = spec.load_module("configs", "lm")
    real_program = cb.program

    def program(cfg):
        model = real_program(cfg)
        calls = {"n": 0}

        def decode(params, token, cache):
            logits, cache = model.decode(params, token, cache)
            calls["n"] += 1
            if calls["n"] % 3 == 0:
                v = cfg["vocab_size"]
                top = logits[:, -1, :v].argmax(-1)
                alt = (top + 1) % v
                rows = logits[:, -1]
                rows[range(rows.shape[0]), alt] = rows.max(-1).values + 1.0
            return logits, cache

        return dataclasses.replace(model, decode=decode)

    monkeypatch.setattr(cb, "program", program)
    out = helpers.execute(helpers.smoke_run("granite.chat"))
    assert not out["correct"], out["checks"]


def test_a_served_token_altered_after_its_step_is_not_correct(monkeypatch):
    """Every third step, each active request's newest token is replaced
    after the engine produced it (its logits left as they were)."""
    from repro_torch.serve import continuous

    real = continuous.ContinuousBatchingEngine.step
    calls = {"n": 0}

    def step(self):
        n = real(self)
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            v = self.model.cfg.vocab
            for q in self.slots:
                if q is not None and q.tokens:
                    q.tokens[-1] = (q.tokens[-1] + 1) % v
        return n

    monkeypatch.setattr(continuous.ContinuousBatchingEngine, "step", step)
    out = helpers.execute(helpers.smoke_run("granite.chat"))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", ["roshambo.kdrv.b1", "granite.chat"])
def test_the_control_is_not_correct(cell):
    run = helpers.smoke_run(cell, seconds=0.5)
    driver = spec.load_module("drivers", run.traffic["driver"])
    got = driver.control(run)
    failed = [k for k, v in got.items() if "[" in k
              and k.split("[")[0] in run.limits
              and v > run.limits[k.split("[")[0]]["limit"]]
    assert failed, got  # the control fails one of the cell's numbers
