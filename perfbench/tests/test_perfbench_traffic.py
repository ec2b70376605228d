"""Each traffic generator repeats exactly from its seed, and every seed
draws the same sizes (in another order)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench.lib import spec
from perfbench.tests import helpers  # noqa: F401  (the port's path)

SEEDS = (2**31 + 11, 2**33 + 5)


def _frames(cell, seed):
    frames = spec.load_module("drivers", "frames")
    run = helpers.smoke_run(cell, seed)
    return frames.make_frames(run.config, run.traffic, seed,
                              torch.device("cpu"))


def test_frames_repeat_from_seed():
    for cell in ("roshambo.kdrv.b1", "roshambo.kdrv.b32"):
        a, b = _frames(cell, SEEDS[0]), _frames(cell, SEEDS[0])
        assert torch.equal(a, b)
        assert not torch.equal(a, _frames(cell, SEEDS[1]))
        run = helpers.smoke_run(cell)
        hw = run.config["input_hw"]
        assert a.shape == (run.traffic["pool"], hw, hw, 1)
        assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0


def test_frames_hold_their_events():
    run = helpers.smoke_run("roshambo.kdrv.b1")
    tr = dict(run.traffic, clip=10**9)  # no clipping: the raw counts
    x = spec.load_module("drivers", "frames").make_frames(
        run.config, tr, SEEDS[0], torch.device("cpu"))
    counts = (x * tr["clip"]).round().sum(dim=(1, 2, 3))
    assert torch.all(counts == tr["events_per_frame"])


def test_chat_requests_repeat_from_seed():
    chat = spec.load_module("drivers", "chat")
    run = helpers.smoke_run("granite.chat")
    a = chat.make_requests(run.config, run.traffic, SEEDS[0])
    b = chat.make_requests(run.config, run.traffic, SEEDS[0])
    c = chat.make_requests(run.config, run.traffic, SEEDS[1])
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2])
    # another seed: the same lengths, another order and other ids
    assert sorted(len(p) for p in a[0]) == sorted(len(p) for p in c[0])
    assert sorted(a[1]) == sorted(c[1])
    assert not all(np.array_equal(x, y) for x, y in zip(a[0], c[0]))
    vocab = run.config["vocab_size"]
    assert all(p.min() >= 0 and p.max() < vocab for p in a[0])


def test_chat_lengths_follow_the_mix():
    chat = spec.load_module("drivers", "chat")
    tr = spec.cell("granite.chat")["traffic"]
    p = chat.lengths(tr["prompt"], tr["pool"])
    o = chat.lengths(tr["output"], tr["pool"])
    assert p.min() >= 64 and p.max() <= 2048 and np.median(p) == 512
    assert o.min() >= 16 and o.max() <= 384 and np.median(o) == 96
    assert p.max() + o.max() < tr["max_seq"] - 1
