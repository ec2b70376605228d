"""Split-K across the card's SMs, shared by the kernels that use it (the
BLOCKS matmul and conv2d).

When a kernel's output tiles are fewer than the card's SMs, its reduction
axis is cut into contiguous ranges of whole steps, one block each. Every
block writes an f32 partial of its tile to a scratch; the block that
arrives last at the tile's int counter sums the partials in slice order
and leaves the counter at 0 again. There are no float atomics, so two
calls give bitwise-equal results. ``split_plan`` and ``split_ranges`` are
pure functions of the shapes and the SM count; ``SPLIT_WORKSPACE`` keeps
the scratch per (device, stream)."""

from __future__ import annotations

import functools

import torch

from repro_torch.analysis.validated import make_lock


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.cache
def sm_count(index: int) -> int:
    """The streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(tiles: int, steps: int, sms: int) -> tuple[int, int]:
    """(splits, steps a split) for a grid of ``tiles`` output tiles whose
    reduction takes ``steps`` steps, on a card of ``sms`` SMs. Where the
    tiles are fewer than the SMs, the steps are cut into contiguous ranges,
    one block each, so that tiles x splits fills the card (at most one
    split a step, none empty); a grid that fills the card keeps one split,
    a single pass."""
    want = min(steps, sms // tiles) if tiles else 1
    if want <= 1:
        return 1, steps
    per = cdiv(steps, want)
    return cdiv(steps, per), per


def split_ranges(k: int, step: int, splits: int,
                 per: int) -> list[tuple[int, int]]:
    """The [k0, k1) range of each split over a reduction of length ``k``
    taken ``step`` at a time, ``per`` steps a split, in slice order."""
    return [(z * per * step, min(k, (z + 1) * per * step))
            for z in range(splits)]


class SplitWorkspace:
    """The split-K scratch, kept per (device, stream): f32 partials (at
    least splits x M x N of the launch) and one int counter per output
    tile, zeroed once (the last block of a tile leaves its counter at 0
    again). Launches on one stream run in order, so every split-K kernel
    of the port can share it. The buffers only grow. A caller holds the
    tensors it was given until its launch is enqueued, so a buffer that
    another thread replaces meanwhile is freed only then, and the caching
    allocator hands it out again only in that stream's order. Streams come
    from PyTorch's pool, which never frees them, so a handle names one
    stream for the life of the process (a stream wrapped with
    ``torch.cuda.ExternalStream`` must outlive its launches here)."""

    def __init__(self) -> None:
        self._lock = make_lock("SplitWorkspace._lock")
        # (device index, stream handle) -> (partials, counters)
        self._bufs: dict[tuple[int | None, int],  # guarded-by: _lock
                         tuple[torch.Tensor, torch.Tensor]] = {}

    def scratch(self, device: torch.device, stream: int, n_part: int,
                n_tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(partials, counters) of at least ``n_part`` floats and
        ``n_tiles`` zeroed ints for launches on ``stream`` of ``device``."""
        key = (device.index, stream)
        with self._lock:
            part, cnt = self._bufs.get(key, (None, None))
            if part is None or part.numel() < n_part:
                part = torch.empty(n_part, dtype=torch.float32, device=device)
            if cnt is None or cnt.numel() < n_tiles:
                cnt = torch.zeros(n_tiles, dtype=torch.int32, device=device)
            self._bufs[key] = (part, cnt)
            return part, cnt


SPLIT_WORKSPACE = SplitWorkspace()
