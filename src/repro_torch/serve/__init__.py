"""Serving: the batched ServingEngine (``serve/continuous.py`` is not
ported yet, ROADMAP Queue 1 item 11)."""

from repro_torch.serve.engine import ServeConfig, ServingEngine  # noqa: F401
