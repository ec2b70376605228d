"""Concurrency static analysis + opt-in runtime lock validation for the port.

Static side (``python -m repro_torch.analysis``): lock-order cycle
detection over the package's static acquisition graph, ``# guarded-by:``
field checking, blocking-call-under-lock linting (the reference's
vocabulary plus the port's waits on the card: see
:mod:`repro_torch.analysis.rules`) and ``# requires-lock:`` call-site
checks. Runtime side (:mod:`repro_torch.analysis.validated`): the
``make_lock`` factories the core modules use, which become
order-validating wrappers under ``REPRO_VALIDATE_LOCKS=1``.

Only the standard library is imported here: ``repro_torch.core.runtime``
imports ``validated`` on its hot path. See docs/concurrency.md for the
annotation syntax and canonical lock order.
"""
from .baseline import load_baseline, split_new, write_baseline  # noqa: F401
from .cli import analyze_source, main  # noqa: F401
from .model import PackageModel, extract_module, extract_package  # noqa: F401
from .rules import RULES, Finding, run_rules  # noqa: F401
from .validated import (  # noqa: F401
    LockAssertionError,
    LockOrderViolation,
    ValidatedLock,
    assert_held,
    enable,
    enabled,
    make_condition,
    make_lock,
    make_rlock,
    order_graph,
)
