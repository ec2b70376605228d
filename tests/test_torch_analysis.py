"""The port's concurrency analyzer (``repro_torch.analysis``) held against
the reference's (``repro.analysis``): the same findings on every fixture of
``tests/test_analysis.py`` and over ``src/repro``; over ``src/repro_torch``
they differ only by what the port's blocking vocabulary adds (the card's
waits: ``synchronize``, ``.item()``, ``.tolist()``, ``.cpu()``, barriers),
which fires, is waivable and keeps the held-condition exemption. The CLI's
exit codes are the reference's, and the deprecated scheduler shim has its
twin.

    PYTHONPATH=src python -m pytest tests/test_torch_analysis.py
"""

import ast
import sys
import textwrap
import warnings
from pathlib import Path

import pytest

from repro.analysis import analyze_source as janalyze_source
from repro.analysis import extract_package as jextract_package
from repro.analysis import main as jmain
from repro.analysis import run_rules as jrun_rules
from repro_torch.analysis import (
    RULES,
    analyze_source,
    extract_module,
    extract_package,
    main,
    run_rules,
)
from repro_torch.analysis.rules import BLOCKING_DOTTED, BLOCKING_LAST

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT_VOCABULARY = {"torch.cuda.synchronize", "torch.distributed.barrier",
                   "dist.barrier", "synchronize", "item", "tolist", "cpu"}


def _fixtures() -> list[tuple[str, str]]:
    """Every source ``tests/test_analysis.py`` hands the analyzer: each
    literal passed to ``_src``, and each ``FIXTURE.format(waiver=...)``
    with the waiver it is formatted with."""
    path = ROOT / "tests" / "test_analysis.py"
    tree = ast.parse(path.read_text())
    consts = {t.id: node.value.value for node in tree.body
              if isinstance(node, ast.Assign)
              and isinstance(node.value, ast.Constant)
              and isinstance(node.value.value, str)
              for t in node.targets if isinstance(t, ast.Name)}
    out = []
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "_src" and node.args):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant):
                src = arg.value
            else:  # NAME.format(waiver="...")
                kw = {k.arg: k.value.value for k in arg.keywords}
                src = consts[arg.func.value.id].format(**kw)
            out.append((f"{fn.name}#{len(out)}", textwrap.dedent(src)))
    return out


FIXTURES = _fixtures()


def _key(f) -> tuple:
    return (f.rule, f.module, f.line, f.context, f.message, f.fingerprint,
            f.waived, f.waiver)


def test_fixtures_were_found():
    names = {n.split("#")[0] for n, _ in FIXTURES}
    assert len(FIXTURES) >= 17
    assert {"test_lock_order_cycle_detected", "test_guarded_by_waiver_suppresses",
            "test_skip_module_marker_skips_everything"} <= names


@pytest.mark.parametrize("name,source", FIXTURES, ids=[n for n, _ in FIXTURES])
def test_fixture_findings_match_reference(name, source):
    got = [_key(f) for f in analyze_source(source)]
    want = [_key(f) for f in janalyze_source(source)]
    assert got == want


def test_fixture_skip_module_matches_reference():
    from repro.analysis import extract_module as jextract_module
    src = dict(FIXTURES)[next(n for n, _ in FIXTURES
                              if n.startswith("test_skip_module"))]
    mod, jmod = extract_module(src, "shim"), jextract_module(src, "shim")
    assert mod.skipped and jmod.skipped
    assert mod.functions == jmod.functions == {}


def test_reference_tree_findings_match_reference():
    """Over ``src/repro`` the port's analyzer (JAX's names kept beside the
    card's) finds exactly what the reference's finds."""
    pkg = extract_package(SRC, package="repro")
    jpkg = jextract_package(SRC)
    assert sorted(pkg.modules) == sorted(jpkg.modules)
    got = [_key(f) + (f.path,) for f in run_rules(pkg)]
    want = [_key(f) + (f.path,) for f in jrun_rules(jpkg)]
    assert got == want


def test_port_tree_differs_only_by_the_port_vocabulary():
    """Over ``src/repro_torch`` every finding of the reference's analyzer is
    the port's too, and each finding only the port's analyzer makes is a
    blocking one that reaches a wait of the port's vocabulary. None of them
    is new: each stands at a ``# lock-ok:`` waiver."""
    pkg = extract_package(SRC)
    jpkg = jextract_package(SRC, package="repro_torch",
                            exclude=("repro_torch/analysis",))
    assert sorted(pkg.modules) == sorted(jpkg.modules)
    got = {_key(f): f for f in run_rules(pkg)}
    want = {_key(f) for f in jrun_rules(jpkg)}
    assert want <= set(got)
    for key in set(got) - want:
        f = got[key]
        assert f.rule == "blocking" and f.waived, f.render()
        assert any(f"{v}()" in f.message or f".{v}()" in f.message
                   for v in PORT_VOCABULARY), f.render()
    assert not [f for f in got.values() if not f.waived]


def test_vocabulary_is_the_reference_plus_the_ports():
    from repro.analysis.rules import BLOCKING_DOTTED as JDOTTED
    from repro.analysis.rules import BLOCKING_LAST as JLAST
    from repro.analysis.rules import DENY_METHOD_NAMES as JDENY
    from repro_torch.analysis.rules import DENY_METHOD_NAMES
    assert BLOCKING_DOTTED | BLOCKING_LAST == (
        JDOTTED | JLAST | PORT_VOCABULARY)
    assert "numpy" not in BLOCKING_LAST
    assert DENY_METHOD_NAMES == JDENY


CARD_WAIT = """
    import threading
    import torch

    class C:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition()

        def direct(self, ev, t):
            with self._lock:
                {call}{waiver}

        def outer(self, ev, t):
            with self._lock:
                self.helper(ev, t)

        def helper(self, ev, t):
            {call}{helper_waiver}

        def park(self):
            with self._cond:
                self._cond.wait()
"""

CALLS = ["torch.cuda.synchronize()", "ev.synchronize()", "t.item()",
         "t.tolist()", "t.cpu()", "torch.distributed.barrier()"]


def _card_wait(call, waiver="", helper_waiver=""):
    return textwrap.dedent(CARD_WAIT).format(
        call=call, waiver=waiver, helper_waiver=helper_waiver)


@pytest.mark.parametrize("call", CALLS)
def test_card_waits_under_a_lock_fire_directly_and_through_a_helper(call):
    found = analyze_source(_card_wait(call), rules=("blocking",))
    by_fn = {f.context.rsplit(".", 1)[-1]: f for f in found}
    assert set(by_fn) == {"direct", "outer"}, [f.render() for f in found]
    assert not any(f.waived for f in found)
    assert call.split("(")[0] in by_fn["direct"].message
    assert "reaches blocking" in by_fn["outer"].message
    # the reference's vocabulary cannot see them
    assert janalyze_source(_card_wait(call), rules=("blocking",)) == []


@pytest.mark.parametrize("call", CALLS)
def test_card_waits_are_waived_by_lock_ok(call):
    found = analyze_source(
        _card_wait(call, waiver="  # lock-ok: bounded by the test",
                   helper_waiver="  # lock-ok: bounded by the test"),
        rules=("blocking",))
    assert [f for f in found if not f.waived] == []
    assert {f.waiver for f in found} == {"bounded by the test"}


def test_numpy_view_under_a_lock_does_not_fire():
    src = textwrap.dedent("""
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def view(self, t):
                with self._lock:
                    return t.numpy()
    """)
    assert analyze_source(src) == []


def _cycle_tree(root: Path, package: str) -> None:
    (root / package).mkdir(parents=True)
    (root / package / "__init__.py").write_text("")
    src = dict(FIXTURES)[next(n for n, _ in FIXTURES
                              if n.startswith("test_lock_order_cycle"))]
    (root / package / "pair.py").write_text(src)


@pytest.mark.parametrize("package,run", [("repro_torch", main),
                                         ("repro", jmain)],
                         ids=["port", "reference"])
def test_cli_exit_codes_match_reference(tmp_path, package, run, capsys):
    _cycle_tree(tmp_path, package)
    root = str(tmp_path)
    baseline = str(tmp_path / "baseline.json")
    assert run([root]) == 1
    assert "lock-order cycle" in capsys.readouterr().out
    assert run([root, "--write-baseline", baseline]) == 0
    assert run([root, "--baseline", baseline, "--fail-on-new"]) == 0
    out = capsys.readouterr().out
    assert "0 new / 1 baselined / 0 waived" in out
    with pytest.raises(SystemExit) as e:
        run([root, "--rules", "no-such-rule"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        run([str(tmp_path / package)])  # holds no package of that name
    assert e.value.code == 2


def test_cli_summary_line_matches_reference_form(capsys):
    assert main([str(SRC), "--baseline", str(ROOT / "analysis_baseline.json"),
                 "--fail-on-new"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("analysis: ") and " modules (1 skipped), " in line
    assert line.endswith(" 0 new / 0 baselined / 7 waived finding(s)")
    assert jmain([str(SRC), "-q"]) == 0
    assert main([str(SRC), "-q"]) == 0
    assert capsys.readouterr().out == ""


def test_rules_list_matches_reference():
    from repro.analysis import RULES as JRULES
    assert RULES == JRULES


def test_scheduler_shim_warns_and_reexports():
    sys.modules.pop("repro_torch.core.scheduler", None)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        import repro_torch.core.scheduler as shim
    assert any(issubclass(w.category, DeprecationWarning)
               and "repro_torch.core.runtime" in str(w.message)
               for w in caught)
    from repro_torch.core.runtime import CooperativeScheduler, SchedulerStats
    assert shim.CooperativeScheduler is CooperativeScheduler
    assert shim.SchedulerStats is SchedulerStats
    assert extract_module((SRC / "repro_torch" / "core" / "scheduler.py")
                          .read_text(), "repro_torch.core.scheduler").skipped
