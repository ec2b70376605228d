"""AST extraction for the concurrency analyzer (the port's copy of
``repro.analysis.model``; the extraction is the reference's, unchanged).

This module turns Python source into a lock-aware model of the package:

- which ``self.<attr>`` / module-level names are locks (``threading.Lock()``,
  ``RLock()``, ``Condition()``, or the :mod:`repro_torch.analysis.validated`
  factories ``make_lock``/``make_rlock``/``make_condition``);
- per function, the sequence of lock *acquisitions* (``with self._lock:``
  scopes, plus sticky ``self._lock.acquire(...)`` calls, which hold for the
  remainder of the enclosing scope), *field accesses* (``self.<attr>`` loads
  and stores) and *calls* — each tagged with the statically-held lock set at
  that point;
- source-comment annotations:

  ``# guarded-by: <lockattr>``   on a ``self.<field> = ...`` assignment (same
                                 line or the line above) declares the field
                                 protected by that lock attribute;
  ``# requires-lock: <lockattr>`` on a ``def`` line (or the line above)
                                 declares the function must be called with the
                                 lock held — its body is analyzed as if held,
                                 and same-class call sites are checked;
  ``# lock-ok: <reason>``        waives any finding anchored to that line;
  ``# analysis: skip-module``    anywhere in the file skips the whole module
                                 (back-compat shims).

Static conventions (documented in docs/concurrency.md): nested ``def``s are
analyzed with an *empty* held set (they run later, on other threads), while
lambdas and comprehensions inherit the current held set (they overwhelmingly
execute in place in this codebase).
"""
from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path

GUARDED_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
REQUIRES_RE = re.compile(r"#\s*requires-lock:\s*([A-Za-z_]\w*(?:\s*,\s*[A-Za-z_]\w*)*)")
WAIVER_RE = re.compile(r"#\s*lock-ok\b:?\s*(?P<reason>[^#]*)")
SKIP_RE = re.compile(r"#\s*analysis:\s*skip-module")

# Call(func=...) shapes that create a lock. Attribute form matches
# threading.Lock / threading.RLock / threading.Condition; Name form matches
# the validated factories (however they were imported).
_LOCK_KINDS = {
    "Lock": "lock",
    "RLock": "rlock",
    "Condition": "condition",
    "make_lock": "lock",
    "make_rlock": "rlock",
    "make_condition": "condition",
}


@dataclass(frozen=True)
class LockDecl:
    """A lock *class*: one per declaration site, identified across instances."""

    id: str          # "TransferEngine._ring_lock" / "runtime._global_lock"
    kind: str        # lock | rlock | condition
    module: str
    line: int


@dataclass(frozen=True)
class Access:
    attr: str
    line: int
    write: bool
    held: tuple[str, ...]


@dataclass(frozen=True)
class CallSite:
    name: str                    # dotted best-effort: "self._record", "time.sleep"
    last: str                    # final attribute / name
    receiver: str                # "self" | "bare" | "other"
    line: int
    held: tuple[str, ...]
    receiver_lock: str | None    # lock id when the receiver itself is a lock


@dataclass(frozen=True)
class AcquireSite:
    lock_id: str
    line: int
    held: tuple[str, ...]        # held *before* this acquisition


@dataclass
class FunctionInfo:
    qualname: str                # "module:Class.method" or "module:func"
    module: str
    class_name: str | None
    name: str
    line: int
    requires: tuple[str, ...] = ()
    accesses: list[Access] = field(default_factory=list)
    calls: list[CallSite] = field(default_factory=list)
    acquires: list[AcquireSite] = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    module: str
    line: int
    locks: dict[str, LockDecl] = field(default_factory=dict)       # attr -> decl
    guarded: dict[str, str] = field(default_factory=dict)          # field -> lock attr
    methods: dict[str, FunctionInfo] = field(default_factory=dict)  # top-level defs only


@dataclass
class ModuleInfo:
    name: str                    # dotted, e.g. "repro_torch.core.transfer"
    path: Path
    skipped: bool = False
    classes: dict[str, ClassInfo] = field(default_factory=dict)
    functions: dict[str, FunctionInfo] = field(default_factory=dict)
    module_locks: dict[str, LockDecl] = field(default_factory=dict)
    imports: dict[str, str] = field(default_factory=dict)          # local name -> dotted origin
    waivers: dict[int, str] = field(default_factory=dict)          # line -> reason
    annotation_errors: list[tuple[int, str]] = field(default_factory=list)

    @property
    def basename(self) -> str:
        return self.name.rsplit(".", 1)[-1]


@dataclass
class PackageModel:
    modules: dict[str, ModuleInfo] = field(default_factory=dict)

    def all_functions(self):
        for mod in self.modules.values():
            yield from mod.functions.values()

    def all_classes(self):
        for mod in self.modules.values():
            yield from mod.classes.values()


# ---------------------------------------------------------------------------
# comment scanning


def _scan_comments(source: str):
    """Per-line annotation maps. Line numbers are 1-based, matching ast.
    ``pure`` holds lines that are comment-only: the "annotation on the line
    above" convention only applies to those, so a *trailing* comment never
    leaks onto the next statement."""
    guarded: dict[int, str] = {}
    requires: dict[int, tuple[str, ...]] = {}
    waivers: dict[int, str] = {}
    pure: set[int] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        if "#" not in text:
            continue
        if text.lstrip().startswith("#"):
            pure.add(i)
        m = GUARDED_RE.search(text)
        if m:
            guarded[i] = m.group(1)
        m = REQUIRES_RE.search(text)
        if m:
            requires[i] = tuple(s.strip() for s in m.group(1).split(","))
        m = WAIVER_RE.search(text)
        if m:
            waivers[i] = (m.group("reason") or "").strip()
    return guarded, requires, waivers, pure


def _lock_kind_of_call(node: ast.expr) -> str | None:
    """Return lock kind if *node* is a lock-constructing call, else None."""
    if not isinstance(node, ast.Call):
        return None
    fn = node.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_KINDS:
        return _LOCK_KINDS[fn.attr]
    if isinstance(fn, ast.Name) and fn.id in _LOCK_KINDS:
        return _LOCK_KINDS[fn.id]
    return None


def _dotted(expr: ast.expr) -> str | None:
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute):
        base = _dotted(expr.value)
        return f"{base}.{expr.attr}" if base else f"?.{expr.attr}"
    return None


# ---------------------------------------------------------------------------
# function body walker


class _FnWalker:
    """Walks one function body tracking the statically-held lock set."""

    def __init__(self, mod: ModuleInfo, cls: ClassInfo | None, info: FunctionInfo,
                 local_locks: dict[str, str], requires_map: dict[int, tuple[str, ...]],
                 pure: set[int], out: list[FunctionInfo]):
        self.mod = mod
        self.cls = cls
        self.info = info
        self.local_locks = dict(local_locks)   # local var name -> lock id (closure-visible)
        self.requires_map = requires_map
        self.pure = pure
        self.out = out

    # -- lock expression resolution --------------------------------------

    def lock_for_expr(self, expr: ast.expr) -> str | None:
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls") and self.cls is not None):
            decl = self.cls.locks.get(expr.attr)
            if decl is not None:
                return decl.id
        if isinstance(expr, ast.Name):
            if expr.id in self.local_locks:
                return self.local_locks[expr.id]
            decl = self.mod.module_locks.get(expr.id)
            if decl is not None:
                return decl.id
        return None

    # -- statements -------------------------------------------------------

    def walk_body(self, stmts: list[ast.stmt], held: tuple[str, ...]):
        sticky: tuple[str, ...] = ()
        for st in stmts:
            h = held + tuple(l for l in sticky if l not in held)
            sticky += self.walk_stmt(st, h)

    def walk_stmt(self, st: ast.stmt, held: tuple[str, ...]) -> tuple[str, ...]:
        """Process one statement; returns locks sticky-acquired by it."""
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.walk_nested_def(st)
            return ()
        if isinstance(st, ast.ClassDef):
            for sub in st.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.walk_nested_def(sub)
            return ()
        if isinstance(st, ast.With):
            h = held
            for item in st.items:
                lid = self.lock_for_expr(item.context_expr)
                self.visit_expr(item.context_expr, h)
                if lid is not None:
                    self.info.acquires.append(AcquireSite(lid, item.context_expr.lineno, h))
                    if lid not in h:
                        h = h + (lid,)
            self.walk_body(st.body, h)
            return ()
        if isinstance(st, ast.If):
            s = self.visit_expr(st.test, held)
            h = held + tuple(l for l in s if l not in held)
            self.walk_body(st.body, h)
            self.walk_body(st.orelse, h)
            return s
        if isinstance(st, ast.While):
            s = self.visit_expr(st.test, held)
            h = held + tuple(l for l in s if l not in held)
            self.walk_body(st.body, h)
            self.walk_body(st.orelse, h)
            return s
        if isinstance(st, ast.For):
            s = self.visit_expr(st.iter, held)
            self.visit_expr(st.target, held)
            h = held + tuple(l for l in s if l not in held)
            self.walk_body(st.body, h)
            self.walk_body(st.orelse, h)
            return s
        if isinstance(st, ast.Try):
            self.walk_body(st.body, held)
            for handler in st.handlers:
                self.walk_body(handler.body, held)
            self.walk_body(st.orelse, held)
            self.walk_body(st.finalbody, held)
            return ()
        if isinstance(st, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            sticky: tuple[str, ...] = ()
            # local lock creation: name = threading.Lock()
            value = st.value
            if value is not None:
                kind = _lock_kind_of_call(value)
                targets = st.targets if isinstance(st, ast.Assign) else [st.target]
                if kind is not None:
                    for t in targets:
                        if isinstance(t, ast.Name):
                            self.local_locks[t.id] = (
                                f"{self.info.qualname}.<local>.{t.id}")
                sticky = self.visit_expr(value, held)
            for t in (st.targets if isinstance(st, ast.Assign) else [st.target]):
                self.visit_expr(t, held)
            return sticky
        # generic: visit all child expressions
        sticky = ()
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                sticky += self.visit_expr(child, held)
        return sticky

    def walk_nested_def(self, fndef: ast.FunctionDef | ast.AsyncFunctionDef):
        qual = f"{self.info.qualname}.<locals>.{fndef.name}"
        requires = _requires_for(fndef, self.requires_map, self.pure)
        info = FunctionInfo(qual, self.mod.name, self.cls.name if self.cls else None,
                            fndef.name, fndef.lineno)
        sub = _FnWalker(self.mod, self.cls, info, self.local_locks,
                        self.requires_map, self.pure, self.out)
        held0 = sub.resolve_requires(requires, fndef.lineno)
        info.requires = held0
        # closures run later, typically on other threads: empty held set
        sub.walk_body(fndef.body, held0)
        self.out.append(info)

    def resolve_requires(self, names: tuple[str, ...], line: int) -> tuple[str, ...]:
        ids = []
        for n in names:
            lid = None
            if self.cls is not None and n in self.cls.locks:
                lid = self.cls.locks[n].id
            elif n in self.mod.module_locks:
                lid = self.mod.module_locks[n].id
            if lid is None:
                self.mod.annotation_errors.append(
                    (line, f"requires-lock names unknown lock {n!r}"))
            else:
                ids.append(lid)
        return tuple(ids)

    # -- expressions -------------------------------------------------------

    def visit_expr(self, expr: ast.expr, held: tuple[str, ...]) -> tuple[str, ...]:
        """Record accesses/calls; returns sticky-acquired lock ids."""
        sticky: tuple[str, ...] = ()
        if isinstance(expr, ast.Attribute):
            if isinstance(expr.value, ast.Name) and expr.value.id == "self":
                self.info.accesses.append(Access(
                    expr.attr, expr.lineno,
                    isinstance(expr.ctx, (ast.Store, ast.Del)), held))
            sticky += self.visit_expr(expr.value, held)
            return sticky
        if isinstance(expr, ast.Call):
            name = _dotted(expr.func) or "?"
            last = expr.func.attr if isinstance(expr.func, ast.Attribute) else name
            if isinstance(expr.func, ast.Attribute):
                base = expr.func.value
                if isinstance(base, ast.Name) and base.id in ("self", "cls"):
                    receiver = "self"
                else:
                    receiver = "other"
                receiver_lock = self.lock_for_expr(base)
            else:
                receiver = "bare"
                receiver_lock = None
            self.info.calls.append(CallSite(name, last, receiver, expr.lineno,
                                            held, receiver_lock))
            # sticky lock acquisition: <lockexpr>.acquire(...)
            if (last == "acquire" and isinstance(expr.func, ast.Attribute)):
                lid = self.lock_for_expr(expr.func.value)
                if lid is not None:
                    self.info.acquires.append(AcquireSite(lid, expr.lineno, held))
                    sticky += (lid,)
            sticky += self.visit_expr(expr.func, held)
            for a in expr.args:
                sticky += self.visit_expr(a, held)
            for kw in expr.keywords:
                sticky += self.visit_expr(kw.value, held)
            return sticky
        if isinstance(expr, ast.Lambda):
            # lambdas overwhelmingly execute in place here: inherit held set
            self.visit_expr(expr.body, held)
            for d in expr.args.defaults + expr.args.kw_defaults:
                if d is not None:
                    self.visit_expr(d, held)
            return ()
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp)):
            for gen in expr.generators:
                self.visit_expr(gen.iter, held)
                self.visit_expr(gen.target, held)
                for cond in gen.ifs:
                    self.visit_expr(cond, held)
            if isinstance(expr, ast.DictComp):
                self.visit_expr(expr.key, held)
                self.visit_expr(expr.value, held)
            else:
                self.visit_expr(expr.elt, held)
            return ()
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, ast.expr):
                sticky += self.visit_expr(child, held)
        return sticky


def _annotation_at(table: dict, line: int, pure: set[int]):
    """Annotation on *line* itself, or on a comment-only line above it."""
    if line in table:
        return table[line]
    if line - 1 in table and line - 1 in pure:
        return table[line - 1]
    return None


def _requires_for(fndef, requires_map, pure) -> tuple[str, ...]:
    return _annotation_at(requires_map, fndef.lineno, pure) or ()


# ---------------------------------------------------------------------------
# module extraction


def _collect_class_locks(mod: ModuleInfo, cls: ast.ClassDef,
                         guarded_at: dict[int, str], pure: set[int]) -> ClassInfo:
    info = ClassInfo(cls.name, mod.name, cls.lineno)
    for node in cls.body:
        # dataclass-style: `_lock: threading.Lock = None  # placeholder`
        if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            ann = _annotation_at(guarded_at, node.lineno, pure)
            if ann is not None:
                info.guarded[node.target.id] = ann
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for st in ast.walk(node):
            if not isinstance(st, ast.Assign):
                continue
            kind = _lock_kind_of_call(st.value)
            for t in st.targets:
                if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    if kind is not None:
                        info.locks.setdefault(t.attr, LockDecl(
                            f"{cls.name}.{t.attr}", kind, mod.name, st.lineno))
                    # a multi-line assignment may carry the annotation on any
                    # of its physical lines (value ends on end_lineno)
                    ann = None
                    for line in range(st.lineno, (st.end_lineno or st.lineno) + 1):
                        if line in guarded_at:
                            ann = guarded_at[line]
                            break
                    if ann is None:
                        ann = _annotation_at(guarded_at, st.lineno, pure)
                    if ann is not None:
                        info.guarded[t.attr] = ann
    return info


def extract_module(source: str, modname: str, path: Path | str = "<memory>") -> ModuleInfo:
    mod = ModuleInfo(modname, Path(path))
    if SKIP_RE.search(source):
        mod.skipped = True
        return mod
    tree = ast.parse(source)
    guarded_at, requires_at, waivers, pure = _scan_comments(source)
    mod.waivers = waivers

    for node in tree.body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                mod.imports[alias.asname or alias.name.split(".")[0]] = alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            for alias in node.names:
                mod.imports[alias.asname or alias.name] = f"{node.module}.{alias.name}"
        elif isinstance(node, ast.Assign):
            kind = _lock_kind_of_call(node.value)
            if kind is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        mod.module_locks[t.id] = LockDecl(
                            f"{mod.basename}.{t.id}", kind, mod.name, node.lineno)

    # classes first (lock attrs must be known before walking bodies)
    for node in tree.body:
        if isinstance(node, ast.ClassDef):
            mod.classes[node.name] = _collect_class_locks(mod, node, guarded_at, pure)

    # validate guarded-by lock names
    for cls in mod.classes.values():
        for fld, lockattr in list(cls.guarded.items()):
            if lockattr not in cls.locks:
                mod.annotation_errors.append(
                    (cls.line, f"{cls.name}.{fld}: guarded-by names unknown "
                               f"lock {lockattr!r}"))
                del cls.guarded[fld]

    out: list[FunctionInfo] = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            info = FunctionInfo(f"{mod.name}:{node.name}", mod.name, None,
                                node.name, node.lineno)
            w = _FnWalker(mod, None, info, {}, requires_at, pure, out)
            held0 = w.resolve_requires(_requires_for(node, requires_at, pure),
                                       node.lineno)
            info.requires = held0
            w.walk_body(node.body, held0)
            out.append(info)
        elif isinstance(node, ast.ClassDef):
            cinfo = mod.classes[node.name]
            for sub in node.body:
                if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                info = FunctionInfo(f"{mod.name}:{node.name}.{sub.name}", mod.name,
                                    node.name, sub.name, sub.lineno)
                w = _FnWalker(mod, cinfo, info, {}, requires_at, pure, out)
                held0 = w.resolve_requires(_requires_for(sub, requires_at, pure),
                                           sub.lineno)
                info.requires = held0
                w.walk_body(sub.body, held0)
                out.append(info)
                cinfo.methods[sub.name] = info

    for fn in out:
        mod.functions[fn.qualname] = fn
    return mod


def extract_package(root: Path, package: str = "repro_torch",
                    exclude: tuple[str, ...] | None = None) -> PackageModel:
    """Extract every module under *root* (the directory containing the
    package). ``exclude`` defaults to the package's own ``analysis``
    directory, so ``package="repro"`` reads the reference tree exactly as
    the reference's analyzer does."""
    if exclude is None:
        exclude = (f"{package}/analysis",)
    pkg = PackageModel()
    pkg_dir = root / package
    for path in sorted(pkg_dir.rglob("*.py")):
        rel = path.relative_to(root)
        if any(str(rel).startswith(e) for e in exclude):
            continue
        modname = ".".join(rel.with_suffix("").parts)
        if modname.endswith(".__init__"):
            modname = modname[: -len(".__init__")]
        source = path.read_text()
        pkg.modules[modname] = extract_module(source, modname, path)
    return pkg
