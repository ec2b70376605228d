"""The concurrency rules: lock-order, guarded-by, blocking-under-lock,
requires-lock call-site checking, plus annotation hygiene.

All rules consume the :class:`~repro_torch.analysis.model.PackageModel` and emit
:class:`Finding`s. ``# lock-ok:`` waivers (matched by line) suppress findings
at their anchor line; waived blocking sites also do not propagate through the
transitive call-graph (an accepted block is accepted everywhere).

Call resolution is name-based and deliberately conservative:

- ``self.method()`` resolves to the same class only;
- bare calls resolve to same-module functions, then package entities through
  the import map (constructors resolve to ``__init__``);
- ``obj.method()`` on an unknown receiver unions over every package class
  method of that name, *except* names in :data:`DENY_METHOD_NAMES` (common
  container/threading vocabulary like ``get``/``append``/``wait`` whose union
  would drown the graph in false edges).

The blocking vocabulary is the reference's (``time.sleep``,
``jax.device_put`` / ``jax.device_get``, ``.block_until_ready()``, the
ticket and transfer waits) plus the port's waits on the card, which the
reference's names cannot see:

- ``torch.cuda.synchronize()`` and ``.synchronize()`` of any receiver (a
  CUDA event, a stream, the card): the host sleeps until the device
  reaches that point;
- ``.item()``, ``.tolist()`` and ``.cpu()``: host reads of a device tensor,
  which wait for every kernel queued before them;
- ``torch.distributed.barrier()`` / ``dist.barrier()``: a wait on every
  other rank.

``.numpy()`` stays out: in the port it is only ever a view of a host
tensor (the pinned staging buffers), and ``.numpy()`` of a CUDA tensor
raises instead of waiting. A held condition's own ``wait`` stays exempt,
as in the reference, since it releases the lock it waits on.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from .model import FunctionInfo, PackageModel

RULES = ("lock-order", "guarded-by", "blocking", "requires-lock", "annotation")

# method names never union-resolved across classes (builtin container /
# threading / numpy vocabulary — a name match carries no signal)
DENY_METHOD_NAMES = {
    "get", "set", "add", "pop", "popleft", "append", "appendleft", "extend",
    "remove", "discard", "clear", "update", "items", "keys", "values", "copy",
    "sort", "sorted", "index", "count", "insert", "reverse", "setdefault",
    "join", "split", "strip", "startswith", "endswith", "format", "encode",
    "decode", "read", "write", "flush", "seek", "tell", "acquire", "release",
    "locked", "notify", "notify_all", "wait", "wait_for", "put", "put_nowait",
    "get_nowait", "empty", "qsize", "full", "task_done", "start", "run",
    "is_alive", "is_set", "mean", "std", "min", "max", "sum", "item",
    "tolist", "astype", "reshape", "result", "done", "total_seconds",
    # reporting vocabulary: 6+ unrelated classes define summary()
    "summary",
}

# JAX's blocking names stay, so that over the reference tree this module
# finds exactly what ``repro.analysis.rules`` finds; the port's own waits
# on the card are added beside them.
BLOCKING_DOTTED = {"time.sleep", "jax.device_put", "jax.device_get",
                   "torch.cuda.synchronize", "torch.distributed.barrier",
                   "dist.barrier"}
BLOCKING_LAST = {"wait", "wait_for", "tx", "rx", "tx_async", "rx_async",
                 "block_until_ready",
                 "synchronize", "item", "tolist", "cpu"}


@dataclass(frozen=True)
class Finding:
    rule: str
    module: str
    path: str
    line: int
    context: str          # function/class qualname the finding anchors to
    message: str
    key: str              # line-number-free fingerprint component
    waived: bool = False
    waiver: str = ""

    @property
    def fingerprint(self) -> str:
        return f"{self.rule}:{self.module}:{self.context}:{self.key}"

    def render(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}: [{self.rule}]{tag} {self.message}"


@dataclass
class _Index:
    methods_by_name: dict[str, list[FunctionInfo]] = field(default_factory=dict)
    funcs_by_qual: dict[str, FunctionInfo] = field(default_factory=dict)
    class_init: dict[str, FunctionInfo] = field(default_factory=dict)  # "mod.Cls" -> __init__
    lock_kinds: dict[str, str] = field(default_factory=dict)           # lock id -> kind


def _build_index(pkg: PackageModel) -> _Index:
    idx = _Index()
    for mod in pkg.modules.values():
        for decl in mod.module_locks.values():
            idx.lock_kinds[decl.id] = decl.kind
        for cls in mod.classes.values():
            for decl in cls.locks.values():
                idx.lock_kinds[decl.id] = decl.kind
            for name, fn in cls.methods.items():
                idx.methods_by_name.setdefault(name, []).append(fn)
                if name == "__init__":
                    idx.class_init[f"{mod.name}.{cls.name}"] = fn
        for fn in mod.functions.values():
            idx.funcs_by_qual[fn.qualname] = fn
    return idx


def _resolve(call, fn: FunctionInfo, pkg: PackageModel, idx: _Index):
    """Best-effort candidate callees for a call site."""
    mod = pkg.modules[fn.module]
    if call.receiver == "self":
        if fn.class_name is None:
            return []
        cls = mod.classes.get(fn.class_name)
        if cls is None:
            return []
        target = cls.methods.get(call.last)
        return [target] if target is not None else []
    if call.receiver == "bare":
        local = mod.functions.get(f"{mod.name}:{call.last}")
        if local is not None and local.class_name is None:
            return [local]
        cls = mod.classes.get(call.last)
        if cls is not None:
            init = cls.methods.get("__init__")
            return [init] if init is not None else []
        origin = mod.imports.get(call.last)
        if origin is not None:
            omod, _, oname = origin.rpartition(".")
            target_mod = pkg.modules.get(omod)
            if target_mod is not None:
                f = target_mod.functions.get(f"{omod}:{oname}")
                if f is not None and f.class_name is None:
                    return [f]
                init = idx.class_init.get(origin)
                if init is not None:
                    return [init]
        return []
    # receiver "other": module-alias call or union-by-name
    head = call.name.split(".", 1)[0]
    if head in mod.imports:
        origin = mod.imports[head]
        target_mod = pkg.modules.get(origin)
        if target_mod is not None:
            f = target_mod.functions.get(f"{origin}:{call.last}")
            return [f] if f is not None and f.class_name is None else []
        return []  # external module (time, jax, np, ...)
    if call.last in DENY_METHOD_NAMES:
        return []
    return idx.methods_by_name.get(call.last, [])


def _is_waived(mod, line: int) -> tuple[bool, str]:
    if line in mod.waivers:
        return True, mod.waivers[line]
    return False, ""


def _mk(pkg, rule, fn, line, message, key) -> Finding:
    mod = pkg.modules[fn.module]
    waived, reason = _is_waived(mod, line)
    return Finding(rule, fn.module, str(mod.path), line, fn.qualname,
                   message, key, waived, reason)


# ---------------------------------------------------------------------------
# transitive summaries


def _eventually_acquires(fn, pkg, idx, memo, active) -> dict[str, tuple]:
    """lock id -> example chain [(qualname, line), ...] leading to acquisition."""
    if fn.qualname in memo:
        return memo[fn.qualname]
    if fn.qualname in active:
        return {}
    active.add(fn.qualname)
    result: dict[str, tuple] = {}
    for acq in fn.acquires:
        result.setdefault(acq.lock_id, ((fn.qualname, acq.line),))
    for call in fn.calls:
        for callee in _resolve(call, fn, pkg, idx):
            sub = _eventually_acquires(callee, pkg, idx, memo, active)
            for lock_id, chain in sub.items():
                result.setdefault(lock_id, ((fn.qualname, call.line),) + chain)
    active.discard(fn.qualname)
    memo[fn.qualname] = result
    return result


def _blocking_sites(fn, pkg) -> list:
    """Direct blocking calls in *fn*, with the cond-wait exemption applied.
    Waived sites are excluded (accepted blocks don't propagate)."""
    mod = pkg.modules[fn.module]
    out = []
    for call in fn.calls:
        blocked = None
        if call.name in BLOCKING_DOTTED or call.last in BLOCKING_DOTTED:
            blocked = call.name
        elif call.last in BLOCKING_LAST:
            # waiting on a lock/condition you hold releases it: sanctioned
            if call.receiver_lock is not None and call.receiver_lock in call.held:
                continue
            blocked = call.name
        if blocked is None:
            continue
        if call.line in mod.waivers:
            continue
        out.append((call, blocked))
    return out


def _has_blocking(fn, pkg, idx, memo, active) -> tuple | None:
    """Example chain to a blocking call reachable from *fn*, or None."""
    if fn.qualname in memo:
        return memo[fn.qualname]
    if fn.qualname in active:
        return None
    active.add(fn.qualname)
    result = None
    mod = pkg.modules[fn.module]
    sites = _blocking_sites(fn, pkg)
    if sites:
        call, blocked = sites[0]
        result = ((fn.qualname, call.line, blocked),)
    else:
        for call in fn.calls:
            if call.line in mod.waivers:  # accepted sites don't propagate
                continue
            for callee in _resolve(call, fn, pkg, idx):
                sub = _has_blocking(callee, pkg, idx, memo, active)
                if sub is not None:
                    result = ((fn.qualname, call.line, call.name),) + sub
                    break
            if result is not None:
                break
    active.discard(fn.qualname)
    memo[fn.qualname] = result
    return result


# ---------------------------------------------------------------------------
# rules


def check_lock_order(pkg: PackageModel, idx: _Index) -> list[Finding]:
    # edge (held, acquired) -> (fn, line, example chain)
    edges: dict[tuple[str, str], tuple] = {}
    memo: dict = {}
    for fn in pkg.all_functions():
        mod = pkg.modules[fn.module]
        for acq in fn.acquires:
            if acq.line in mod.waivers:
                continue
            for h in acq.held:
                if h != acq.lock_id:
                    edges.setdefault((h, acq.lock_id), (fn, acq.line, ()))
        for call in fn.calls:
            if not call.held or call.line in mod.waivers:
                continue
            for callee in _resolve(call, fn, pkg, idx):
                acquired = _eventually_acquires(callee, pkg, idx, memo, set())
                for lock_id, chain in acquired.items():
                    for h in call.held:
                        if h != lock_id:
                            edges.setdefault((h, lock_id), (fn, call.line, chain))

    # SCCs over the lock graph (iterative Tarjan)
    graph: dict[str, list[str]] = {}
    for (a, b) in edges:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    index_of: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: set[str] = set()
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(root):
        work = [(root, iter(graph[root]))]
        index_of[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index_of:
                    index_of[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append((w, iter(graph[w])))
                    advanced = True
                    break
                elif w in on_stack:
                    low[v] = min(low[v], index_of[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index_of[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == v:
                        break
                sccs.append(scc)

    for node in graph:
        if node not in index_of:
            strongconnect(node)

    findings = []
    for scc in sccs:
        if len(scc) < 2:
            continue
        members = sorted(scc)
        detail = []
        for (a, b), (fn, line, chain) in sorted(edges.items()):
            if a in scc and b in scc:
                via = "".join(f" -> {q}:{ln}" for q, ln, *_ in chain)
                detail.append(f"{a} -> {b} at {fn.qualname}:{line}{via}")
        fn0, line0, _ = edges[next((a, b) for (a, b) in sorted(edges)
                                   if a in scc and b in scc)]
        findings.append(_mk(pkg, "lock-order", fn0, line0,
                            "lock-order cycle between {%s}; edges: %s"
                            % (", ".join(members), "; ".join(detail)),
                            key="<->".join(members)))
    return findings


def check_guarded_by(pkg: PackageModel, idx: _Index) -> list[Finding]:
    findings = []
    exempt = {"__init__", "__post_init__", "__del__"}
    for mod in pkg.modules.values():
        for cls in mod.classes.values():
            if not cls.guarded:
                continue
            guard_ids = {f: cls.locks[a].id for f, a in cls.guarded.items()}
            for fn in mod.functions.values():
                if fn.class_name != cls.name or fn.name in exempt:
                    continue
                seen_lines = set()
                for acc in fn.accesses:
                    lock_id = guard_ids.get(acc.attr)
                    if lock_id is None or lock_id in acc.held:
                        continue
                    if (acc.attr, acc.line) in seen_lines:
                        continue
                    seen_lines.add((acc.attr, acc.line))
                    verb = "write to" if acc.write else "read of"
                    findings.append(_mk(
                        pkg, "guarded-by", fn, acc.line,
                        f"{verb} {cls.name}.{acc.attr} without holding "
                        f"{lock_id} (declared guarded-by {cls.guarded[acc.attr]})",
                        key=f"{cls.name}.{acc.attr}@{fn.name}"))
    return findings


def check_blocking(pkg: PackageModel, idx: _Index) -> list[Finding]:
    findings = []
    memo: dict = {}
    for fn in pkg.all_functions():
        mod = pkg.modules[fn.module]
        seen_lines = set()
        # direct blocking calls under a held lock (including waived ones,
        # reported as waived)
        for call in fn.calls:
            if not call.held:
                continue
            blocked = None
            if call.name in BLOCKING_DOTTED or call.last in BLOCKING_DOTTED:
                blocked = call.name
            elif call.last in BLOCKING_LAST:
                if call.receiver_lock is not None and call.receiver_lock in call.held:
                    continue
                blocked = call.name
            if blocked is None or call.line in seen_lines:
                continue
            seen_lines.add(call.line)
            findings.append(_mk(
                pkg, "blocking", fn, call.line,
                f"blocking call {blocked}() while holding "
                f"{{{', '.join(call.held)}}}", key=f"{blocked}@{fn.name}"))
        # transitive: calls under a lock reaching a blocking site
        for call in fn.calls:
            if not call.held or call.line in seen_lines:
                continue
            if call.line in mod.waivers:
                # surface as a waived finding so --show-waived lists it
                chain_hit = None
                for callee in _resolve(call, fn, pkg, idx):
                    chain_hit = _has_blocking(callee, pkg, idx, memo, set())
                    if chain_hit:
                        break
                if chain_hit:
                    seen_lines.add(call.line)
                    findings.append(_mk(
                        pkg, "blocking", fn, call.line,
                        f"call {call.name}() under {{{', '.join(call.held)}}} "
                        f"reaches blocking {chain_hit[-1][2]}()",
                        key=f"via-{call.last}@{fn.name}"))
                continue
            for callee in _resolve(call, fn, pkg, idx):
                chain = _has_blocking(callee, pkg, idx, memo, set())
                if chain is None:
                    continue
                seen_lines.add(call.line)
                via = " -> ".join(f"{q}:{ln}" for q, ln, _ in chain)
                findings.append(_mk(
                    pkg, "blocking", fn, call.line,
                    f"call {call.name}() under {{{', '.join(call.held)}}} "
                    f"reaches blocking {chain[-1][2]}() via {via}",
                    key=f"via-{call.last}@{fn.name}"))
                break
    return findings


def check_requires_lock(pkg: PackageModel, idx: _Index) -> list[Finding]:
    """Same-class call sites of `# requires-lock:` functions must hold it."""
    findings = []
    for fn in pkg.all_functions():
        if fn.class_name is None:
            continue
        mod = pkg.modules[fn.module]
        cls = mod.classes.get(fn.class_name)
        if cls is None:
            continue
        for call in fn.calls:
            if call.receiver != "self":
                continue
            callee = cls.methods.get(call.last)
            if callee is None or not callee.requires:
                continue
            missing = [l for l in callee.requires if l not in call.held]
            if not missing:
                continue
            findings.append(_mk(
                pkg, "requires-lock", fn, call.line,
                f"call to {callee.qualname} (requires-lock) without holding "
                f"{{{', '.join(missing)}}}", key=f"{call.last}@{fn.name}"))
    return findings


def check_annotations(pkg: PackageModel, idx: _Index) -> list[Finding]:
    findings = []
    for mod in pkg.modules.values():
        for line, msg in mod.annotation_errors:
            findings.append(Finding(
                "annotation", mod.name, str(mod.path), line, mod.name, msg,
                key=msg))
    return findings


_CHECKS = {
    "lock-order": check_lock_order,
    "guarded-by": check_guarded_by,
    "blocking": check_blocking,
    "requires-lock": check_requires_lock,
    "annotation": check_annotations,
}


def run_rules(pkg: PackageModel, rules=RULES) -> list[Finding]:
    idx = _build_index(pkg)
    findings: list[Finding] = []
    for rule in rules:
        findings.extend(_CHECKS[rule](pkg, idx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings
