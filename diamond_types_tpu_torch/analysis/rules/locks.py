"""Lock-graph rules: lock-order, unsorted-locks, device-under-lock.

A lexical held-set simulation over each function body: `with` items,
`ExitStack.enter_context(...)` and bare `.acquire()` calls push onto
the held set, classified into the canonical order classes below; the
rules fire on the acquisition events.

Canonical order (must only ever grow rightward while locks are held):

  repl.maintain(0) -> repl.rebalance(1) -> repl.leases(2) ->
  repl.membership(3) -> repl.peers(4) -> repl.quorum(5) ->
  repl.writergroup(6) -> qos(8) -> global(10) -> shard(20) ->
  io(25) -> oplog(30) -> device(40) -> leaf(50)

(`qos` is the adaptive-admission controller's rung, deliberately
OUTER to the scheduler's global lock: the control loop takes qos then
global to read queue fills, while the hot admission path under global
reads the published deadline table lock-free — code under global must
never take the qos lock.)

(`repl.rebalance` is the elastic-mesh planning rung: the rebalancer
plans migrations under it and may then take lease state, but lease
code must never call back into the planner — outer to repl.leases.)

(`repl.writergroup` is the hot-doc write-splitting table's rung,
deliberately INNER to the lease lock: the lease table's floor-raise
hook fences group registrations while the lease lock is held, and the
group table never calls back into lease state while its own lock is
held — taking them the other way around deadlocks against the hook.)

(`io` is the DocStore flush-pass serializer: it is deliberately OUTER
to the oplog guard — encode runs under the store lock inside an
io-serialized pass so a stalled flusher can never overwrite a newer
snapshot — and is never held together with scheduler locks.)

Lock expressions are classified by name pattern (e.g. `_shard_locks[s]`
-> shard) with the enclosing class name disambiguating bare
`self.lock` / `self._lock` (MergeScheduler's is the global lock,
DocStore's is the oplog guard, LeaseManager's the lease lock).
Unknown lock expressions are ignored — the linter enforces the
documented order over the NAMED locks, it does not guess.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from ..lint import FileContext, Violation

# canonical order levels; a lock may only be acquired while every held
# lock has a strictly SMALLER level (same level: see rank/sorted rules)
ORDER_LEVELS = {
    "repl.maintain": 0,
    "repl.rebalance": 1,
    "repl.leases": 2,
    "repl.membership": 3,
    "repl.peers": 4,
    "repl.quorum": 5,
    "repl.writergroup": 6,
    "qos": 8,
    "global": 10,
    "shard": 20,
    "io": 25,
    "oplog": 30,
    "device": 40,
    "leaf": 50,
}

# direct device-dispatch surface: the JAX package's names (jax sync
# points + its dispatch wrappers), kept so the shared fixtures fire
# alike in both packages, plus the port's own: the CUDA sync point, the
# gpu/kernels.py wrappers (each launches a kernel) and the batched
# checkouts (K3). Pass 1 (lint.build_summary) widens this one hop: any
# function whose body calls one of these is itself a dispatcher.
DISPATCH_BASE = {
    "block_until_ready", "device_put",
    "fused_replay", "mesh_fused_replay", "warmup_fused_cache",
    "sync_doc",
    "synchronize",
    "apply_ops_window", "xform_positions", "materialize_runs",
    "zone_tape_run", "replay_batch_kernel",
    "checkout_batch_device", "texts_at_versions",
}

# names that never mean "this call reaches a device" even though some
# function somewhere shares the name (kept tight: only add here with a
# comment saying which collision it resolves)
_DISPATCH_NAME_BLOCKLIST = {
    "get", "put", "read", "write", "append",
}

_SORTED_WRAPPERS = {"sorted"}
_ITER_WRAPPERS = {"enumerate", "reversed", "list", "tuple"}


def _classify(expr: ast.AST, class_name: str) -> Optional[str]:
    """Map a lock expression to its order class (None = unknown)."""
    try:
        src = ast.unparse(expr)
    except Exception:   # pragma: no cover - malformed tree
        return None
    if "_shard_locks" in src:
        return "shard"
    if "_device_locks" in src or "device_lock" in src \
            or src in ("dlock", "dl"):
        return "device"
    if "_sync_lock" in src or "oplog_lock" in src or src == "olock" \
            or src.endswith("store.lock") or src == "store.lock":
        return "oplog"
    # adaptive admission: the controller's rung sits between the
    # replication plane and the scheduler global lock (step() takes
    # qos -> global to read queue fills; the hot path never takes it)
    if "_qos_lock" in src:
        return "qos"
    if "_maintain_lock" in src:
        return "repl.maintain"
    # elastic mesh: the rebalancer's planning guard and the placement
    # override table both sit between maintain and the lease lock —
    # migration planning reads lease state, never the reverse
    if "_rebalance_lock" in src:
        return "repl.rebalance"
    if src.endswith("leases.lock"):
        return "repl.leases"
    # hot-doc write splitting: the group table's lock is INNER to the
    # lease lock (the floor-raise hook fences registrations under it)
    if src.endswith("writergroups.lock"):
        return "repl.writergroup"
    if "io_lock" in src:
        return "io"
    # residency tier: the hydrator's warm-map guard, the tier's table
    # lock, and the per-doc file locks ("_doc_lock" also covers the
    # `self._doc_lock(doc_id)` accessor form) all live on the io rung —
    # deliberately OUTER to the oplog guard, like io_lock above
    if "_hydrate_lock" in src or "_tier_lock" in src \
            or "_doc_lock" in src:
        return "io"
    # follower-read tier: the FollowerIndex evidence guard (`_read_lock`)
    # and the CheckoutCache guard (`_cache_lock`) are io-rung for the
    # same reason — the cache's single-flight leader materializes
    # checkouts (oplog rung) strictly OUTSIDE the cache guard, so io
    # stays outer to oplog and never the reverse
    if "_read_lock" in src or "_cache_lock" in src:
        return "io"
    # wire tier: the WireChannel snapshot-frame cache guard is io-rung
    # for the same reason as the checkout cache — frame builds (which
    # take the oplog guard) run strictly OUTSIDE the cache lock, so a
    # racing pair builds twice rather than ever nesting io inside oplog
    if "_frame_cache_lock" in src:
        return "io"
    # device-transform planning: the xform jit-cache guard is a
    # DEVICE-class lock (the batched transform dispatch runs in the
    # planning phase, under shard locks but outside the oplog guard and
    # the per-device replay locks) — must classify BEFORE the generic
    # "_jit_lock" leaf rule below
    if "_xform_jit_lock" in src:
        return "device"
    # window-arena staging: the donated-buffer recycle table guard is
    # a DEVICE-class lock (acquire/adopt bracket the mesh dispatch but
    # run under the scheduler's per-class replay, outside the oplog
    # guard; the dispatch itself never runs while it is held) — must
    # classify BEFORE the generic "_jit_lock" leaf rule below
    if "_arena_lock" in src:
        return "device"
    # shape steering: the warm-class table guard is a pure leaf —
    # note_warm/snap are called strictly OUTSIDE the jit-cache leaf
    # locks and never dispatch or call back out while held
    if "_steer_lock" in src:
        return "leaf"
    if "_first_touch_lock" in src or "_jit_lock" in src:
        return "leaf"
    # live-telemetry tier: the TimeSeries ring guard (`_ts_lock`, also
    # the exemplar store) and the top-K sketch guard (`_sketch_lock`)
    # are leaf rungs — record_*/note() double-writes happen while the
    # caller already holds serve/read/replicate locks, and the obs
    # structures never call back out while held
    if "_ts_lock" in src or "_sketch_lock" in src:
        return "leaf"
    # incident engine: the AnomalyDetector state guard and the
    # IncidentStore ring guard are leaf rungs — poll() gathers all its
    # TimeSeries/recorder reads BEFORE taking the lock and opens
    # bundles AFTER releasing it, so nothing ever nests under them
    if "_incident_lock" in src:
        return "leaf"
    if src in ("self.lock", "self._lock", "lock"):
        if "Scheduler" in class_name:
            return "global"
        if "Store" in class_name:
            return "oplog"
        if "Lease" in class_name or "Ownership" in class_name:
            return "repl.leases"
        if "Peer" in class_name:
            return "repl.peers"
        if "Quorum" in class_name:
            return "repl.quorum"
        if "WriterGroup" in class_name:
            return "repl.writergroup"
        if "Membership" in class_name:
            return "repl.membership"
        return None
    if src == "self.banks" or src.endswith("_idle_cv"):
        return None
    return None


def _call_name(call: ast.Call) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _is_sorted_expr(expr: ast.AST, sorted_names: Set[str]) -> bool:
    """Is `expr` lexically a sorted iteration source? Accepts
    `sorted(...)`, a Name previously bound to one, and the thin
    wrappers enumerate/reversed/list/tuple around either."""
    if isinstance(expr, ast.Call):
        name = _call_name(expr)
        if name in _SORTED_WRAPPERS:
            return True
        if name in _ITER_WRAPPERS and expr.args:
            return _is_sorted_expr(expr.args[0], sorted_names)
        return False
    if isinstance(expr, ast.Name):
        return expr.id in sorted_names
    return False


def _collect_sorted_names(fn: ast.AST) -> Set[str]:
    """Names lexically bound to sorted iteration sources in `fn`:
    `x = sorted(...)`, `x = list(sorted(...))`, and one comprehension
    hop `x = [e for t in S ...]` with S sorted. (No statement-level
    flow analysis — code that wants an acquisition loop to pass the
    sorted check binds its source visibly or suppresses with a
    justification.)"""
    names: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for node in ast.walk(fn):
            if not isinstance(node, ast.Assign):
                continue
            value = node.value
            ok = _is_sorted_expr(value, names)
            if not ok and isinstance(value, (ast.ListComp,
                                             ast.GeneratorExp)):
                gens = value.generators
                ok = bool(gens) and _is_sorted_expr(gens[0].iter, names)
            if ok:
                for t in node.targets:
                    if isinstance(t, ast.Name) and t.id not in names:
                        names.add(t.id)
                        changed = True
    return names


class _Held:
    __slots__ = ("cls", "level", "src", "line", "stack_tag")

    def __init__(self, cls: str, src: str, line: int,
                 stack_tag: Optional[str] = None) -> None:
        self.cls = cls
        self.level = ORDER_LEVELS[cls]
        self.src = src
        self.line = line
        self.stack_tag = stack_tag   # ExitStack var owning this entry


class _FnWalker:
    """Held-set simulation for one function body."""

    def __init__(self, ctx: FileContext, summary, class_name: str,
                 fn: ast.AST) -> None:
        self.ctx = ctx
        self.summary = summary
        self.class_name = class_name
        self.fn = fn
        self.sorted_names = _collect_sorted_names(fn)
        self.held: List[_Held] = []
        self.loops: List[ast.For] = []
        self.out: List[Violation] = []
        self.env: dict = {}
        self._build_env()

    # ---- local alias environment -----------------------------------------

    def _classify_env(self, expr: ast.AST) -> Optional[str]:
        if isinstance(expr, ast.Name) and expr.id in self.env:
            return self.env[expr.id]
        return _classify(expr, self.class_name)

    def _build_env(self) -> None:
        """Fixpoint over local bindings so aliases classify: `lk =
        self._device_locks[s]`, `dlocks.append(lk)`, `for lk in
        dlocks:`, walrus bindings, and comprehensions whose element is
        a classified name. A container of device locks carries the
        `device` class — iterating it re-binds the loop var to it."""
        changed = True
        while changed:
            changed = False
            for node in ast.walk(self.fn):
                cls: Optional[str] = None
                targets: List[str] = []
                if isinstance(node, ast.Assign):
                    value = node.value
                    cls = self._classify_env(value)
                    if cls is None and isinstance(
                            value, (ast.ListComp, ast.GeneratorExp)):
                        cls = self._classify_env(value.elt)
                    targets = [t.id for t in node.targets
                               if isinstance(t, ast.Name)]
                elif isinstance(node, ast.NamedExpr):
                    cls = self._classify_env(node.value)
                    if isinstance(node.target, ast.Name):
                        targets = [node.target.id]
                elif isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute) \
                        and node.func.attr in ("append", "add") \
                        and node.args \
                        and isinstance(node.func.value, ast.Name):
                    cls = self._classify_env(node.args[0])
                    targets = [node.func.value.id]
                elif isinstance(node, ast.For) \
                        and isinstance(node.target, ast.Name):
                    cls = self._classify_env(node.iter)
                    targets = [node.target.id]
                if cls is None:
                    continue
                for t in targets:
                    if self.env.get(t) != cls:
                        self.env[t] = cls
                        changed = True

    # ---- events ----------------------------------------------------------

    def _violate(self, rule: str, line: int, msg: str) -> None:
        self.out.append(Violation(rule=rule, path=self.ctx.rel,
                                  line=line, message=msg))

    def _acquire(self, expr: ast.AST, line: int,
                 stack_tag: Optional[str] = None,
                 in_loop: bool = False) -> Optional[_Held]:
        cls = self._classify_env(expr)
        if cls is None:
            return None
        try:
            src = ast.unparse(expr)
        except Exception:   # pragma: no cover
            src = "<lock>"
        level = ORDER_LEVELS[cls]
        for h in self.held:
            if h.level > level:
                self._violate(
                    "lock-order", line,
                    f"acquires {cls} lock `{src}` while holding "
                    f"{h.cls} lock `{h.src}` (line {h.line}); "
                    f"canonical order is "
                    f"{' -> '.join(k for k, _ in sorted(ORDER_LEVELS.items(), key=lambda kv: kv[1]))}")
            elif h.cls == cls and h.src == src and not in_loop:
                # same expression re-entered outside a loop: either a
                # reentrant lock (fine at runtime) or a copy-paste bug;
                # the witness checks the runtime side, stay quiet here
                pass
        if in_loop and cls in ("shard", "device") \
                and stack_tag is not None:
            loop = self.loops[-1]
            if not _is_sorted_expr(loop.iter, self.sorted_names):
                try:
                    it = ast.unparse(loop.iter)
                except Exception:   # pragma: no cover
                    it = "<iter>"
                self._violate(
                    "unsorted-locks", line,
                    f"acquires multiple {cls} locks (`{src}`) in a "
                    f"loop over `{it}` whose sort order is not "
                    f"lexically evident; iterate a `sorted(...)` "
                    f"source (or bind it via one comprehension hop) "
                    f"so every path agrees on acquisition order")
        h = _Held(cls, src, line, stack_tag=stack_tag)
        self.held.append(h)
        return h

    def _release_tag(self, tag: str) -> None:
        self.held = [h for h in self.held if h.stack_tag != tag]

    def _check_dispatch(self, call: ast.Call, line: int) -> None:
        name = _call_name(call)
        if name is None or name in _DISPATCH_NAME_BLOCKLIST:
            return
        if name not in DISPATCH_BASE \
                and name not in self.summary.dispatchers:
            return
        for h in self.held:
            if h.cls in ("global", "oplog"):
                self._violate(
                    "device-under-lock", line,
                    f"device dispatch `{name}(...)` while holding "
                    f"{h.cls} lock `{h.src}` (line {h.line}); device "
                    f"work may only run under shard/device locks so "
                    f"submits and oplog readers never stall behind a "
                    f"device call")
                break

    # ---- expression scan (calls inside one statement) --------------------

    def _scan_expr(self, node: ast.AST, in_loop: bool) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            name = _call_name(sub)
            if name == "enter_context" and sub.args:
                tag = None
                fn = sub.func
                if isinstance(fn, ast.Attribute) \
                        and isinstance(fn.value, ast.Name):
                    tag = fn.value.id
                self._acquire(sub.args[0], sub.lineno,
                              stack_tag=tag or "<stack>",
                              in_loop=in_loop)
            elif name == "acquire" and isinstance(sub.func,
                                                  ast.Attribute):
                self._acquire(sub.func.value, sub.lineno,
                              stack_tag="<acquired>", in_loop=in_loop)
            elif name == "release" and isinstance(sub.func,
                                                  ast.Attribute):
                cls = self._classify_env(sub.func.value)
                if cls is not None:
                    for i in range(len(self.held) - 1, -1, -1):
                        if self.held[i].cls == cls and \
                                self.held[i].stack_tag == "<acquired>":
                            del self.held[i]
                            break
            else:
                self._check_dispatch(sub, sub.lineno)

    # ---- statement walk --------------------------------------------------

    def walk(self) -> List[Violation]:
        body = getattr(self.fn, "body", [])
        self._walk_body(body)
        return self.out

    def _walk_body(self, stmts) -> None:
        for st in stmts:
            self._walk_stmt(st)

    def _walk_stmt(self, st: ast.stmt) -> None:
        in_loop = bool(self.loops)
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired: List[_Held] = []
            stack_vars: List[str] = []
            for item in st.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call) \
                        and _call_name(ce) == "ExitStack":
                    if isinstance(item.optional_vars, ast.Name):
                        stack_vars.append(item.optional_vars.id)
                    continue
                self._scan_expr(ce, in_loop)
                h = self._acquire(ce, st.lineno, in_loop=in_loop)
                if h is not None:
                    acquired.append(h)
            self._walk_body(st.body)
            for h in acquired:
                if h in self.held:
                    self.held.remove(h)
            for tag in stack_vars:
                self._release_tag(tag)
        elif isinstance(st, ast.For):
            self._scan_expr(st.iter, in_loop)
            self.loops.append(st)
            self._walk_body(st.body)
            self.loops.pop()
            self._walk_body(st.orelse)
        elif isinstance(st, ast.While):
            self._scan_expr(st.test, in_loop)
            self._walk_body(st.body)
            self._walk_body(st.orelse)
        elif isinstance(st, ast.If):
            self._scan_expr(st.test, in_loop)
            self._walk_body(st.body)
            self._walk_body(st.orelse)
        elif isinstance(st, ast.Try):
            self._walk_body(st.body)
            for h in st.handlers:
                self._walk_body(h.body)
            self._walk_body(st.orelse)
            self._walk_body(st.finalbody)
        elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            pass    # nested defs are walked as their own functions
        elif isinstance(st, ast.ClassDef):
            pass
        else:
            self._scan_expr(st, in_loop)


def check_locks(ctx: FileContext, summary) -> List[Violation]:
    out: List[Violation] = []
    stack: List[Tuple[str, ast.AST]] = [("", ctx.tree)]
    # walk every function with its enclosing class name for `self.lock`
    # disambiguation (nested defs get their own empty held set — a
    # worker closure does not inherit its parent's lexical locks, which
    # is exactly the conservative direction)
    def visit(node: ast.AST, class_name: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, child.name)
            elif isinstance(child, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                out.extend(_FnWalker(ctx, summary, class_name,
                                     child).walk())
                visit(child, class_name)
            else:
                visit(child, class_name)
    visit(ctx.tree, "")
    return out
