"""Restricted Python -> JavaScript transpiler for the browser CRDT
engine's single source (tools/crdt_replay_src.py; VERDICT r4 #5).

Deliberately TINY and strict: it understands exactly the subset the
source module's docstring promises and raises `UnsupportedConstruct`
on anything else — that raise IS the generation-time assertion that
replaces the old sha256 pin (the emitted JS is produced from the
executed-and-fuzzed Python at import time, never stored, so the two
artifacts cannot drift; an unsupported edit fails the build instead of
silently shipping untested JS).

Semantics mapping (kept 1:1 so the Python tests vouch for the JS):
  dicts with computed keys  -> plain objects (string/number keys)
  dict records (str-literal subscript) -> object properties
  dict_has(d, k)            -> (k in d)
  set() / .add / set_has    -> new Set() / .add / .has
  list append/insert/pop    -> push / splice
  len(x)                    -> x.length  (lists/strings only)
  str(x)                    -> String(x)
  for v in xs               -> for (const v of xs)   (Array and Set)
  a < b on strings          -> JS native compare (UTF-16 units; BMP-
                               equal to Python's code-point compare)
"""

from __future__ import annotations

import ast
import inspect
import json
import textwrap


class UnsupportedConstruct(SyntaxError):
    pass


def _fail(node, why: str):
    raise UnsupportedConstruct(
        f"py2js: {why} (line {getattr(node, 'lineno', '?')})")


_CMPOPS = {ast.Lt: "<", ast.LtE: "<=", ast.Gt: ">", ast.GtE: ">=",
           ast.Eq: "===", ast.NotEq: "!=="}
# Bitwise ops are 1:1 ONLY under the source subset's contract: word
# values < 2^30 and shift amounts < 30 (JS bitwise is signed 32-bit;
# Python ints are unbounded — sub-30-bit words behave identically).
_BINOPS = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Mod: "%",
           ast.BitOr: "|", ast.BitAnd: "&", ast.LShift: "<<",
           ast.RShift: ">>"}


class _Emitter(ast.NodeVisitor):
    def __init__(self) -> None:
        self.lines: list[str] = []
        self.indent = 0

    def out(self, s: str) -> None:
        self.lines.append("  " * self.indent + s)

    # ---- expressions -> strings -----------------------------------------

    def expr(self, e: ast.expr) -> str:
        if isinstance(e, ast.Constant):
            v = e.value
            if v is None:
                return "null"
            if v is True:
                return "true"
            if v is False:
                return "false"
            if isinstance(v, str):
                return json.dumps(v)
            if isinstance(v, (int, float)):
                return repr(v)
            _fail(e, f"constant {v!r}")
        if isinstance(e, ast.Name):
            return e.id
        if isinstance(e, ast.Subscript):
            base = self.expr(e.value)
            sl = e.slice
            if isinstance(sl, ast.Constant) and isinstance(sl.value, str):
                return f"{base}.{sl.value}"      # record field
            return f"{base}[{self.expr(sl)}]"
        if isinstance(e, ast.BinOp):
            if isinstance(e.op, ast.FloorDiv):
                # non-negative ints only (the subset's contract)
                return f"Math.floor({self.expr(e.left)} / " \
                       f"{self.expr(e.right)})"
            op = _BINOPS.get(type(e.op))
            if op is None:
                _fail(e, f"operator {type(e.op).__name__}")
            return f"({self.expr(e.left)} {op} {self.expr(e.right)})"
        if isinstance(e, ast.UnaryOp):
            if isinstance(e.op, ast.Not):
                return f"(!{self.expr(e.operand)})"
            if isinstance(e.op, ast.USub):
                return f"(-{self.expr(e.operand)})"
            _fail(e, f"unary {type(e.op).__name__}")
        if isinstance(e, ast.BoolOp):
            op = " && " if isinstance(e.op, ast.And) else " || "
            return "(" + op.join(self.expr(v) for v in e.values) + ")"
        if isinstance(e, ast.Compare):
            if len(e.ops) != 1:
                _fail(e, "chained comparison")
            op = _CMPOPS.get(type(e.ops[0]))
            if op is None:
                _fail(e, f"comparison {type(e.ops[0]).__name__} (use "
                         f"dict_has/set_has for membership)")
            return f"({self.expr(e.left)} {op} " \
                   f"{self.expr(e.comparators[0])})"
        if isinstance(e, ast.Call):
            return self.call(e)
        if isinstance(e, ast.Dict):
            parts = []
            for k, v in zip(e.keys, e.values):
                if not (isinstance(k, ast.Constant)
                        and isinstance(k.value, str)):
                    _fail(e, "dict literal with non-string-literal key")
                parts.append(f"{k.value}: {self.expr(v)}")
            return "{" + ", ".join(parts) + "}"
        if isinstance(e, ast.List):
            return "[" + ", ".join(self.expr(v) for v in e.elts) + "]"
        _fail(e, f"expression {type(e).__name__}")

    def call(self, e: ast.Call) -> str:
        if e.keywords:
            _fail(e, "keyword arguments")
        args = [self.expr(a) for a in e.args]
        if isinstance(e.func, ast.Name):
            name = e.func.id
            if name == "len" and len(args) == 1:
                return f"{args[0]}.length"
            if name == "str" and len(args) == 1:
                return f"String({args[0]})"
            if name == "set" and not args:
                return "new Set()"
            if name == "range":
                _fail(e, "range() outside a for loop")
            if name == "dict_has" and len(args) == 2:
                return f"({args[1]} in {args[0]})"
            if name == "set_has" and len(args) == 2:
                return f"{args[0]}.has({args[1]})"
            return f"{name}({', '.join(args)})"   # local function call
        if isinstance(e.func, ast.Attribute):
            base = self.expr(e.func.value)
            meth = e.func.attr
            if meth == "append" and len(args) == 1:
                return f"{base}.push({args[0]})"
            if meth == "insert" and len(args) == 2:
                return f"{base}.splice({args[0]}, 0, {args[1]})"
            if meth == "pop" and len(args) == 1:
                return f"{base}.splice({args[0]}, 1)[0]"
            if meth == "pop" and not args:
                return f"{base}.pop()"
            if meth == "add" and len(args) == 1:
                return f"{base}.add({args[0]})"
            _fail(e, f"method .{meth}()")
        _fail(e, "call form")

    # ---- statements ------------------------------------------------------

    def stmt(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign):
            if len(s.targets) != 1:
                _fail(s, "multiple assignment targets")
            t = s.targets[0]
            if isinstance(t, ast.Name):
                # Name assignments are handled (with declared-name
                # tracking) by stmt_hoisted — reaching here would bypass
                # the hoisting contract
                _fail(s, "name assignment outside hoisting path")
            elif isinstance(t, ast.Subscript):
                self.out(f"{self.expr(t)} = {self.expr(s.value)};")
            else:
                _fail(s, f"assignment to {type(t).__name__}")
        elif isinstance(s, ast.Expr):
            if isinstance(s.value, ast.Constant):
                return  # docstring / bare literal
            self.out(self.expr(s.value) + ";")
        elif isinstance(s, ast.Return):
            self.out("return" + (f" {self.expr(s.value)}"
                                 if s.value is not None else "") + ";")
        elif isinstance(s, ast.If):
            self.out(f"if ({self.expr(s.test)}) {{")
            self.block(s.body)
            cur = s
            while len(cur.orelse) == 1 and isinstance(cur.orelse[0], ast.If):
                cur = cur.orelse[0]
                self.out(f"}} else if ({self.expr(cur.test)}) {{")
                self.block(cur.body)
            if cur.orelse:
                self.out("} else {")
                self.block(cur.orelse)
            self.out("}")
        elif isinstance(s, ast.While):
            if s.orelse:
                _fail(s, "while-else")
            self.out(f"while ({self.expr(s.test)}) {{")
            self.block(s.body)
            self.out("}")
        elif isinstance(s, ast.For):
            self.for_stmt(s)
        elif isinstance(s, ast.Break):
            self.out("break;")
        elif isinstance(s, ast.Continue):
            self.out("continue;")
        else:
            _fail(s, f"statement {type(s).__name__}")

    def for_stmt(self, s: ast.For) -> None:
        if s.orelse:
            _fail(s, "for-else")
        if not isinstance(s.target, ast.Name):
            _fail(s, "destructuring for target")
        v = s.target.id
        it = s.iter
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                and it.func.id == "range":
            args = [self.expr(a) for a in it.args]
            if len(args) == 1:
                lo, hi = "0", args[0]
            elif len(args) == 2:
                lo, hi = args
            else:
                _fail(s, "range() step")
            self.out(f"for (var {v} = {lo}; {v} < {hi}; {v}++) {{")
        else:
            # `var`, matching assignment emission: a body assignment to
            # the loop variable must not emit an invalid redeclaration
            # against a `const` loop head
            self.out(f"for (var {v} of {self.expr(it)}) {{")
        self.declared.add(v)
        self.block(s.body)
        self.out("}")

    def block(self, body: list[ast.stmt]) -> None:
        self.indent += 1
        # JS has no block-scoped redeclaration via `let`; hoist by
        # tracking names already declared in this function
        for st in body:
            self.stmt_hoisted(st)
        self.indent -= 1

    # `let x = ...` twice in sibling blocks is legal JS, but a
    # re-assignment in the SAME scope after a previous let must not
    # redeclare. Track per-function declared names.
    def stmt_hoisted(self, s: ast.stmt) -> None:
        if isinstance(s, ast.Assign) and len(s.targets) == 1 \
                and isinstance(s.targets[0], ast.Name):
            # `var`, not `let`: Python assignments are function-scoped,
            # and a first assignment inside a nested block must remain
            # visible after it (let would be block-scoped)
            name = s.targets[0].id
            if name in self.declared:
                self.out(f"{name} = {self.expr(s.value)};")
            else:
                self.declared.add(name)
                self.out(f"var {name} = {self.expr(s.value)};")
            return
        self.stmt(s)

    # ---- functions -------------------------------------------------------

    def func(self, f: ast.FunctionDef) -> None:
        if f.args.posonlyargs or f.args.kwonlyargs or f.args.vararg \
                or f.args.kwarg or f.args.defaults:
            _fail(f, "non-positional function arguments")
        args = ", ".join(a.arg for a in f.args.args)
        self.declared = {a.arg for a in f.args.args}
        self.out(f"function {f.name}({args}) {{")
        self.block(f.body)
        self.out("}")


def transpile_module(module) -> str:
    """Emit the module's functions as JavaScript. Raises
    UnsupportedConstruct on anything outside the subset."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(module)))
    em = _Emitter()
    for node in tree.body:
        if isinstance(node, ast.Expr) and isinstance(node.value,
                                                     ast.Constant):
            continue  # module docstring
        if isinstance(node, ast.ImportFrom) and node.module == "__future__":
            continue
        if not isinstance(node, ast.FunctionDef):
            _fail(node, f"top-level {type(node).__name__}")
        if node.name in ("dict_has", "set_has"):
            # membership shims: emitted as operators at call sites, not
            # as functions (their Python bodies use `in`, which the
            # subset otherwise forbids)
            continue
        em.func(node)
        em.out("")
    return "\n".join(em.lines)
