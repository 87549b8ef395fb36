"""A small reader of the port's CUDA C++ sources, for the kernel pass.

Not a C++ parser: enough of one for the subset the kernels are written in.
It strips comments and preprocessor lines (keeping line numbers), finds
functions (``__global__`` kernels, ``__device__`` helpers, host functions,
members of structs), struct definitions and ``constexpr`` constants, splits a
function body into a tree of statements (blocks, ``if``, ``for``,
``while``, simple statements), and evaluates C integer expressions
(ternaries, casts, ``sizeof``, member chains, a few helper calls) against an
environment of constants and geometry symbols.
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_TOKEN_RE = re.compile(
    r'"(?:\\.|[^"\\])*"|\'(?:\\.|[^\'\\])*\'|[A-Za-z_]\w*|'
    r'\d[\w.]*|::|->|<<<|>>>|<<|>>|[<>=!]=|&&|\|\||\+\+|--|\S')

# bytes and alignment of the scalar types the kernels use
TYPE_SIZES: Dict[str, int] = {
    "char": 1, "bool": 1, "int8_t": 1, "uint8_t": 1, "short": 2,
    "__nv_bfloat16": 2, "__half": 2, "half": 2, "int": 4, "unsigned": 4,
    "uint32_t": 4, "int32_t": 4, "float": 4, "__nv_bfloat162": 4,
    "__half2": 4, "long": 8, "uint64_t": 8, "int64_t": 8, "size_t": 8,
    "double": 8, "float2": 8, "int2": 8, "float4": 16, "uint4": 16,
    "int4": 16, "longlong": 8,
}
SIXTEEN_BIT = ("__nv_bfloat16", "__half", "half")


def strip(source: str) -> str:
    """Comments, string-free preprocessor lines (with their continuations)
    blanked; newlines kept, so offsets map to the same lines."""
    out, i, n = [], 0, len(source)
    while i < n:
        c = source[i]
        if source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append(re.sub(r"[^\n]", " ", source[i:j]))
            i = j
        elif c == '"':
            j = i + 1
            while j < n and source[j] != '"':
                j += 2 if source[j] == "\\" else 1
            out.append(source[i:j + 1])
            i = j + 1
        else:
            out.append(c)
            i += 1
    text = "".join(out)
    lines = text.split("\n")
    cont = False
    for k, ln in enumerate(lines):
        if cont or ln.lstrip().startswith("#"):
            cont = ln.rstrip().endswith("\\")
            lines[k] = " " * len(ln)
    return "\n".join(lines)


@dataclass
class Tok:
    text: str
    line: int


def tokenize(text: str) -> List[Tok]:
    toks, line, pos = [], 1, 0
    for m in _TOKEN_RE.finditer(text):
        line += text.count("\n", pos, m.start())
        pos = m.start()
        toks.append(Tok(m.group(0), line))
    return toks


def join(toks: Sequence[Tok]) -> str:
    return " ".join(t.text for t in toks)


def _match(toks: Sequence[Tok], i: int, open_: str, close: str) -> int:
    """Index of the token closing the group opened at ``toks[i]``."""
    depth = 0
    for j in range(i, len(toks)):
        if toks[j].text == open_:
            depth += 1
        elif toks[j].text == close:
            depth -= 1
            if depth == 0:
                return j
    raise ValueError(f"unbalanced {open_!r} at line {toks[i].line}")


# ---------------------------------------------------------------- statements
@dataclass
class Stmt:
    kind: str                       # block | if | for | while | simple
    line: int
    toks: List[Tok] = field(default_factory=list)    # simple: the tokens
    head: List[Tok] = field(default_factory=list)    # if/while cond; for head
    body: List["Stmt"] = field(default_factory=list)
    orelse: List["Stmt"] = field(default_factory=list)

    @property
    def text(self) -> str:
        return join(self.toks)


def parse_stmts(toks: List[Tok]) -> List[Stmt]:
    out, i = [], 0
    while i < len(toks):
        st, i = _parse_stmt(toks, i)
        if st is not None:
            out.append(st)
    return out


def _parse_stmt(toks: List[Tok], i: int):
    t = toks[i]
    if t.text == ";":
        return None, i + 1
    if t.text == "{":
        j = _match(toks, i, "{", "}")
        return Stmt("block", t.line, body=parse_stmts(toks[i + 1:j])), j + 1
    if t.text in ("if", "while", "for") and i + 1 < len(toks) \
            and toks[i + 1].text == "(":
        j = _match(toks, i + 1, "(", ")")
        body, k = _parse_stmt(toks, j + 1)
        st = Stmt(t.text, t.line, head=toks[i + 2:j],
                  body=[body] if body is not None else [])
        if t.text == "if" and k < len(toks) and toks[k].text == "else":
            other, k = _parse_stmt(toks, k + 1)
            st.orelse = [other] if other is not None else []
        return st, k
    if t.text == "else":                    # dangling: parse what follows
        return _parse_stmt(toks, i + 1)
    depth, j = 0, i
    while j < len(toks):
        x = toks[j].text
        if x in "({[":
            depth += 1
        elif x in ")}]":
            depth -= 1
        elif x == ";" and depth == 0:
            break
        j += 1
    return Stmt("simple", t.line, toks=toks[i:j]), j + 1


def walk(stmts: Sequence[Stmt]):
    """Every simple statement in source order (nested bodies flattened)."""
    for st in stmts:
        if st.kind == "simple":
            yield st
        else:
            yield from walk(st.body)
            yield from walk(st.orelse)


# ------------------------------------------------------------ declarations
@dataclass
class Func:
    name: str
    qualname: str
    kind: str                       # global | device | host
    path: str
    line: int
    params: List[str]
    template: List[str]
    body: List[Tok]

    @property
    def stmts(self) -> List[Stmt]:
        return parse_stmts(self.body)

    @property
    def text(self) -> str:
        return join(self.body)


@dataclass
class Struct:
    name: str                       # "Vec<__nv_bfloat16>" for a specialization
    path: str
    line: int
    template: List[str]
    fields: List[Tuple[str, List[List[Tok]]]]   # (type, [dims] per declarator)


@dataclass
class Unit:
    """Every function, struct and constant of a set of sources."""
    funcs: List[Func] = field(default_factory=list)
    structs: Dict[str, Struct] = field(default_factory=dict)
    consts: Dict[str, List[Tok]] = field(default_factory=dict)
    sources: Dict[str, str] = field(default_factory=dict)


_SKIP_BEFORE_PAREN = {"__launch_bounds__", "__align__", "alignas",
                      "decltype", "sizeof"}


def _template_params(head: List[Tok]) -> List[str]:
    names: List[str] = []
    if head and head[0].text == "template":
        j = _match(head, 1, "<", ">") if len(head) > 1 else 0
        for k in range(2, j):
            if head[k + 1].text in (",", ">") and head[k].text not in (
                    "typename", "class", "int"):
                names.append(head[k].text)
    return names


def _func_header(head: List[Tok]):
    """(name, params) if ``head`` is a function header, else None."""
    for k, t in enumerate(head):
        if t.text == "(" and k > 0 and re.match(r"[A-Za-z_]\w*$",
                                                head[k - 1].text) \
                and head[k - 1].text not in _SKIP_BEFORE_PAREN:
            j = _match(head, k, "(", ")")
            params, cur, depth = [], [], 0
            for x in head[k + 1:j]:
                if x.text in "(<[":
                    depth += 1
                elif x.text in ")>]":
                    depth -= 1
                if x.text == "," and depth == 0:
                    params.append(cur[-1].text if cur else "")
                    cur = []
                else:
                    cur.append(x)
            if cur:
                params.append(cur[-1].text)
            return head[k - 1].text, params
    return None


def _fields(body: List[Tok]) -> List[Tuple[str, List[List[Tok]]]]:
    out = []
    for st in parse_stmts(body):
        if st.kind != "simple" or "(" in [t.text for t in st.toks]:
            continue
        toks = [t for t in st.toks if t.text not in ("const", "static")]
        if not toks or toks[0].text in ("static", "constexpr", "using"):
            continue
        # type: tokens up to the first declarator name (pointers count)
        k = 1
        if k < len(toks) and toks[k].text == "<":
            k = _match(toks, k, "<", ">") + 1
        typ = join(toks[:k])
        rest = toks[k:]
        if rest and rest[0].text == "*":
            typ, rest = "void*", rest[1:]
        decls, cur = [], []
        for t in rest + [Tok(",", 0)]:
            if t.text == ",":
                if cur:
                    dims, q = [], 1
                    while q < len(cur):
                        if cur[q].text == "[":
                            e = _match(cur, q, "[", "]")
                            dims.append(cur[q + 1:e])
                            q = e + 1
                        else:
                            q += 1
                    decls.append(dims)
                cur = []
            else:
                cur.append(t)
        out.append((typ, decls))
    return out


def parse_unit(paths: Sequence[str], root: str) -> Unit:
    """Functions, structs and constants of the sources at ``paths``."""
    unit = Unit()
    for full in paths:
        rel = os.path.relpath(full, root).replace(os.sep, "/")
        with open(full) as f:
            unit.sources[rel] = f.read()
        _scan(tokenize(strip(unit.sources[rel])), rel, unit, "")
    return unit


def parse_text(source: str, path: str) -> Unit:
    unit = Unit(sources={path: source})
    _scan(tokenize(strip(source)), path, unit, "")
    return unit


def _outside_parens(texts: List[str]) -> List[str]:
    out, depth = [], 0
    for x in texts:
        depth += (x == "(") - (x == ")")
        if depth == 0:
            out.append(x)
    return out


def _scan(toks: List[Tok], path: str, unit: Unit, scope: str) -> None:
    start, i = 0, 0
    while i < len(toks):
        t = toks[i].text
        if t in ("(", "["):
            i = _match(toks, i, t, ")" if t == "(" else "]") + 1
            continue
        if t == ";":
            head = toks[start:i]
            if head and head[0].text == "constexpr" and "=" in \
                    [x.text for x in head] and "(" not in \
                    [x.text for x in head[:3]]:
                eq = [x.text for x in head].index("=")
                name = head[eq - 1].text
                unit.consts[name] = head[eq + 1:]
            start = i = i + 1
            continue
        if t != "{":
            i += 1
            continue
        j = _match(toks, i, "{", "}")
        head, body = toks[start:i], toks[i + 1:j]
        texts = [x.text for x in head]
        if texts[:1] == ["template"] and len(head) > 1:   # past template <..>
            texts = [""] * (_match(head, 1, "<", ">") + 1) + \
                texts[_match(head, 1, "<", ">") + 1:]
        if "namespace" in texts:
            _scan(body, path, unit, scope)
        elif "struct" in texts or "class" in texts:
            k = texts.index("struct" if "struct" in texts else "class")
            name = head[k + 1].text
            if k + 2 < len(head) and head[k + 2].text == "<":
                name += "<" + join(head[k + 3:_match(head, k + 2, "<", ">")]) \
                    .replace(" ", "") + ">"
            unit.structs[name] = Struct(name, path, head[k].line,
                                        _template_params(head), _fields(body))
            _scan(body, path, unit, name + "::")
        elif "=" not in _outside_parens(texts) \
                and (hdr := _func_header(head)):
            name, params = hdr
            kind = "global" if "__global__" in texts else \
                "device" if "__device__" in texts else "host"
            unit.funcs.append(Func(name, scope + name, kind, path,
                                   head[0].line if head else toks[i].line,
                                   params, _template_params(head), body))
        i = j + 1
        if i < len(toks) and toks[i].text == ";":
            i += 1
        start = i


# ------------------------------------------------------------- evaluation
class Unresolved(Exception):
    pass


class Evaluator:
    """C integer expression -> Python value. ``env`` maps names to values or
    to token lists (evaluated on demand, e.g. constexprs and locals);
    ``sizeof`` takes a type (``sizes``) or a named struct (``struct_size``).
    A member chain ``a.b.c`` (or ``a.b.c()``) resolves as its last name."""

    def __init__(self, env: Dict[str, object],
                 struct_size: Optional[Callable[[str], int]] = None):
        self.env, self.struct_size = env, struct_size
        self._busy: set = set()

    def value(self, name: str):
        if name not in self.env:
            raise Unresolved(name)
        v = self.env[name]
        if isinstance(v, list):
            if name in self._busy:
                raise Unresolved(name)
            self._busy.add(name)
            sub = Evaluator(self.env, self.struct_size)
            sub._busy = self._busy
            try:
                v = sub.eval(v)
            finally:
                self._busy.discard(name)
            self.env[name] = v
        return v

    def eval(self, toks: Sequence[Tok]):
        self.toks, self.i = [t.text for t in toks], 0
        v = self._ternary()
        if self.i != len(self.toks):
            raise Unresolved(" ".join(self.toks))
        return v

    # -- recursive descent
    def _peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def _take(self, want=None):
        t = self._peek()
        if t is None or (want is not None and t != want):
            raise Unresolved(f"expected {want!r} at {t!r}")
        self.i += 1
        return t

    def _ternary(self):
        c = self._binary(0)
        if self._peek() == "?":
            self._take()
            a = self._ternary()
            self._take(":")
            b = self._ternary()
            return a if c else b
        return c

    _PREC = [("||",), ("&&",), ("|",), ("^",), ("&",), ("==", "!="),
             ("<", "<=", ">", ">="), ("<<", ">>"), ("+", "-"),
             ("*", "/", "%")]

    def _binary(self, level):
        if level == len(self._PREC):
            return self._unary()
        v = self._binary(level + 1)
        while self._peek() in self._PREC[level]:
            op = self._take()
            w = self._binary(level + 1)
            v = self._apply(op, v, w)
        return v

    @staticmethod
    def _apply(op, a, b):
        if op == "/":
            return a / b if isinstance(a, float) or isinstance(b, float) \
                else int(a / b)
        if op == "%":
            return a % b
        return {"||": lambda: int(bool(a) or bool(b)),
                "&&": lambda: int(bool(a) and bool(b)),
                "|": lambda: a | b, "^": lambda: a ^ b, "&": lambda: a & b,
                "==": lambda: int(a == b), "!=": lambda: int(a != b),
                "<": lambda: int(a < b), "<=": lambda: int(a <= b),
                ">": lambda: int(a > b), ">=": lambda: int(a >= b),
                "<<": lambda: a << b, ">>": lambda: a >> b,
                "+": lambda: a + b, "-": lambda: a - b,
                "*": lambda: a * b}[op]()

    def _unary(self):
        t = self._peek()
        if t in ("-", "+", "!", "~"):
            self._take()
            v = self._unary()
            return {"-": -v, "+": v, "!": int(not v), "~": ~v}[t]
        if t == "(" and self._is_cast():
            self._take()
            while self._take() != ")":
                pass
            return self._unary()
        return self._postfix()

    def _is_cast(self):
        j, seen = self.i + 1, []
        while j < len(self.toks) and self.toks[j] != ")":
            seen.append(self.toks[j])
            j += 1
        return bool(seen) and all(
            s in TYPE_SIZES or s in ("unsigned", "long", "const", "*")
            for s in seen)

    def _type_size(self, names: List[str]) -> int:
        base = [n for n in names if n not in ("const", "unsigned", "signed",
                                              "struct")]
        if "*" in base:
            return 8
        key = "".join(base) or "unsigned"
        if key in TYPE_SIZES:
            return TYPE_SIZES[key]
        if key in self.env:
            return int(self.value(key))
        if self.struct_size is not None:
            return self.struct_size(key)
        raise Unresolved(f"sizeof({key})")

    def _postfix(self):
        t = self._take()
        if t == "(":
            v = self._ternary()
            self._take(")")
            return v
        if t == "sizeof":
            self._take("(")
            depth, names = 1, []
            while True:
                x = self._take()
                depth += (x == "(") - (x == ")")
                if depth == 0:
                    break
                names.append(x)
            return self._type_size(names)
        if t == "static_cast":
            self._take("<")
            while self._take() != ">":
                pass
            self._take("(")
            v = self._ternary()
            self._take(")")
            return v
        if re.match(r"\d", t):
            m = re.match(r"(\d+\.\d*(?:e[-+]?\d+)?|\d+e[-+]?\d+)[fF]?$|"
                         r"(0x[0-9a-fA-F]+|\d+)[uUlL]*$", t)
            if m is None:
                raise Unresolved(t)
            return float(m.group(1)) if m.group(1) else int(m.group(2), 0)
        if not re.match(r"[A-Za-z_]", t):
            raise Unresolved(t)
        name = t
        while self._peek() in (".", "->", "::"):     # member chain: last name
            self._take()
            name = self._take()
        if self._peek() == "(":
            self._take()
            args = []
            while self._peek() != ")":
                args.append(self._ternary())
                if self._peek() == ",":
                    self._take()
            self._take(")")
            return self._call(name, args)
        return self.value(name)

    def _call(self, name, args):
        if name in ("min", "fminf") and len(args) == 2:
            return min(args)
        if name in ("max", "fmaxf") and len(args) == 2:
            return max(args)
        if name == "cdiv" and len(args) == 2:
            return -(-args[0] // args[1])
        if name == "pad4" and len(args) == 1:
            return (args[0] + 3) & ~3
        if not args:
            return self.value(name)          # ``c.sp.splits()``: a symbol
        raise Unresolved(f"{name}(...)")
