"""The Params expression language.

A re-implementation of the reference's "Digithell Expression Evaluator"
(C++ class EXPRESSION, ``libsource/exprsion/exp_all.cc``) plus the
``install_evaluator_extensions()`` operator set
(``libsource/exprsion/ee_wrapper.cc:241-360``) as a tokenizer + Pratt parser
producing an AST that can be evaluated either on scalars or **vectorized over
numpy arrays** — the reference evaluates initial-condition formulas one
grid cell at a time (``intertrack.c:1929-2016``); here a parsed formula is
evaluated once over whole coordinate arrays.

Language summary (priorities from ``exp_all.cc:402-445`` and
``ee_wrapper.cc:321-334``; smaller number binds tighter, negative = postfix):

======  =======================================================
 10     ``toDeg x``, ``toRad x``            (prefix)
-12     ``x !``  factorial                  (postfix)
 14     ``x ^ y``, ``x root y``             (y-th root: ``y^(1/x)``)
 16     unary ``- +``, ``int floor ceil round abs sin cos tan asin acos
        atan sinh cosh tanh asinh acosh atanh log ln sqrt exp pow10
        rand sgn`` (prefix), ``x max y``, ``x min y`` (binary)
 18     ``x C y`` (combinations), ``x P y`` (permutations)
 20     ``* /``
 22     binary ``+ -``
 24     ``< > =``
 25     ``not x``
 26     ``and or``
 27/28  ``c ? a : b``  (both branches always evaluated)
======  =======================================================

Constants: ``pi``, ``e``.  ``log`` is base-10, ``ln`` natural.  Domain
errors yield 0 (the reference's evaluator returns 0 and records an error
code, and callers like the icond loop use the value regardless).

Numbers follow the reference lexer: an exponent sign directly after a
trailing ``e``/``E`` of a non-identifier token is part of the number
(``exp_all.cc:700-712``), so ``1e-3`` is a single literal.
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np


class ExpressionError(ValueError):
    """Syntax error or undefined symbol in a formula."""

    def __init__(self, message: str, location: Optional[int] = None):
        super().__init__(message)
        self.location = location


# --------------------------------------------------------------------------
# Operator tables.  Priority values are copied from the reference
# registration calls; binding power = 100 - priority (higher binds tighter).
# --------------------------------------------------------------------------

def _bp(priority: int) -> int:
    return 100 - priority


def _safe(cond, value, xp):
    """Return ``value`` where ``cond`` holds, else 0 (reference: errors -> 0)."""
    return xp.where(cond, value, xp.zeros_like(value))


def _fact(x, xp):
    # x! via gamma; domain errors -> 0
    with np.errstate(all="ignore"):
        try:
            from scipy.special import gamma as _g  # noqa: F401
        except Exception:
            _g = None
    xf = xp.asarray(x, dtype=float)
    if _g is not None and xp is np:
        val = _g(xf + 1.0)
    else:
        val = xp.exp(_lgamma(xf + 1.0, xp))
    return xp.where(xf >= 0, val, xp.zeros_like(val))


def _lgamma(x, xp):
    # formulas are evaluated with numpy only in this package
    return np.vectorize(math.lgamma)(x)


def _perm(x, y, xp):
    ok = (x >= 0) & (y >= 0) & (x == xp.floor(x)) & (y == xp.floor(y)) & (x >= y)
    val = xp.exp(_lgamma(x + 1.0, xp) - _lgamma(x - y + 1.0, xp))
    return _safe(ok, xp.round(val), xp)


def _comb(x, y, xp):
    ok = (x >= 0) & (y >= 0) & (x == xp.floor(x)) & (y == xp.floor(y)) & (x >= y)
    val = xp.exp(_lgamma(x + 1.0, xp) - _lgamma(y + 1.0, xp) - _lgamma(x - y + 1.0, xp))
    return _safe(ok, xp.round(val), xp)


def _xint(x, xp):
    # int x: truncation toward zero (exp_all.cc:115-119)
    return xp.where(x > 0, xp.floor(x), xp.ceil(x))


_PRNG = np.random.RandomState(1)


def ev_random(seed: int = 0) -> float:
    """Reference ``ev_random`` (ee_wrapper.h): uniform in (0,1); nonzero seed
    re-seeds the private PRNG."""
    global _PRNG
    if seed:
        _PRNG = np.random.RandomState(seed & 0xFFFFFFFF)
    return float(_PRNG.random_sample())


def _rand_op(x, xp):
    # 'rand x' re-seeds with (unsigned)x if nonzero, returns uniform (0,1)
    return xp.asarray(ev_random(int(np.max(np.asarray(x)))) if np.ndim(x) == 0 else ev_random(0))


# prefix unary operators: name -> (priority, fn(x, xp))
_UNARY: Dict[str, Tuple[int, Callable]] = {
    "toDeg": (10, lambda x, xp: x * (180.0 / math.pi)),
    "toRad": (10, lambda x, xp: x * (math.pi / 180.0)),
    "-": (16, lambda x, xp: -x),
    "+": (16, lambda x, xp: x),
    "int": (16, _xint),
    "floor": (16, lambda x, xp: xp.floor(x)),
    "ceil": (16, lambda x, xp: xp.ceil(x)),
    "round": (16, lambda x, xp: xp.round(x)),
    "abs": (16, lambda x, xp: xp.abs(x)),
    "sin": (16, lambda x, xp: xp.sin(x)),
    "cos": (16, lambda x, xp: xp.cos(x)),
    "tan": (16, lambda x, xp: xp.tan(x)),
    "asin": (16, lambda x, xp: _safe(xp.abs(x) <= 1, xp.arcsin(xp.clip(x, -1, 1)), xp)),
    "acos": (16, lambda x, xp: _safe(xp.abs(x) <= 1, xp.arccos(xp.clip(x, -1, 1)), xp)),
    "atan": (16, lambda x, xp: xp.arctan(x)),
    "sinh": (16, lambda x, xp: xp.sinh(x)),
    "cosh": (16, lambda x, xp: xp.cosh(x)),
    "tanh": (16, lambda x, xp: xp.tanh(x)),
    "asinh": (16, lambda x, xp: xp.arcsinh(x)),
    "acosh": (16, lambda x, xp: _safe(x >= 1, xp.arccosh(xp.maximum(x, 1)), xp)),
    "atanh": (16, lambda x, xp: _safe(xp.abs(x) < 1, xp.arctanh(xp.clip(x, -1 + 1e-300, 1 - 1e-300)), xp)),
    "log": (16, lambda x, xp: _safe(x > 0, xp.log10(xp.where(x > 0, x, 1.0)), xp)),
    "ln": (16, lambda x, xp: _safe(x > 0, xp.log(xp.where(x > 0, x, 1.0)), xp)),
    "sqrt": (16, lambda x, xp: _safe(x >= 0, xp.sqrt(xp.maximum(x, 0)), xp)),
    "exp": (16, lambda x, xp: xp.exp(x)),
    "pow10": (16, lambda x, xp: xp.power(10.0, x)),
    "rand": (16, _rand_op),
    "sgn": (16, lambda x, xp: xp.sign(x)),
    "not": (25, lambda x, xp: xp.where(x != 0, 0.0, 1.0)),
}


def _power(x, y, xp):
    # negative base with non-integer exponent -> domain error -> 0
    neg_frac = (x < 0) & (y != xp.floor(y))
    base = xp.where(neg_frac, xp.ones_like(x * y), x * xp.ones_like(y))
    with np.errstate(all="ignore"):
        val = xp.power(base, y)
    return _safe(~neg_frac, val, xp)


# binary operators: name -> (priority, fn(x, y, xp))
_BINARY: Dict[str, Tuple[int, Callable]] = {
    "^": (14, _power),
    "root": (14, lambda x, y, xp: _safe(x != 0, _power(y, 1.0 / xp.where(x != 0, x, 1.0), xp), xp)),
    "max": (16, lambda x, y, xp: xp.maximum(x, y)),
    "min": (16, lambda x, y, xp: xp.minimum(x, y)),
    "C": (18, _comb),
    "P": (18, _perm),
    "*": (20, lambda x, y, xp: x * y),
    "/": (20, lambda x, y, xp: _safe(y != 0, x / xp.where(y != 0, y, 1.0), xp)),
    "+": (22, lambda x, y, xp: x + y),
    "-": (22, lambda x, y, xp: x - y),
    "<": (24, lambda x, y, xp: xp.where(x < y, 1.0, 0.0)),
    ">": (24, lambda x, y, xp: xp.where(x > y, 1.0, 0.0)),
    "=": (24, lambda x, y, xp: xp.where(x == y, 1.0, 0.0)),
    "and": (26, lambda x, y, xp: xp.where((x != 0) & (y != 0), 1.0, 0.0)),
    "or": (26, lambda x, y, xp: xp.where((x != 0) | (y != 0), 1.0, 0.0)),
}

_QMARK_PRIO = 27  # '?' ; ':' has 28 (ee_wrapper.cc:333-334)

# postfix unary: name -> (priority magnitude, fn)
_POSTFIX: Dict[str, Tuple[int, Callable]] = {
    "!": (12, _fact),
}

_CONSTANTS = {"pi": math.pi, "e": math.e}

_SPECIAL_CHARS = set("+-*/^!<>=?:")


# --------------------------------------------------------------------------
# Tokenizer
# --------------------------------------------------------------------------

_IDENT_RE = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")
_NUM_START = re.compile(r"[0-9.]")


class _Token:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind: str, text: str, pos: int):
        self.kind = kind  # 'ident' | 'num' | 'op' | 'lpar' | 'rpar'
        self.text = text
        self.pos = pos

    def __repr__(self):  # pragma: no cover
        return f"{self.kind}:{self.text}"


def _float_val(tok: str) -> float:
    """Lenient float conversion following strings/str_fval.c: invalid
    characters inside a number are skipped."""
    try:
        return float(tok)
    except ValueError:
        pass
    out: List[str] = []
    point = exp = False
    for ch in tok:
        if ch == "." and not point and not exp:
            point = True
            out.append(ch)
        elif ch in "eE" and not exp:
            exp = True
            out.append("e")
        elif ch in "+-" and out and out[-1] == "e":
            out.append(ch)
        elif ch.isdigit():
            out.append(ch)
    try:
        return float("".join(out))
    except ValueError:
        return 0.0


def tokenize(src: str) -> List[_Token]:
    toks: List[_Token] = []
    i, n = 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
            continue
        if c == "(":
            toks.append(_Token("lpar", c, i))
            i += 1
        elif c == ")":
            toks.append(_Token("rpar", c, i))
            i += 1
        elif _IDENT_RE.match(c) and not c.isdigit():
            m = _IDENT_RE.match(src, i)
            toks.append(_Token("ident", m.group(0), i))
            i = m.end()
        elif _NUM_START.match(c):
            j = i
            while j < n and (src[j].isalnum() or src[j] == "."):
                j += 1
                # exponent sign: '+'/'-' directly after a trailing e/E of a
                # number token continues the number (exp_all.cc:708-711)
                if j < n and src[j] in "+-" and src[j - 1] in "eE":
                    j += 1
            toks.append(_Token("num", src[i:j], i))
            i = j
        elif c in _SPECIAL_CHARS:
            toks.append(_Token("op", c, i))
            i += 1
        else:
            raise ExpressionError(f"invalid character {c!r}", i)
    return toks


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------
# Nodes are tuples:
#   ('num', value) ('var', name) ('un', opname, child)
#   ('bin', opname, lhs, rhs) ('post', opname, child)
#   ('tern', cond, then, else)


class Expression:
    """A parsed formula.  Parse once, evaluate many times (over scalars or
    arrays) — the reference's ``ev_parse`` / ``ev_evaluate`` split."""

    def __init__(self, source: str):
        self.source = source
        self.ast = _Parser(tokenize(source)).parse()
        self._names: Set[str] = set()
        _collect_names(self.ast, self._names)

    @property
    def names(self) -> Set[str]:
        """Free variable names (excluding built-in constants)."""
        return set(self._names)

    def __call__(self, env: Optional[Dict[str, Any]] = None, xp=np):
        return self.evaluate(env, xp)

    def evaluate(self, env: Optional[Dict[str, Any]] = None, xp=np):
        """Evaluate; ``env`` maps variable names to scalars or arrays
        (broadcast together).  Raises ExpressionError on undefined names —
        the hook the multi-pass icond resolution relies on."""
        env = env or {}
        missing = self._names.difference(env)
        if missing:
            raise ExpressionError(
                "undefined symbol(s): " + ", ".join(sorted(missing)))
        return _eval(self.ast, env, xp)


def _collect_names(node, out: Set[str]) -> None:
    tag = node[0]
    if tag == "var":
        if node[1] not in _CONSTANTS:
            out.add(node[1])
    elif tag in ("un", "post"):
        _collect_names(node[2], out)
    elif tag == "bin":
        _collect_names(node[2], out)
        _collect_names(node[3], out)
    elif tag == "tern":
        for child in node[1:]:
            _collect_names(child, out)


def _eval(node, env, xp):
    tag = node[0]
    if tag == "num":
        return node[1]
    if tag == "var":
        name = node[1]
        if name in env:
            return env[name]
        return _CONSTANTS[name]
    if tag == "un":
        return _UNARY[node[1]][1](xp.asarray(_eval(node[2], env, xp), dtype=float), xp)
    if tag == "post":
        return _POSTFIX[node[1]][1](xp.asarray(_eval(node[2], env, xp), dtype=float), xp)
    if tag == "bin":
        x = xp.asarray(_eval(node[2], env, xp), dtype=float)
        y = xp.asarray(_eval(node[3], env, xp), dtype=float)
        return _BINARY[node[1]][1](x, y, xp)
    if tag == "tern":
        c = xp.asarray(_eval(node[1], env, xp), dtype=float)
        a = xp.asarray(_eval(node[2], env, xp), dtype=float)
        b = xp.asarray(_eval(node[3], env, xp), dtype=float)
        # both branches are always evaluated (ee_wrapper.h caveat)
        return xp.where(c != 0, a, b)
    raise AssertionError(tag)


class _Parser:
    """Pratt parser over the reference's priority table."""

    def __init__(self, tokens: List[_Token]):
        self.toks = tokens
        self.i = 0

    def parse(self):
        if not self.toks:
            raise ExpressionError("empty expression")
        node = self._expr(0)
        if self.i < len(self.toks):
            t = self.toks[self.i]
            raise ExpressionError(f"unexpected {t.text!r}", t.pos)
        return node

    def _peek(self) -> Optional[_Token]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def _next(self) -> _Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def _expr(self, min_bp: int):
        node = self._nud()
        while True:
            t = self._peek()
            if t is None or t.kind == "rpar":
                return node
            name = t.text
            if t.kind in ("ident", "op"):
                if name in _POSTFIX:
                    bp = _bp(_POSTFIX[name][0])
                    if bp < min_bp:
                        return node
                    self._next()
                    node = ("post", name, node)
                    continue
                if name == "?":
                    bp = _bp(_QMARK_PRIO)
                    if bp < min_bp:
                        return node
                    self._next()
                    then = self._expr(_bp(_QMARK_PRIO) + 1)
                    colon = self._peek()
                    if colon is None or colon.text != ":":
                        raise ExpressionError("'?' without ':'", t.pos)
                    self._next()
                    other = self._expr(_bp(_QMARK_PRIO))  # right-assoc
                    node = ("tern", node, then, other)
                    continue
                if name in _BINARY:
                    bp = _bp(_BINARY[name][0])
                    if bp < min_bp:
                        return node
                    self._next()
                    rhs = self._expr(bp + 1)  # left-associative
                    node = ("bin", name, node, rhs)
                    continue
            return node

    def _nud(self):
        t = self._peek()
        if t is None:
            raise ExpressionError("unexpected end of expression")
        if t.kind == "num":
            self._next()
            return ("num", _float_val(t.text))
        if t.kind == "lpar":
            self._next()
            node = self._expr(0)
            t2 = self._peek()
            if t2 is None:
                # end of expression closes all open parentheses, like the
                # reference's Eval_Stack(precedence>32) (exp_all.cc:352-354);
                # the shipped LR Params rely on it: the gl icond formula
                # "0.5*(1.0 + tanh(0.5/xi_gl*(z-0.055))" lacks a ')'
                return node
            if t2.kind != "rpar":
                raise ExpressionError("missing ')'", t.pos)
            self._next()
            return node
        if t.kind in ("ident", "op"):
            name = t.text
            if name in _UNARY:
                self._next()
                operand = self._expr(_bp(_UNARY[name][0]) + 1)
                return ("un", name, operand)
            if t.kind == "ident":
                self._next()
                return ("var", name)
        raise ExpressionError(f"unexpected {t.text!r}", t.pos)


# --------------------------------------------------------------------------
# Evaluator facade — the ee_wrapper C API equivalent
# --------------------------------------------------------------------------

class Evaluator:
    """Mutable variable environment + parse/eval calls, mirroring the
    reference's shared-instance C wrapper API (``include/ee_wrapper.h``):
    ``ev_def_var`` -> :meth:`define`, ``ev_parse``+``ev_evaluate`` ->
    :meth:`parse`/:meth:`evaluate`, ``eval`` -> :meth:`eval`,
    ``ev_reset`` -> :meth:`reset`."""

    def __init__(self, xp=np):
        self.vars: Dict[str, Any] = {}
        self.xp = xp
        self._parsed: Optional[Expression] = None

    def define(self, name: str, value) -> None:
        self.vars[name] = value

    def defined(self, name: str) -> bool:
        return name in self.vars or name in _CONSTANTS

    def reset(self) -> None:
        self.vars.clear()

    def parse(self, source: str) -> Expression:
        self._parsed = Expression(source)
        return self._parsed

    def evaluate(self, env: Optional[Dict[str, Any]] = None):
        if self._parsed is None:
            raise ExpressionError("no expression parsed")
        merged = dict(self.vars)
        if env:
            merged.update(env)
        return self._parsed.evaluate(merged, self.xp)

    def eval(self, source: str, env: Optional[Dict[str, Any]] = None):
        """Parse + evaluate in one call (the reference's ``eval()``)."""
        return Expression(source).evaluate(
            {**self.vars, **(env or {})}, self.xp)
