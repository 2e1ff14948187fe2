"""Symbolic scenario expressions for the cost IR.

An :class:`Expr` is a tiny numpy-evaluated expression tree over named
scenario parameters (``n``, ``p``, ``c``, ``r``, ``q``, ``d``, plus the
machine thread count ``t`` injected by the evaluator).  Model authors write
ordinary arithmetic (``n / sqrt(p / c)``) and the same tree evaluates for a
single scalar scenario or — the point of the IR — broadcast over numpy
grids of scenarios in one pass.

Only the operations the closed-form paper models need are provided:
arithmetic, ``sqrt``/``floor``/``rint``, ``fmax``/``fmin``, ``where``, and
the closed-form decreasing sum ``sum_decreasing`` that collapses the
triangular loops of TRSM/Cholesky/LU (paper §V-B).
"""

from __future__ import annotations

from typing import Any, Dict, Union

import numpy as np

#: the scenario parameters a model program may reference
SCENARIO_PARAMS = ("n", "p", "c", "r", "q", "d", "t")

ExprLike = Union["Expr", float, int]


class Expr:
    """Base node: evaluate with :meth:`ev` against an env of numpy arrays."""

    def ev(self, env: Dict[str, Any]):
        raise NotImplementedError

    # -- operator sugar ------------------------------------------------------
    def __add__(self, other): return _Bin(np.add, self, as_expr(other))
    def __radd__(self, other): return _Bin(np.add, as_expr(other), self)
    def __sub__(self, other): return _Bin(np.subtract, self, as_expr(other))
    def __rsub__(self, other): return _Bin(np.subtract, as_expr(other), self)
    def __mul__(self, other): return _Bin(np.multiply, self, as_expr(other))
    def __rmul__(self, other): return _Bin(np.multiply, as_expr(other), self)
    def __truediv__(self, other): return _Bin(np.divide, self, as_expr(other))
    def __rtruediv__(self, other): return _Bin(np.divide, as_expr(other), self)
    def __pow__(self, other): return _Bin(np.power, self, as_expr(other))
    def __neg__(self): return _Bin(np.multiply, Const(-1.0), self)


class Param(Expr):
    """A named scenario parameter, looked up in the evaluation env."""

    def __init__(self, name: str):
        if name not in SCENARIO_PARAMS:
            raise ValueError(f"unknown scenario parameter {name!r}; "
                             f"have {SCENARIO_PARAMS}")
        self.name = name

    def ev(self, env):
        try:
            return env[self.name]
        except KeyError:
            raise KeyError(f"scenario parameter {self.name!r} missing from "
                           f"env (have {sorted(env)})") from None

    def __repr__(self):
        return self.name


class Const(Expr):
    def __init__(self, value: float):
        self.value = float(value)

    def ev(self, env):
        return self.value

    def __repr__(self):
        return repr(self.value)


class _Bin(Expr):
    def __init__(self, fn, a: Expr, b: Expr):
        self.fn, self.a, self.b = fn, a, b

    def ev(self, env):
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.fn(self.a.ev(env), self.b.ev(env))

    def __repr__(self):
        return f"{self.fn.__name__}({self.a!r}, {self.b!r})"


class _Fn(Expr):
    def __init__(self, fn, *args: Expr):
        self.fn, self.args = fn, args

    def ev(self, env):
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.fn(*[a.ev(env) for a in self.args])

    def __repr__(self):
        names = ", ".join(repr(a) for a in self.args)
        return f"{self.fn.__name__}({names})"


def as_expr(x: ExprLike) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, float)):
        return Const(x)
    raise TypeError(f"cannot convert {type(x).__name__} to Expr")


def sqrt(x: ExprLike) -> Expr: return _Fn(np.sqrt, as_expr(x))
def floor(x: ExprLike) -> Expr: return _Fn(np.floor, as_expr(x))
def rint(x: ExprLike) -> Expr:
    """Round half to even — matches ``int(round(x))`` on CPython floats."""
    return _Fn(np.rint, as_expr(x))


def fmax(a: ExprLike, b: ExprLike) -> Expr:
    return _Fn(np.maximum, as_expr(a), as_expr(b))


def fmin(a: ExprLike, b: ExprLike) -> Expr:
    return _Fn(np.minimum, as_expr(a), as_expr(b))


def where(cond_gt_zero: ExprLike, a: ExprLike, b: ExprLike) -> Expr:
    """``a`` where ``cond_gt_zero > 0``, else ``b``."""
    return _Fn(lambda c, x, y: np.where(np.asarray(c) > 0, x, y),
               as_expr(cond_gt_zero), as_expr(a), as_expr(b))


def sum_decreasing(nb: ExprLike, offset: float = 0.0) -> Expr:
    """``sum_{i=0}^{k-1} (nb - i - offset)`` with ``k = rint(nb)`` — the
    closed form that keeps triangular loops O(1) (transcribed verbatim from
    the pre-IR ``algorithms._sum_decreasing``)."""
    nb = as_expr(nb)
    k = rint(nb)
    return k * nb - (k - 1.0) * k * 0.5 - offset * k


def sum_squares(nb: ExprLike) -> Expr:
    """``sum_{m=1}^{k-1} m^2 = (k-1) k (2k-1) / 6`` with ``k = rint(nb)``."""
    k = rint(as_expr(nb))
    return (k - 1.0) * k * (2.0 * k - 1.0) / 6.0


#: the canonical scenario parameters, ready to import in model programs
N, P, C, R, Q, D, T = (Param(x) for x in SCENARIO_PARAMS)
