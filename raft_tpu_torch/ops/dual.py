"""Forward-mode tangents carried by hand.

A :class:`Dual` is a value with k tangents along a leading axis.  The
arithmetic operators and the functions below propagate them, one plain
torch op per tangent op, so a loop of small elementwise steps costs no
per-op dispatch through ``torch.func``'s transform layers.  Each
function accepts plain tensors too and then returns the plain result.

The catenary mooring carries its six pose tangents this way
(:mod:`raft_tpu_torch.physics.mooring`), and the rotor's blade-element
momentum solve its (wind speed, rotor speed, pitch) tangents
(:mod:`raft_tpu_torch.physics.aero`).  Where a JAX primitive's
derivative has a tie rule (``maximum``, ``clip``), the tangent here
follows one branch: the two differ only on exact ties.
"""

from __future__ import annotations

import torch


class Dual:
    """A value ``v`` with forward-mode tangents ``t`` along a leading
    axis of k directions (``t.shape == (k,) + v.shape``, or any shape
    that broadcasts to it)."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v = v
        self.t = t

    def __neg__(self):
        return Dual(-self.v, -self.t)

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.t + o.t)
        return Dual(self.v + o, self.t)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.t - o.t)
        return Dual(self.v - o, self.t)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.t)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.t * o.v + self.v * o.t)
        return Dual(self.v * o, self.t * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Dual):
            q = self.v / o.v
            return Dual(q, (self.t - q * o.t) / o.v)
        return Dual(self.v / o, self.t / o)

    def __rtruediv__(self, o):
        q = o / self.v
        return Dual(q, -q * self.t / self.v)

    def __pow__(self, p):
        """``x ** p`` for a constant exponent ``p``."""
        y = self.v ** p
        return Dual(y, p * self.v ** (p - 1) * self.t)


def value(x):
    """The primal value of ``x`` (``x`` itself when it is no Dual)."""
    return x.v if isinstance(x, Dual) else x


def unary(x, f, df):
    """f(x) with its tangent df(x, f(x)) * t."""
    if isinstance(x, Dual):
        y = f(x.v)
        return Dual(y, df(x.v, y) * x.t)
    return f(x)


def sqrt(x):
    return unary(x, torch.sqrt, lambda v, y: 0.5 / y)


def asinh(x):
    return unary(x, torch.asinh, lambda v, y: 1.0 / torch.sqrt(1.0 + v * v))


def tanh(x):
    return unary(x, torch.tanh, lambda v, y: 1.0 - y * y)


def sin(x):
    return unary(x, torch.sin, lambda v, y: torch.cos(v))


def cos(x):
    return unary(x, torch.cos, lambda v, y: -torch.sin(v))


def exp(x):
    return unary(x, torch.exp, lambda v, y: y)


def arccos(x):
    return unary(x, torch.arccos, lambda v, y: -1.0 / torch.sqrt(1.0 - v * v))


def abs_(x):
    return unary(x, torch.abs, lambda v, y: torch.sgn(v))


def clamp_min(x, lo):
    """``max(x, lo)`` for a constant ``lo``: tangent passes where x > lo."""
    return unary(x, lambda v: torch.clamp(v, min=lo),
                 lambda v, y: (v > lo).to(v.dtype))


def clip(x, lo, hi):
    """``min(max(x, lo), hi)`` for constants: tangent passes strictly
    inside (lo, hi)."""
    return unary(x, lambda v: torch.clamp(v, min=lo, max=hi),
                 lambda v, y: ((v > lo) & (v < hi)).to(v.dtype))


def where(cond, a, b):
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        return torch.where(cond, a, b)
    av, bv = value(a), value(b)
    at = a.t if isinstance(a, Dual) else torch.zeros_like(b.t)
    bt = b.t if isinstance(b, Dual) else torch.zeros_like(a.t)
    return Dual(torch.where(cond, av, bv), torch.where(cond, at, bt))


def maximum(a, b):
    return where(value(a) >= value(b), a, b)


def stack(xs, dim):
    """``torch.stack`` along ``dim`` (a negative dim: counted from the
    end, so the tangents' leading axis is left alone)."""
    if not any(isinstance(x, Dual) for x in xs):
        return torch.stack(xs, dim=dim)
    if dim >= 0:
        raise ValueError("stack of Duals needs a negative dim")
    vs = [value(x) for x in xs]
    ref = next(x.t for x in xs if isinstance(x, Dual))
    ts = [x.t if isinstance(x, Dual) else
          torch.zeros_like(ref).expand(ref.shape[:1] + x.shape)
          for x in xs]
    shape = torch.broadcast_shapes(*(t.shape for t in ts))
    return Dual(torch.stack(vs, dim=dim),
                torch.stack([t.expand(shape) for t in ts], dim=dim))


def linear(x, f):
    """``f(x)`` for a function ``f`` linear in ``x`` along the trailing
    axes (a sum, a mean, a trapezoid rule): applied to the value and to
    every tangent alike."""
    if isinstance(x, Dual):
        return Dual(f(x.v), f(x.t))
    return f(x)
