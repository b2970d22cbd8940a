"""ConvDK scheduling — Theorems 1-2 and Algorithm 1 of the paper as executable
number theory.

The paper ("Computing-In-Memory Dataflow for Minimal Buffer Traffic", Song &
Jeong, 2025) proves that a 1-D convolution ``z = k * I`` with kernel width
``k_w`` (odd) and stride ``s < k_w`` can be computed from an ``N``-times
duplicated kernel and a *single* loaded IA strip that is shifted only
``l - 1 = lcm(k_w, s)/s - 1`` times:

    every output index ``m`` satisfies   m*s = n*k_w + a          (Eq. 6)

for exactly one pair ``(a, n)`` with shift ``a in [0, l)`` and kernel-block
index ``n in [0, N)``.  Theorem 1 gives the arithmetic progression of valid
``(m, n)`` for each ``a``; Theorem 2 proves the progressions for different
``a`` are disjoint and jointly cover all non-negative integers, provided

    Condition 1:  k_w odd, s < k_w
    Condition 2:  exists m1, n1 >= 0 with  m1*s = n1*k_w + 1
    Condition 3:  gcd(m1, l) == 1  where  l = lcm(k_w, s)/s

Everything in this module is plain Python integer arithmetic: the schedule is
*static* and consumed by the executable dataflow in ``core.convdk``.  A copy
of ``repro.core.schedule`` (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Tuple


class ConvDKConditionError(ValueError):
    """Raised when (k, s) violate Conditions 1-3 and ConvDK does not apply."""


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def shift_count(k: int, s: int) -> int:
    """``l = lcm(k, s)/s`` — number of IA shift positions (a = 0 .. l-1)."""
    return _lcm(k, s) // s


def block_period(k: int, s: int) -> int:
    """``p = lcm(k, s)/k`` — period of the active-block index n within a cycle."""
    return _lcm(k, s) // k


def check_conditions(k: int, s: int) -> None:
    """Validate Conditions 1-3 from Sec. II-C.  Raises ConvDKConditionError."""
    if k < 1 or s < 1:
        raise ConvDKConditionError(f"k={k}, s={s} must be positive")
    if k % 2 == 0:
        raise ConvDKConditionError(f"Condition 1 violated: k={k} must be odd")
    if not s < k:
        raise ConvDKConditionError(f"Condition 1 violated: s={s} must be < k={k}")
    if math.gcd(k, s) != 1:
        # m1*s = n1*k + 1 has a solution iff gcd(s, k) | 1.
        raise ConvDKConditionError(
            f"Condition 2 violated: m1*s = n1*k + 1 unsolvable for k={k}, s={s} "
            f"(gcd={math.gcd(k, s)})"
        )
    m1, _ = solve_m1_n1(k, s)
    l = shift_count(k, s)
    if math.gcd(m1, l) != 1:
        raise ConvDKConditionError(
            f"Condition 3 violated: gcd(m1={m1}, l={l}) != 1 for k={k}, s={s}"
        )


def solve_m1_n1(k: int, s: int) -> Tuple[int, int]:
    """Least non-negative (m1, n1) with ``m1*s = n1*k + 1`` (Condition 2).

    ``m1`` is the modular inverse of ``s`` mod ``k`` (least positive residue);
    ``n1`` follows.  Requires gcd(k, s) == 1.
    """
    if math.gcd(k, s) != 1:
        raise ConvDKConditionError(f"no m1, n1 exist for k={k}, s={s}")
    m1 = pow(s, -1, k)  # in [0, k); == least non-negative solution
    n1 = (m1 * s - 1) // k
    return m1, n1


def duplication_number(k_w: int, s: int, width: int, t_w: int) -> int:
    """Eq. (8): ``N = (min(W, T_w) - lcm(k_w, s)/s + 1) // k_w``.

    ``width`` is the ifmap width W, ``t_w`` the widest strip the TRF can hold.
    Returns 0 when the strip is too narrow for even one kernel block.
    """
    l = shift_count(k_w, s)
    return max(0, (min(width, t_w) - l + 1) // k_w)


@dataclass(frozen=True)
class ShiftCycle:
    """One shift cycle ``a``: the active block indices ``n`` (multiplication-
    enable e_n = 1) and the output indices ``m`` they produce, in sub-cycle
    order (Algorithm 1's inner while loop)."""

    a: int
    ns: Tuple[int, ...]
    ms: Tuple[int, ...]


@dataclass(frozen=True)
class ConvDKSchedule:
    """Full static schedule of 1-D ConvDK for (k, s, N).

    Attributes
    ----------
    k, s, N  : kernel width, stride, duplication number.
    l        : number of shift cycles (``lcm(k,s)/s``).
    p        : block-index period per cycle (``lcm(k,s)/k``).
    m1, n1   : base solution of ``m1*s = n1*k + 1``.
    ia_len   : required IA strip length  ``N*k + l - 1``.
    out_len  : produced output length  ``floor(((N-1)k + l - 1)/s) + 1``.
    cycles   : per-shift ``ShiftCycle`` records (Algorithm 1 unrolled).
    """

    k: int
    s: int
    N: int
    l: int
    p: int
    m1: int
    n1: int
    ia_len: int
    out_len: int
    cycles: Tuple[ShiftCycle, ...] = field(repr=False)

    @property
    def total_subcycles(self) -> int:
        """Total MAC sub-cycles = total outputs produced (one per sub-cycle)."""
        return sum(len(c.ns) for c in self.cycles)

    @property
    def tm_rows_used(self) -> int:
        """Stationary rows occupied by the duplicated 1-D kernel (N*k)."""
        return self.N * self.k

    def active(self, a: int) -> ShiftCycle:
        return self.cycles[a]


@lru_cache(maxsize=None)
def make_schedule(k: int, s: int, N: int) -> ConvDKSchedule:
    """Build the static (a, n, m) schedule of Algorithm 1.

    for a = 0 .. l-1:
        n <- a*n1 mod p ;  m <- a*m1 mod l
        while n < N:  emit (a, n, m);  n += p;  m += l
    """
    check_conditions(k, s)
    if N < 1:
        raise ConvDKConditionError(f"duplication number N={N} must be >= 1")
    l = shift_count(k, s)
    p = block_period(k, s)
    m1, n1 = solve_m1_n1(k, s)

    cycles = []
    for a in range(l):
        n = (a * n1) % p
        m = (a * m1) % l
        ns, ms = [], []
        while n < N:
            # Invariant (Eq. 6): the emitted pair satisfies m*s == n*k + a.
            assert m * s == n * k + a, (m, s, n, k, a)
            ns.append(n)
            ms.append(m)
            n += p
            m += l
        cycles.append(ShiftCycle(a=a, ns=tuple(ns), ms=tuple(ms)))

    ia_len = N * k + l - 1
    out_len = ((N - 1) * k + l - 1) // s + 1
    return ConvDKSchedule(
        k=k, s=s, N=N, l=l, p=p, m1=m1, n1=n1,
        ia_len=ia_len, out_len=out_len, cycles=tuple(cycles),
    )


def covered_outputs(sched: ConvDKSchedule) -> Tuple[int, ...]:
    """All output indices m the schedule writes, in emission order."""
    out = []
    for c in sched.cycles:
        out.extend(c.ms)
    return tuple(out)


def is_exact_cover(sched: ConvDKSchedule) -> bool:
    """Theorem 2 check: every m in [0, out_len) is written exactly once."""
    ms = covered_outputs(sched)
    return len(ms) == len(set(ms)) and set(ms) == set(range(sched.out_len))
