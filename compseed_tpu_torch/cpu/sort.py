"""Faithful replica of klib's ks_introsort (cstl/ksort.h:146-226).

The reference sorts chains, alignment regions and seeds with ks_introsort,
whose ordering of *equal* keys is a deterministic but non-stable
permutation.  Exact SAM parity requires reproducing that permutation, so
this module mirrors the algorithm step for step (median-ish pivot choice,
depth-limited quicksort leaving <=16-element runs, comb-sort fallback,
final insertion pass).
"""

from __future__ import annotations

from typing import Callable, List


def _insertsort(a: list, s: int, t: int, lt: Callable) -> None:
    for i in range(s + 1, t):
        j = i
        while j > s and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a: list, s: int, n: int, lt: Callable) -> None:
    shrink = 1.2473309501039786540366528676643
    gap = n
    while True:
        if gap > 2:
            gap = int(gap / shrink)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(s, s + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
        if not (do_swap or gap > 2):
            break
    if gap != 1:
        _insertsort(a, s, s + n, lt)


def ks_introsort(a: List, lt: Callable) -> None:
    """In-place sort of `a` with strict-less `lt`, replicating ks_introsort."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    stack: list[tuple[int, int, int]] = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, s, t - s + 1, lt)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, 0, n, lt)
                return
            s, t, d = stack.pop()
