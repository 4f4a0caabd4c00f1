"""The kernel work counts of work.py against a hand count: the algorithm
written out plainly on numbers that count every operation they take part
in, run for one element, at n = 4 (and a few other sizes)."""

import math
import random

import pytest

import work


class Tally:
    ops = 0


class Num(float):
    """A float that counts the operations it takes part in."""

    def _op(self, other, f):
        Tally.ops += 1
        return Num(f(float(self), float(other)))

    def __add__(self, o):
        return self._op(o, lambda a, b: a + b)

    __radd__ = __add__

    def __sub__(self, o):
        return self._op(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._op(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._op(o, lambda a, b: a * b)

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._op(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._op(o, lambda a, b: b / a)

    def __neg__(self):                 # a sign change counts none
        return Num(-float(self))

    def __abs__(self):
        return Num(abs(float(self)))


def f1(fn, x):
    Tally.ops += 1
    return Num(fn(float(x)))


def sqrt(x):
    return f1(math.sqrt, x)


def sin(x):
    return f1(math.sin, x)


def cos(x):
    return f1(math.cos, x)


def sign(x):
    return Num(math.copysign(1.0, float(x)))


EPS = 1e-7


def angles(app, aqq, xr, xi):
    # a fixed schedule takes every rotation: one whose pivot is already
    # negligible costs the same operations and then acts as the identity
    r = sqrt(xr * xr + xi * xi) if xi is not None else abs(xr)
    active = r > EPS * (abs(app) + abs(aqq) + r)
    x = xr if xi is None else r
    safe = x if active else Num(1.0)
    pr = pi = None
    if xi is not None:
        pr, pi = xr / safe, xi / safe
    tau = (aqq - app) / (2.0 * safe)
    t = sign(tau) / (abs(tau) + sqrt(1.0 + tau * tau))
    c = 1.0 / sqrt(1.0 + t * t)
    s = t * c
    shift = t * x
    if not active:
        c, s, shift = Num(1.0), Num(0.0), Num(0.0)
        if xi is not None:
            pr, pi = Num(1.0), Num(0.0)
    return c, s, shift, pr, pi


def mix(c, s, pr, pi, x, y):
    """(c x - s conj(ph) y, s ph x + c y); x, y (re, im) or (re, None)."""
    if pr is None:
        return (c * x[0] - s * y[0], None), (s * x[0] + c * y[0], None)
    yr, yi = pr * y[0] + pi * y[1], pr * y[1] - pi * y[0]
    xr, xi = pr * x[0] - pi * x[1], pr * x[1] + pi * x[0]
    return ((c * x[0] - s * yr, c * x[1] - s * yi),
            (s * xr + c * y[0], s * xi + c * y[1]))


def jacobi(n, sweeps, a, rows, cplx):
    """Cyclic Jacobi on a dict matrix a[(i, j)] = (re, im) of all entries,
    carrying ``rows`` rows of V; one-sided update through the symmetry."""
    v = [[(Num(1.0 if k == r else 0.0), Num(0.0) if cplx else None)
          for k in range(n)] for r in rows]
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                c, s, shift, pr, pi = angles(a[p, p][0], a[q, q][0],
                                             a[p, q][0], a[p, q][1])
                for i in range(n):
                    if i in (p, q):
                        continue
                    np_, nq = mix(c, s, pr, pi, a[i, p], a[i, q])
                    a[i, p], a[i, q] = np_, nq
                    conj = (lambda z: (z[0], -z[1] if cplx else None))
                    a[p, i], a[q, i] = conj(np_), conj(nq)
                a[p, p] = (a[p, p][0] - shift, a[p, p][1])
                a[q, q] = (a[q, q][0] + shift, a[q, q][1])
                zero = (Num(0.0), Num(0.0) if cplx else None)
                a[p, q] = a[q, p] = zero
                for row in v:
                    row[p], row[q] = mix(c, s, pr, pi, row[p], row[q])
    return [a[k, k][0] for k in range(n)], v


def random_matrix(n, cplx, rng):
    a = {}
    for i in range(n):
        a[i, i] = (Num(rng.uniform(-3, 3)), Num(0.0) if cplx else None)
        for j in range(i + 1, n):
            re = Num(rng.uniform(0.5, 1.5))
            im = Num(rng.uniform(0.5, 1.5)) if cplx else None
            a[i, j] = (re, im)
            a[j, i] = (re, -im if cplx else None)
    return a


def count_herm_fid(n, sweeps, rng):
    a = random_matrix(n, True, rng)
    t = Num(rng.uniform(1, 20))
    Tally.ops = 0
    lam, (vin, vout) = jacobi(n, sweeps, a, (0, n - 1), True)
    phr = phi = None
    for k in range(n):
        gr = vout[k][0] * vin[k][0] + vout[k][1] * vin[k][1]
        gi = vout[k][1] * vin[k][0] - vout[k][0] * vin[k][1]
        ang = lam[k] * t
        fr, fi = cos(ang), -sin(ang)
        tr, ti = gr * fr - gi * fi, gr * fi + gi * fr
        phr = tr if phr is None else phr + tr
        phi = ti if phi is None else phi + ti
    _ = phr * phr + phi * phi
    return Tally.ops


def count_sym_amp(n, sweeps, rng):
    a = random_matrix(n, False, rng)
    t = Num(rng.uniform(1, 20))
    Tally.ops = 0
    lam, (vin, vout) = jacobi(n, sweeps, a, (0, n - 1), False)
    phr = phi = None
    for k in range(n):
        w = vin[k][0] * vout[k][0]
        ang = lam[k] * t
        tr, ti = w * cos(ang), w * -sin(ang)
        phr = tr if phr is None else phr + tr
        phi = ti if phi is None else phi + ti
    return Tally.ops


def count_sym_grad(n, sweeps, rng, i=0, o=None):
    o = n - 1 if o is None else o
    a = random_matrix(n, False, rng)
    t = Num(rng.uniform(1, 20))
    Tally.ops = 0
    lam, v = jacobi(n, sweeps, a, range(n), False)
    v = [[x[0] for x in row] for row in v]
    fr = [cos(lam[k] * t) for k in range(n)]
    fi = [-sin(lam[k] * t) for k in range(n)]
    w = [v[o][k] * v[i][k] for k in range(n)]
    phr, phi = w[0] * fr[0], w[0] * fi[0]
    hur, hui = lam[0] * phr, lam[0] * phi
    for k in range(1, n):
        phr = phr + w[k] * fr[k]
        phi = phi + w[k] * fi[k]
        hur = hur + lam[k] * w[k] * fr[k]
        hui = hui + lam[k] * w[k] * fi[k]
    _ = 1.0 - (phr * phr + phi * phi)
    dr, di = [None] * n, [None] * n
    for j in range(n):
        for k in range(j, n):
            x = 0.5 * (lam[j] - lam[k]) * t
            sinc = Num(1.0) if j == k else sin(x) / x
            mid = 0.5 * (lam[j] + lam[k]) * t
            gr = -t * sinc * sin(mid)
            gi = -t * sinc * cos(mid)
            cjk = w[j] if j == k else v[o][j] * v[i][k] + v[o][k] * v[i][j]
            cr, ci = gr * cjk, gi * cjk
            for l in range(n):
                vv = v[l][j] * v[l][k]
                dr[l] = vv * cr if dr[l] is None else dr[l] + vv * cr
                di[l] = vv * ci if di[l] is None else di[l] + vv * ci
    for l in range(n):
        _ = -2.0 * (dr[l] * phr + di[l] * phi)
    _ = -2.0 * (hui * phr - hur * phi)
    return Tally.ops


COUNTERS = {"herm_fid": count_herm_fid, "sym_amp": count_sym_amp,
            "sym_grad": count_sym_grad}


@pytest.mark.parametrize("kind", work.KINDS)
def test_flops_match_hand_count_at_n4(kind):
    rng = random.Random(4)
    assert work.flops_per_element(kind, 4, 1) == COUNTERS[kind](4, 1, rng)
    assert work.flops_per_element(kind, 4, 5) == COUNTERS[kind](4, 5, rng)


@pytest.mark.parametrize("n", [3, 7, 10])
@pytest.mark.parametrize("kind", work.KINDS)
def test_flops_match_hand_count_at_other_sizes(kind, n):
    rng = random.Random(n)
    assert work.flops_per_element(kind, n, 2) == COUNTERS[kind](n, 2, rng)


def test_bytes_at_n4():
    # Hermitian 4x4: 4 real diagonal + 6 complex off-diagonal = 16 reals,
    # the time, the fidelity
    assert work.bytes_per_element("herm_fid", 4) == 4 * (16 + 1 + 1)
    # symmetric 4x4: 10 entries, the time; amplitude (2) or
    # infidelity and 5 gradient entries (6)
    assert work.bytes_per_element("sym_amp", 4) == 4 * (10 + 1 + 2)
    assert work.bytes_per_element("sym_grad", 4) == 4 * (10 + 1 + 6)


def test_least_seconds_names_its_bound():
    peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    t, bound = work.least_seconds("herm_fid", 7, 5, 1e6, peaks)
    assert bound == "compute"
    assert t == pytest.approx(1e6 * work.flops_per_element("herm_fid", 7, 5)
                              / 67e12)
    t, bound = work.least_seconds("herm_fid", 7, 5, 1e6,
                                  {"fp32_flops_per_s": 1e30,
                                   "hbm_bytes_per_s": 1.0})
    assert bound == "memory" and t == 1e6 * 4 * 51


def test_unknown_kind_is_an_error():
    with pytest.raises(ValueError):
        work.flops_per_element("lanes", 7, 5)
