"""Pallas kernels (Triton route): batched Jacobi transfer fidelities.

The XLA lanes formulation (ops/realform.py) expresses each Jacobi
rotation as slice updates on (n, n, B) arrays, and on the GPU every
rotation becomes several small kernels that stream the whole batch
through device memory.  One lattice element's working set is tiny (the
triangle of an n <= 10 Hermitian plus the carried eigenvector rows), so
these kernels give each program a block of ``block`` lattice elements
and keep every matrix entry as one (block,) register vector for the
whole solve: device memory is read once (the assembled Hamiltonian) and
written once (the fidelity, amplitude or gradient).

Layout: inputs are (n*n, B) with matrix entry (i, j) on row i*n + j and
the batch last.  Only the upper triangle is loaded (the lower one is its
mirror); the batch is edge-padded to a multiple of ``block`` by the
wrappers, because Triton block shapes are powers of two.  The rotation
schedule (``pair_schedule``) runs as a loop over one unrolled stage of
disjoint rotations followed by a relabelling of the matrix slots
(``stage_relabel``), which keeps the compiled kernel small.

The kernels use the same arithmetic as the lanes path (symmetric
update, closed-form pivot block, Rutishauser angles) in round-robin
pivot order, and agree with it to the f32 rounding floor
(tests/test_pallas.py, interpret mode).  ``ops.select`` decides where
they run.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp

from code_robchar_tpu.ops.realform import _sweeps_for

#: lattice elements per program: one element per thread, one warp per
#: 32 elements.  Small batches take narrow programs so that more SMs
#: get one.
BLOCK_WIDE = 128
BLOCK_NARROW = 32
#: batches below this many elements take BLOCK_NARROW
WIDE_FROM = 128 * 132

_EPS = 1e-7


def pick_block(b: int) -> tuple[int, int]:
    """(block, padded_b) for a batch of ``b`` lattice elements."""
    block = BLOCK_WIDE if b >= WIDE_FROM else BLOCK_NARROW
    return block, -(-b // block) * block


def pair_schedule(n: int, order: str = "roundrobin"):
    """Sweep schedule as a list of stages of disjoint (p, q) pivots.

    "cyclic": the classical row-major order, one pair per stage.
    "roundrobin": circle-method tournament; every stage's pairs are
    pairwise disjoint and each sweep still covers all n(n-1)/2 pairs
    once.  The kernels use round-robin: a stage's angles are computed
    before its rotations, which is exact because its pivots are
    disjoint, and gives each thread independent instruction streams."""
    if order == "cyclic":
        return [[(p, q)] for p in range(n - 1) for q in range(p + 1, n)]
    if order != "roundrobin":
        raise ValueError(f"unknown rotation order {order!r}")
    players = ([None] if n % 2 else []) + list(range(n))
    m = len(players)
    stages, arr = [], players[:]
    for _ in range(m - 1):
        pairs = []
        for i in range(m // 2):
            a, b = arr[i], arr[m - 1 - i]
            if a is not None and b is not None:
                pairs.append((min(a, b), max(a, b)))
        stages.append(pairs)
        arr = [arr[0], arr[-1]] + arr[1:-1]
    return stages


def stage_relabel(n: int):
    """One round-robin stage in relabelled form: ``(pairs, perm)``.

    The kernels hold the matrix in "slots".  Each stage rotates the fixed
    slot pairs ``pairs`` (disjoint, p < q) and then relabels: new slot j
    takes old slot ``perm[j]`` (a symmetric permutation of A and a column
    permutation of the carried eigenvector rows, which changes neither
    the spectrum nor any fidelity).  Applied n - 1 (n odd: n) times this
    visits exactly the pairs of ``pair_schedule(n)``, stage by stage, and
    returns every slot to its place — so one stage of code, looped,
    replaces the unrolled sweep and keeps the compiled kernel small."""
    odd = n % 2
    m = n + odd                      # players, with a bye for odd n
    pos_perm = [0, m - 1] + list(range(1, m - 1))
    pairs = [(i - odd, m - 1 - i - odd) for i in range(odd, m // 2)]
    perm = [pos_perm[j] - odd for j in range(odd, m)]
    return pairs, perm


class _Tri:
    """Upper triangle of a Hermitian (or, with ``im`` None, real
    symmetric) matrix held as register vectors; entries below the
    diagonal are read and written through their mirror."""

    def __init__(self, n, re, im=None):
        self.n, self.re, self.im = n, re, im

    def get(self, i, j):
        if i <= j:
            return self.re[i, j], (self.im[i, j] if self.im is not None
                                   and i < j else None)
        im = -self.im[j, i] if self.im is not None else None
        return self.re[j, i], im

    def set(self, i, j, re, im=None):
        if i <= j:
            self.re[i, j] = re
            if self.im is not None and i < j:
                self.im[i, j] = im
        else:
            self.re[j, i] = re
            if self.im is not None:
                self.im[j, i] = -im


def _angles(app, aqq, xr, xi):
    """Rotation for pivot value x = xr + i xi (xi None: real)."""
    r = jnp.sqrt(xr * xr + xi * xi) if xi is not None else jnp.abs(xr)
    active = r > _EPS * (jnp.abs(app) + jnp.abs(aqq) + r)
    safe = jnp.where(active, r if xi is not None else xr, 1.0)
    tau = (aqq - app) / (2.0 * safe)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, 1.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(active, c, 1.0)
    s = jnp.where(active, s, 0.0)
    t_eff = jnp.where(active, t, 0.0)
    if xi is None:
        return dict(c=c, s=s, shift=t_eff * xr, active=active)
    return dict(c=c, s=s, shift=t_eff * r, active=active,
                pr=jnp.where(active, xr / safe, 1.0),
                pi=jnp.where(active, xi / safe, 0.0))


def _rotate(a: _Tri, vr, vi, p, q, ang):
    """Similarity rotation at pivot (p, q) (p < q): columns p, q of A
    (rows mirrored through the triangle), closed-form pivot block, and
    the carried eigenvector rows.  ``vi``/``a.im`` None: real case."""
    c, s = ang["c"], ang["s"]
    cplx = a.im is not None

    def mix(xr, xi, yr, yi):
        # (c x - s conj(ph) y, s ph x + c y), ph = pr + i pi
        if not cplx:
            return (c * xr - s * yr, None), (s * xr + c * yr, None)
        pr, pi = ang["pr"], ang["pi"]
        yr_, yi_ = pr * yr + pi * yi, pr * yi - pi * yr
        xr_, xi_ = pr * xr - pi * xi, pr * xi + pi * xr
        return ((c * xr - s * yr_, c * xi - s * yi_),
                (s * xr_ + c * yr, s * xi_ + c * yi))

    for i in range(a.n):
        if i in (p, q):
            continue
        (cpr, cpi), (cqr, cqi) = a.get(i, p), a.get(i, q)
        (npr, npi), (nqr, nqi) = mix(cpr, cpi, cqr, cqi)
        a.set(i, p, npr, npi)
        a.set(i, q, nqr, nqi)
    app, aqq = a.re[p, p], a.re[q, q]
    a.re[p, p] = app - ang["shift"]
    a.re[q, q] = aqq + ang["shift"]
    a.re[p, q] = jnp.where(ang["active"], 0.0, a.re[p, q])
    if cplx:
        a.im[p, q] = jnp.where(ang["active"], 0.0, a.im[p, q])
    for r in range(len(vr)):
        (nvr, nvi), (nwr, nwi) = mix(vr[r][p], vi[r][p] if cplx else None,
                                     vr[r][q], vi[r][q] if cplx else None)
        vr[r][p], vr[r][q] = nvr, nwr
        if cplx:
            vi[r][p], vi[r][q] = nvi, nwi


def _jacobi(n, sweeps, re, im, vr, vi):
    """Run ``sweeps`` sweeps on register vectors: ``re``/``im`` dicts of
    the upper triangle, ``vr``/``vi`` lists of carried eigenvector rows
    (``im``/``vi`` None for a real symmetric matrix).  Returns them
    updated, in slot order (``stage_relabel``): the diagonal holds the
    eigenvalues and the rows hold the matching eigenvector components,
    in an order that no fidelity or gradient depends on."""
    cplx = im is not None
    tri_keys = sorted(re)
    im_keys = sorted(im) if cplx else []
    rows = len(vr)
    pairs, perm = stage_relabel(n)

    def pack(re, im, vr, vi):
        out = [re[k] for k in tri_keys] + [im[k] for k in im_keys]
        out += [x for row in vr for x in row]
        if cplx:
            out += [x for row in vi for x in row]
        return tuple(out)

    def unpack(flat):
        flat = list(flat)
        re = {k: flat.pop(0) for k in tri_keys}
        im = {k: flat.pop(0) for k in im_keys} if cplx else None
        vr = [[flat.pop(0) for _ in range(n)] for _ in range(rows)]
        vi = [[flat.pop(0) for _ in range(n)] for _ in range(rows)] \
            if cplx else None
        return re, im, vr, vi

    def stage(_, flat):
        re, im, vr, vi = unpack(flat)
        a = _Tri(n, re, im)
        # a stage's pivots are disjoint: every angle reads pre-stage
        # values whichever order the rotations then apply in
        angs = [_angles(re[p, p], re[q, q], re[p, q],
                        im[p, q] if cplx else None) for p, q in pairs]
        for (p, q), ang in zip(pairs, angs):
            _rotate(a, vr, vi, p, q, ang)
        new = {k: a.get(perm[k[0]], perm[k[1]]) for k in tri_keys}
        re = {k: v[0] for k, v in new.items()}
        im = {k: new[k][1] for k in im_keys} if cplx else None
        vr = [[row[perm[j]] for j in range(n)] for row in vr]
        if cplx:
            vi = [[row[perm[j]] for j in range(n)] for row in vi]
        return pack(re, im, vr, vi)

    stages = len(pair_schedule(n))
    return unpack(jax.lax.fori_loop(0, sweeps * stages, stage,
                                    pack(re, im, vr, vi)))


def _load_triangle(ref, n, strict=False):
    return {(i, j): ref[i * n + j, :] for i in range(n)
            for j in range(i + (1 if strict else 0), n)}


def _unit_rows(n, rows, like):
    """Carried eigenvector rows of the identity: rows[r] of V."""
    one, zero = jnp.ones_like(like), jnp.zeros_like(like)
    return [[one if k == row else zero for k in range(n)] for row in rows]


def _herm_fid_kernel(n, in_spin, out_spin, sweeps, ar_ref, ai_ref, t_ref,
                     fid_ref):
    re = _load_triangle(ar_ref, n)
    im = _load_triangle(ai_ref, n, strict=True)
    t = t_ref[:]
    vr = _unit_rows(n, (in_spin, out_spin), t)
    vi = [[jnp.zeros_like(t) for _ in range(n)] for _ in range(2)]
    re, im, vr, vi = _jacobi(n, sweeps, re, im, vr, vi)
    # phi = sum_k V[out,k] e^{-i t lam_k} conj(V[in,k])
    phr = phi = None
    for k in range(n):
        gr = vr[1][k] * vr[0][k] + vi[1][k] * vi[0][k]
        gi = vi[1][k] * vr[0][k] - vr[1][k] * vi[0][k]
        ang = re[k, k] * t
        fr, fi = jnp.cos(ang), -jnp.sin(ang)
        tr, ti = gr * fr - gi * fi, gr * fi + gi * fr
        phr = tr if phr is None else phr + tr
        phi = ti if phi is None else phi + ti
    fid_ref[:] = phr * phr + phi * phi


def _sym_amp_kernel(n, in_spin, out_spin, sweeps, a_ref, t_ref, phr_ref,
                    phi_ref):
    t = t_ref[:]
    re, _, vr, _ = _jacobi(n, sweeps, _load_triangle(a_ref, n), None,
                           _unit_rows(n, (in_spin, out_spin), t), None)
    phr = phi = None
    for k in range(n):
        w = vr[0][k] * vr[1][k]
        ang = re[k, k] * t
        tr, ti = w * jnp.cos(ang), -w * jnp.sin(ang)
        phr = tr if phr is None else phr + tr
        phi = ti if phi is None else phi + ti
    phr_ref[:] = phr
    phi_ref[:] = phi


def _sym_grad_kernel(n, in_spin, out_spin, sweeps, a_ref, t_ref, err_ref,
                     grad_ref):
    """Exact (infidelity, gradient) in one solve: the full eigenvector
    matrix rides as n carried rows, then the Daleckii-Krein contraction
    (realform.infidelity_and_gradient_sym_lanes) is accumulated entry by
    entry, using the symmetry of the divided-difference matrix."""
    t = t_ref[:]
    re, _, v, _ = _jacobi(n, sweeps, _load_triangle(a_ref, n), None,
                          _unit_rows(n, range(n), t), None)
    lam = [re[k, k] for k in range(n)]
    v_out, v_in = v[out_spin], v[in_spin]
    fr = [jnp.cos(lam[k] * t) for k in range(n)]
    fi = [-jnp.sin(lam[k] * t) for k in range(n)]
    w = [v_out[k] * v_in[k] for k in range(n)]
    phr, phi = w[0] * fr[0], w[0] * fi[0]
    hur, hui = lam[0] * phr, lam[0] * phi
    for k in range(1, n):
        phr = phr + w[k] * fr[k]
        phi = phi + w[k] * fi[k]
        hur = hur + lam[k] * w[k] * fr[k]
        hui = hui + lam[k] * w[k] * fi[k]
    err_ref[:] = 1.0 - (phr * phr + phi * phi)

    # dphi_l = sum_jk V[l,j] V[l,k] Gamma_jk V[out,j] V[in,k]; Gamma is
    # symmetric, so each unordered (j, k) pair is visited once
    dr = [None] * n
    di = [None] * n
    for j in range(n):
        for k in range(j, n):
            x = 0.5 * (lam[j] - lam[k]) * t
            small = jnp.abs(x) < 1e-3
            xs = jnp.where(small, 1.0, x)
            sinc = jnp.where(small, 1.0 - x * x * (1.0 / 6.0),
                             jnp.sin(xs) / xs)
            mid = 0.5 * (lam[j] + lam[k]) * t
            gr = -t * sinc * jnp.sin(mid)
            gi = -t * sinc * jnp.cos(mid)
            cjk = w[j] if j == k else \
                v_out[j] * v_in[k] + v_out[k] * v_in[j]
            cr, ci = gr * cjk, gi * cjk
            for l in range(n):
                vv = v[l][j] * v[l][k]
                dr[l] = vv * cr if dr[l] is None else dr[l] + vv * cr
                di[l] = vv * ci if di[l] is None else di[l] + vv * ci
    for l in range(n):
        grad_ref[l, :] = -2.0 * (dr[l] * phr + di[l] * phi)
    grad_ref[n, :] = -2.0 * (hui * phr - hur * phi)


@lru_cache(maxsize=64)
def _build(kind: str, n: int, in_spin: int, out_spin: int, sweeps: int,
           block: int, interpret: bool):
    """jitted (inputs...) -> outputs for one kernel configuration."""
    from functools import partial

    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pltriton

    nn = n * n
    mat = pl.BlockSpec((nn, block), lambda i: (0, i))
    vec = pl.BlockSpec((block,), lambda i: (i,))
    body, n_mats = {"herm_fid": (_herm_fid_kernel, 2),
                    "sym_amp": (_sym_amp_kernel, 1),
                    "sym_grad": (_sym_grad_kernel, 1)}[kind]
    kernel = partial(body, n, in_spin, out_spin, sweeps)

    @jax.jit
    def run(*args):
        b = args[-1].shape[0]
        dt = args[-1].dtype
        if kind == "sym_grad":
            out_specs = [vec, pl.BlockSpec((n + 1, block),
                                           lambda i: (0, i))]
            out_shape = [jax.ShapeDtypeStruct((b,), dt),
                         jax.ShapeDtypeStruct((n + 1, b), dt)]
        else:
            n_out = 1 if kind == "herm_fid" else 2
            out_specs = [vec] * n_out
            out_shape = [jax.ShapeDtypeStruct((b,), dt)] * n_out
        return pl.pallas_call(
            kernel,
            grid=(b // block,),
            in_specs=[mat] * n_mats + [vec],
            out_specs=out_specs,
            out_shape=out_shape,
            compiler_params=pltriton.CompilerParams(
                num_warps=block // 32, num_stages=1),
            interpret=interpret,
            name=f"jacobi_{kind}_n{n}",
        )(*args)

    return run


def _call(kind, mats, t, n, in_spin, out_spin, sweeps, block, interpret):
    """Pad the batch (last axis) to a multiple of the block with copies
    of its last element, run, and slice the padding off."""
    b = t.shape[0]
    if block is None:
        block, bp = pick_block(b)
    else:
        bp = -(-b // block) * block
    if bp != b:
        mats = [jnp.concatenate(
            [m, jnp.broadcast_to(m[:, -1:], (m.shape[0], bp - b))], axis=1)
            for m in mats]
        t = jnp.concatenate([t, jnp.broadcast_to(t[-1:], (bp - b,))])
    if sweeps is None:
        sweeps = _sweeps_for(t.dtype, n)
    out = _build(kind, n, in_spin, out_spin, sweeps, block,
                 interpret)(*mats, t)
    return [o[..., :b] for o in out]


def fidelity_herm_pallas(ar, ai, t, in_spin: int, out_spin: int,
                         sweeps: int | None = None, block: int | None = None,
                         interpret: bool = False):
    """|<out| exp(-i t (ar + i ai)) |in>|^2: ar/ai (n, n, B) split
    Hermitians (lanes layout), t (B,) -> (B,)."""
    n, b = ar.shape[0], ar.shape[-1]
    (fid,) = _call("herm_fid", [ar.reshape(n * n, b), ai.reshape(n * n, b)],
                   t, n, in_spin, out_spin, sweeps, block, interpret)
    return fid


def transfer_amp_sym_pallas(a, t, in_spin: int, out_spin: int,
                            sweeps: int | None = None,
                            block: int | None = None,
                            interpret: bool = False):
    """Transfer amplitude (phr, phi) of real symmetric a (n, n, B)."""
    n, b = a.shape[0], a.shape[-1]
    phr, phi = _call("sym_amp", [a.reshape(n * n, b)], t, n, in_spin,
                     out_spin, sweeps, block, interpret)
    return phr, phi


def fidelity_sym_pallas(a, t, in_spin: int, out_spin: int,
                        sweeps: int | None = None, block: int | None = None,
                        interpret: bool = False):
    phr, phi = transfer_amp_sym_pallas(a, t, in_spin, out_spin, sweeps,
                                       block, interpret)
    return phr * phr + phi * phi


def infidelity_and_gradient_sym_pallas(h0, xs, in_spin: int, out_spin: int,
                                       sweeps: int | None = None,
                                       block: int | None = None,
                                       interpret: bool = False):
    """Batched exact (infidelity, gradient): h0 (n, n), xs (B, n+1) ->
    (err (B,), grad (B, n+1)); H = h0 + diag(x[:n]), T = |x[n]|."""
    n, b = h0.shape[-1], xs.shape[0]
    dt = h0.dtype
    a = jnp.broadcast_to(h0[:, :, None], (n, n, b)).astype(dt)
    for i in range(n):
        a = a.at[i, i].add(xs[:, i].astype(dt))
    t = jnp.abs(xs[:, n]).astype(dt)
    err, grad = _call("sym_grad", [a.reshape(n * n, b)], t, n, in_spin,
                      out_spin, sweeps, block, interpret)
    return err, grad.T
