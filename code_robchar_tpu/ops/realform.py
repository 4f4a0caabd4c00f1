"""Split real/imaginary formulations of the hot kernels.

No complex dtype rides the hot path (XLA and the Pallas kernels work on
(re, im) pairs regardless), so every production kernel here is written in
pure REAL arithmetic:

- the *training* path (optimizer objectives, RL env): Hamiltonians are
  genuinely real symmetric — the XX drift is real and the training-side
  structured perturbation has real couplings (qnewton.py:366-379,
  RLreinforce...:122-133).  ``jacobi_eigh_sym`` + ``fidelity_sym`` +
  ``infidelity_and_gradient_sym`` run on n x n real matrices.
- the *characterisation* path (MC engine): noise_model.py:139-146 makes
  couplings complex, so ``jacobi_eigh_herm`` runs the complex-Hermitian
  Jacobi with the matrix split as (ar, ai), ar symmetric / ai
  antisymmetric, and ``fidelity_herm`` expands the transfer amplitude in
  parts.

Numerical contract: at float64 these agree with the complex
implementations in ops/propagate.py to <=1e-10 (tests/test_realform.py);
at float32 on the GPU they are the throughput regime.

The propagator itself is never materialised: for a transfer fidelity only
the (out, in) amplitude phi = sum_k V[out,k] e^{-i T l_k} conj(V[in,k]) is
contracted, and e^{-i T l} is carried as (cos(T l), -sin(T l)).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

def _sinc(x):
    """sin(x)/x, stable through x = 0 (series below 1e-3: relative error
    <= x^4/120 ~ 8e-15, under the 1e-10 parity bar at f64 and the
    rounding floor at f32)."""
    small = jnp.abs(x) < 1e-3
    xs = jnp.where(small, jnp.ones((), x.dtype), x)
    return jnp.where(small, 1.0 - x * x * (1.0 / 6.0), jnp.sin(xs) / xs)


def _sweeps_for(dtype, n) -> int:
    # Cyclic Jacobi is quadratically convergent: at f32 five sweeps reach
    # the rounding floor on every workload class measured (bench-like,
    # near-zero bias, exact ring degeneracies) for every n <= 10,
    # including n = 9/10 — one margin sweep is kept there since they are
    # off the measured paper envelope.  f64 keeps the conservative
    # schedule (its floor is 8 orders deeper).
    bits = jnp.finfo(dtype).bits
    if bits <= 32:
        return 5 + (1 if n > 8 else 0)
    return 9 + (2 if n > 8 else 0)


def _eps_for(dtype) -> float:
    return 1e-7 if jnp.finfo(dtype).bits <= 32 else 1e-15


# --------------------------------------------------------------------------
# real symmetric Jacobi
# --------------------------------------------------------------------------

def _sym_rotate(a, v, p, q, eps):
    """Symmetric update (same algebra as _sym_rotate_lanes): rotate the
    column pair, mirror into rows p, q, closed-form 2x2 pivot block."""
    app, aqq, apq = a[..., p, p], a[..., q, q], a[..., p, q]
    r = jnp.abs(apq)
    active = r > eps * (jnp.abs(app) + jnp.abs(aqq) + r)
    safe = jnp.where(active, apq, 1.0)
    tau = (aqq - app) / (2.0 * safe)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, 1.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(active, c, 1.0)[..., None]
    s = jnp.where(active, s, 0.0)[..., None]
    t_eff = jnp.where(active, t, 0.0)

    cp, cq = a[..., :, p], a[..., :, q]
    ncp = c * cp - s * cq
    ncq = s * cp + c * cq
    a = a.at[..., :, p].set(ncp)
    a = a.at[..., :, q].set(ncq)
    npp = app - t_eff * apq
    nqq = aqq + t_eff * apq
    z = jnp.where(active, 0.0, apq)
    row_p = ncp.at[..., p].set(npp).at[..., q].set(z)
    row_q = ncq.at[..., p].set(z).at[..., q].set(nqq)
    a = a.at[..., p, :].set(row_p)
    a = a.at[..., q, :].set(row_q)
    vp, vq = v[..., :, p], v[..., :, q]
    v = v.at[..., :, p].set(c * vp - s * vq)
    v = v.at[..., :, q].set(s * vp + c * vq)
    return a, v


@partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh_sym(a: jnp.ndarray, sweeps: int | None = None
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Batched eigendecomposition of REAL symmetric (..., n, n)."""
    n = a.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(a.dtype, n)
    eps = _eps_for(a.dtype)
    v = jnp.zeros_like(a) + jnp.eye(n, dtype=a.dtype)

    def sweep(_, carry):
        a, v = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                a, v = _sym_rotate(a, v, p, q, eps)
        return a, v

    a, v = jax.lax.fori_loop(0, sweeps, sweep, (a, v))
    lam = jnp.diagonal(a, axis1=-2, axis2=-1)
    order = jnp.argsort(lam, axis=-1)
    return (jnp.take_along_axis(lam, order, axis=-1),
            jnp.take_along_axis(v, order[..., None, :], axis=-1))


# --------------------------------------------------------------------------
# split-complex Hermitian Jacobi: A = ar + i ai, ar sym, ai antisym
# --------------------------------------------------------------------------

def _herm_rotate(ar, ai, vr, vi, p, q, eps):
    app = ar[..., p, p]
    aqq = ar[..., q, q]
    xr = ar[..., p, q]
    xi = ai[..., p, q]
    r = jnp.sqrt(xr * xr + xi * xi)
    active = r > eps * (jnp.abs(app) + jnp.abs(aqq) + r)
    safe_r = jnp.where(active, r, 1.0)
    pr = jnp.where(active, xr / safe_r, 1.0)   # phase = apq / |apq|
    pi = jnp.where(active, xi / safe_r, 0.0)
    tau = (aqq - app) / (2.0 * safe_r)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, 1.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(active, c, 1.0)[..., None]
    s = jnp.where(active, s, 0.0)[..., None]
    pr = pr[..., None]
    pi = pi[..., None]

    def cmul(xr_, xi_, yr_, yi_):
        return xr_ * yr_ - xi_ * yi_, xr_ * yi_ + xi_ * yr_

    # columns: (AJ)[:,p] = c A[:,p] - s conj(ph) A[:,q]
    #          (AJ)[:,q] = s ph A[:,p] + c A[:,q]
    cpr, cpi = ar[..., :, p], ai[..., :, p]
    cqr, cqi = ar[..., :, q], ai[..., :, q]
    tr, ti = cmul(pr, -pi, cqr, cqi)
    npr_, npi_ = c * cpr - s * tr, c * cpi - s * ti
    tr, ti = cmul(pr, pi, cpr, cpi)
    nqr_, nqi_ = s * tr + c * cqr, s * ti + c * cqi
    ar = ar.at[..., :, p].set(npr_).at[..., :, q].set(nqr_)
    ai = ai.at[..., :, p].set(npi_).at[..., :, q].set(nqi_)

    # rows p, q by Hermitian symmetry + closed-form pivot block (same
    # algebra as _herm_rotate_lanes)
    t_eff = jnp.where(active, t, 0.0)
    npp = app - t_eff * r
    nqq = aqq + t_eff * r
    zr = jnp.where(active, 0.0, xr)
    zi = jnp.where(active, 0.0, xi)
    zero = jnp.zeros_like(npp)
    row_p_r = npr_.at[..., p].set(npp).at[..., q].set(zr)
    row_p_i = (-npi_).at[..., p].set(zero).at[..., q].set(zi)
    row_q_r = nqr_.at[..., p].set(zr).at[..., q].set(nqq)
    row_q_i = (-nqi_).at[..., p].set(-zi).at[..., q].set(zero)
    ar = ar.at[..., p, :].set(row_p_r).at[..., q, :].set(row_q_r)
    ai = ai.at[..., p, :].set(row_p_i).at[..., q, :].set(row_q_i)

    # V <- V J (column ops)
    wpr, wpi = vr[..., :, p], vi[..., :, p]
    wqr, wqi = vr[..., :, q], vi[..., :, q]
    tr, ti = cmul(pr, -pi, wqr, wqi)
    nvp_r, nvp_i = c * wpr - s * tr, c * wpi - s * ti
    tr, ti = cmul(pr, pi, wpr, wpi)
    nvq_r, nvq_i = s * tr + c * wqr, s * ti + c * wqi
    vr = vr.at[..., :, p].set(nvp_r).at[..., :, q].set(nvq_r)
    vi = vi.at[..., :, p].set(nvp_i).at[..., :, q].set(nvq_i)
    return ar, ai, vr, vi


@partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh_herm(ar: jnp.ndarray, ai: jnp.ndarray,
                     sweeps: int | None = None):
    """Batched eigendecomposition of Hermitian A = ar + i ai given as
    split parts.  Returns (lam, vr, vi) with eigenvalues ascending."""
    n = ar.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(ar.dtype, n)
    eps = _eps_for(ar.dtype)
    vr = jnp.zeros_like(ar) + jnp.eye(n, dtype=ar.dtype)
    vi = jnp.zeros_like(ar)

    def sweep(_, carry):
        ar, ai, vr, vi = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                ar, ai, vr, vi = _herm_rotate(ar, ai, vr, vi, p, q, eps)
        return ar, ai, vr, vi

    ar, ai, vr, vi = jax.lax.fori_loop(0, sweeps, sweep, (ar, ai, vr, vi))
    lam = jnp.diagonal(ar, axis1=-2, axis2=-1)
    order = jnp.argsort(lam, axis=-1)
    take = lambda m: jnp.take_along_axis(m, order[..., None, :], axis=-1)
    return (jnp.take_along_axis(lam, order, axis=-1), take(vr), take(vi))


# --------------------------------------------------------------------------
# rows-only eigensolvers (throughput path)
#
# A transfer fidelity only consumes rows `in_spin` and `out_spin` of the
# eigenvector matrix, and the eigen-sums are order-independent.  Jacobi
# accumulates V by COLUMN rotations, under which every row evolves
# independently — so the throughput kernels carry a (2, n) row block
# instead of the (n, n) matrix and skip the final sort entirely.
# --------------------------------------------------------------------------

def _sym_eigh_rows(a: jnp.ndarray, rows, sweeps: int | None = None):
    """(lam_unsorted, vrows) with vrows[..., r, :] = V[rows[r], :]."""
    n = a.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(a.dtype, n)
    eps = _eps_for(a.dtype)
    sel = jnp.zeros(a.shape[:-2] + (len(rows), n), a.dtype)
    for r, row in enumerate(rows):
        sel = sel.at[..., r, row].set(1.0)
    sel = sel + 0.0 * a[..., :1, :]   # inherit device-varying axes

    def sweep(_, carry):
        a, v = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                a, v = _sym_rotate(a, v, p, q, eps)
        return a, v

    a, v = jax.lax.fori_loop(0, sweeps, sweep, (a, sel))
    return jnp.diagonal(a, axis1=-2, axis2=-1), v


def _herm_eigh_rows(ar, ai, rows, sweeps: int | None = None):
    """(lam_unsorted, vr_rows, vi_rows) for A = ar + i ai."""
    n = ar.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(ar.dtype, n)
    eps = _eps_for(ar.dtype)
    sel = jnp.zeros(ar.shape[:-2] + (len(rows), n), ar.dtype)
    for r, row in enumerate(rows):
        sel = sel.at[..., r, row].set(1.0)
    vr = sel + 0.0 * ar[..., :1, :]
    vi = jnp.zeros_like(vr)

    def sweep(_, carry):
        ar, ai, vr, vi = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                ar, ai, vr, vi = _herm_rotate(ar, ai, vr, vi, p, q, eps)
        return ar, ai, vr, vi

    ar, ai, vr, vi = jax.lax.fori_loop(0, sweeps, sweep, (ar, ai, vr, vi))
    return jnp.diagonal(ar, axis1=-2, axis2=-1), vr, vi


# --------------------------------------------------------------------------
# fidelities
# --------------------------------------------------------------------------

def _phase_parts(lam, t):
    ang = lam * t[..., None]
    return jnp.cos(ang), -jnp.sin(ang)       # e^{-i t lam}


def fidelity_sym(h: jnp.ndarray, t: jnp.ndarray, in_spin: int,
                 out_spin: int, eigh_sym=None) -> jnp.ndarray:
    """|<out| exp(-i t H) |in>|^2 for REAL symmetric H (..., n, n)."""
    if eigh_sym is not None:
        lam, v = eigh_sym(h)
        v_out, v_in = v[..., out_spin, :], v[..., in_spin, :]
    else:
        lam, vrows = _sym_eigh_rows(h, (in_spin, out_spin))
        v_in, v_out = vrows[..., 0, :], vrows[..., 1, :]
    w = v_out * v_in
    cr, ci = _phase_parts(lam, jnp.asarray(t, lam.dtype))
    phr = jnp.sum(w * cr, axis=-1)
    phi = jnp.sum(w * ci, axis=-1)
    return phr * phr + phi * phi


def fidelity_herm(ar: jnp.ndarray, ai: jnp.ndarray, t: jnp.ndarray,
                  in_spin: int, out_spin: int,
                  eigh_herm=None) -> jnp.ndarray:
    """|<out| exp(-i t (ar + i ai)) |in>|^2 in split arithmetic.

    phi = sum_k a_k * f_k * conj(b_k) with a = V[out,:], b = V[in,:],
    f = e^{-i t lam}; fully expanded into real products.
    """
    if eigh_herm is not None:
        lam, vr, vi = eigh_herm(ar, ai)
        aor, aoi = vr[..., out_spin, :], vi[..., out_spin, :]
        bir, bii = vr[..., in_spin, :], vi[..., in_spin, :]
    else:
        lam, vrr, vir = _herm_eigh_rows(ar, ai, (in_spin, out_spin))
        bir, bii = vrr[..., 0, :], vir[..., 0, :]
        aor, aoi = vrr[..., 1, :], vir[..., 1, :]
    # g = a * conj(b)
    gr = aor * bir + aoi * bii
    gi = aoi * bir - aor * bii
    fr, fi = _phase_parts(lam, jnp.asarray(t, lam.dtype))
    phr = jnp.sum(gr * fr - gi * fi, axis=-1)
    phi = jnp.sum(gr * fi + gi * fr, axis=-1)
    return phr * phr + phi * phi


def fidelity_from_controller_sym(h0: jnp.ndarray, x: jnp.ndarray,
                                 in_spin: int, out_spin: int,
                                 eigh_sym=None) -> jnp.ndarray:
    """Reference objective contract (T = |x[n]|, H = H0 + diag(x[:n]))
    on the real-symmetric path."""
    n = h0.shape[-1]
    h = h0 + jnp.eye(n, dtype=h0.dtype) * x[..., None, :n]
    return fidelity_sym(h, jnp.abs(x[..., n]), in_spin, out_spin, eigh_sym)


# --------------------------------------------------------------------------
# exact gradient, real-symmetric path (optimizer training objective)
# --------------------------------------------------------------------------

def _gamma_parts(lam, t):
    """Split Daleckii-Krein matrix for f(l) = e^{-i t l}.

    Computed through the EXACT product identity

      (e^{-i t a} - e^{-i t b}) / (a - b)
        = -i t e^{-i t (a+b)/2} sinc(t (a-b) / 2)

    rather than the raw divided difference.  The raw form loses
    ~eps/|a-b| relative accuracy to cancellation as eigenvalues
    approach (1.5e-2 absolute gradient error observed at f32 on
    near-degenerate ring spectra, VERDICT r4 weak #2), and amplifies
    within-cluster eigenvector rotation error by the same factor.  The
    sinc form has no cancellation at ANY gap, needs no degeneracy
    threshold, and as sinc -> 1 the within-cluster contribution
    collapses to the cluster projectors, which are rotation-invariant —
    so near-degenerate gradients are accurate to O(eps) instead of
    O(eps/gap) (tests/test_realform.py ring-degeneracy suite)."""
    tc = jnp.asarray(t, lam.dtype)
    dl = lam[..., :, None] - lam[..., None, :]
    mid = 0.5 * (lam[..., :, None] + lam[..., None, :])
    ang = mid * tc[..., None, None]
    s = _sinc(0.5 * dl * tc[..., None, None])
    # -i t e^{-i t mid} = -t sin(ang) - i t cos(ang)
    return (-tc[..., None, None] * s * jnp.sin(ang),
            -tc[..., None, None] * s * jnp.cos(ang))


def infidelity_and_gradient_sym(h0: jnp.ndarray, x: jnp.ndarray,
                                in_spin: int, out_spin: int,
                                eigh_sym=jacobi_eigh_sym):
    """Exact (infidelity, gradient) for the real-symmetric training path;
    value-parity with ops/propagate.infidelity_and_gradient at <=1e-10
    (tests/test_realform.py)."""
    n = h0.shape[-1]
    biases = x[..., :n]
    t = jnp.abs(x[..., n])
    h = h0 + jnp.eye(n, dtype=h0.dtype) * biases[..., None, :]
    lam, v = eigh_sym(h)
    tc = jnp.asarray(t, lam.dtype)

    v_out = v[..., out_spin, :]
    v_in = v[..., in_spin, :]
    w = v_out * v_in
    fr, fi = _phase_parts(lam, tc)
    phr = jnp.sum(w * fr, axis=-1)
    phi = jnp.sum(w * fi, axis=-1)
    err = 1.0 - (phr * phr + phi * phi)

    gr, gi = _gamma_parts(lam, t)
    # A[l, j] = V[out, j] V[l, j];  B[l, k] = V[l, k] V[in, k]  (all real)
    a = v_out[..., None, :] * v
    b = v * v_in[..., None, :]
    # precision pin: a default-precision f32 einsum may run in reduced
    # precision (TF32 on the GPU, ~3 decimal digits), far above the f32
    # gradient floor; HIGHEST keeps it.  These contractions are n<=10
    # wide, so the matrix units buy nothing here.
    dphr = jnp.einsum("...lj,...jk,...lk->...l", a, gr, b,
                      precision=jax.lax.Precision.HIGHEST)
    dphi = jnp.einsum("...lj,...jk,...lk->...l", a, gi, b,
                      precision=jax.lax.Precision.HIGHEST)
    # d err/dx_l = -2 Re(dphi * conj(phi))
    grad_bias = -2.0 * (dphr * phr[..., None] + dphi * phi[..., None])

    # (H U)[out,in] = sum_k lam_k w_k f_k ;  d err/dT = -2 Im(HU conj(phi))
    hur = jnp.sum(lam * w * fr, axis=-1)
    hui = jnp.sum(lam * w * fi, axis=-1)
    grad_t = -2.0 * (hui * phr - hur * phi)

    return err, jnp.concatenate([grad_bias, grad_t[..., None]], axis=-1)


def split_hermitian(h: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Host/interop helper: complex Hermitian -> (real, imag) parts."""
    return jnp.real(h), jnp.imag(h)


# --------------------------------------------------------------------------
# batch-in-lanes ("lanes") formulation
#
# The (B, n, n) layout leaves vector units idle: the minor dimension holds
# only n<=10 elements.  The lanes formulation stores the batch LAST —
# arrays are (n, n, B) with every rotation touching (n, B) or (B,) tiles
# whose minor dimension is the full batch.  This is the MC engine's layout
# on the CPU and the input layout of the Pallas kernels.
# --------------------------------------------------------------------------

def _herm_rotate_lanes(ar, ai, vr, vi, p, q, eps):
    """One (p, q) pivot in lanes layout: ar/ai (n, n, B), vr/vi (R, n, B).

    Exploits Hermitian symmetry: only the column halves (A J) are rotated;
    rows p, q are their conjugate mirrors (A'[p, i] = conj(A'[i, p]), a
    slice copy instead of a second pair of complex rotations), and the
    2x2 pivot block is written in closed form — the rotation is
    constructed to zero A[p, q] exactly, with A'[p,p] = app - t|apq| and
    A'[q,q] = aqq + t|apq| (Rutishauser).  Mathematically identical to
    the classic two-sided update at ~2/3 the arithmetic; it also keeps
    the imaginary diagonal exactly zero instead of accumulating rounding
    drift."""
    app = ar[p, p]
    aqq = ar[q, q]
    xr = ar[p, q]
    xi = ai[p, q]
    r = jnp.sqrt(xr * xr + xi * xi)
    active = r > eps * (jnp.abs(app) + jnp.abs(aqq) + r)
    safe_r = jnp.where(active, r, 1.0)
    pr = jnp.where(active, xr / safe_r, 1.0)
    pi = jnp.where(active, xi / safe_r, 0.0)
    tau = (aqq - app) / (2.0 * safe_r)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, 1.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(active, c, 1.0)
    s = jnp.where(active, s, 0.0)
    t_eff = jnp.where(active, t, 0.0)

    def cmul(xr_, xi_, yr_, yi_):
        return xr_ * yr_ - xi_ * yi_, xr_ * yi_ + xi_ * yr_

    # columns (A J): slices (n, B)
    cpr, cpi = ar[:, p], ai[:, p]
    cqr, cqi = ar[:, q], ai[:, q]
    tr, ti = cmul(pr, -pi, cqr, cqi)
    npr_, npi_ = c * cpr - s * tr, c * cpi - s * ti
    tr, ti = cmul(pr, pi, cpr, cpi)
    nqr_, nqi_ = s * tr + c * cqr, s * ti + c * cqi
    ar = ar.at[:, p].set(npr_).at[:, q].set(nqr_)
    ai = ai.at[:, p].set(npi_).at[:, q].set(nqi_)

    # rows p, q by symmetry + closed-form pivot block
    npp = app - t_eff * r
    nqq = aqq + t_eff * r
    zr = jnp.where(active, 0.0, xr)
    zi = jnp.where(active, 0.0, xi)
    zero = jnp.zeros_like(npp)
    row_p_r = npr_.at[p].set(npp).at[q].set(zr)
    row_p_i = (-npi_).at[p].set(zero).at[q].set(zi)
    row_q_r = nqr_.at[p].set(zr).at[q].set(nqq)
    row_q_i = (-nqi_).at[p].set(-zi).at[q].set(zero)
    ar = ar.at[p].set(row_p_r).at[q].set(row_q_r)
    ai = ai.at[p].set(row_p_i).at[q].set(row_q_i)

    # V <- V J on the carried row block: slices (R, B)
    wpr, wpi = vr[:, p], vi[:, p]
    wqr, wqi = vr[:, q], vi[:, q]
    tr, ti = cmul(pr, -pi, wqr, wqi)
    nvp_r, nvp_i = c * wpr - s * tr, c * wpi - s * ti
    tr, ti = cmul(pr, pi, wpr, wpi)
    nvq_r, nvq_i = s * tr + c * wqr, s * ti + c * wqi
    vr = vr.at[:, p].set(nvp_r).at[:, q].set(nvq_r)
    vi = vi.at[:, p].set(nvp_i).at[:, q].set(nvq_i)
    return ar, ai, vr, vi


def _sym_rotate_lanes(a, v, p, q, eps):
    """One (p, q) pivot for REAL symmetric lanes layout: a (n, n, B),
    v (R, n, B) carried eigenvector rows.

    Symmetric update: rotate the column pair, mirror it into rows p, q
    (A'[p, i] = A'[i, p]), and write the 2x2 pivot block in closed form
    (A'[p, q] = 0, A'[p, p] = app - t*apq, A'[q, q] = aqq + t*apq) —
    identical mathematics to the two-sided rotation at ~2/3 the work."""
    app, aqq, apq = a[p, p], a[q, q], a[p, q]
    r = jnp.abs(apq)
    active = r > eps * (jnp.abs(app) + jnp.abs(aqq) + r)
    safe = jnp.where(active, apq, 1.0)
    tau = (aqq - app) / (2.0 * safe)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(tau == 0.0, 1.0, t)
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(active, c, 1.0)
    s = jnp.where(active, s, 0.0)
    t_eff = jnp.where(active, t, 0.0)

    cp, cq = a[:, p], a[:, q]                     # columns: (n, B)
    ncp = c * cp - s * cq
    ncq = s * cp + c * cq
    a = a.at[:, p].set(ncp).at[:, q].set(ncq)
    npp = app - t_eff * apq
    nqq = aqq + t_eff * apq
    z = jnp.where(active, 0.0, apq)
    row_p = ncp.at[p].set(npp).at[q].set(z)
    row_q = ncq.at[p].set(z).at[q].set(nqq)
    a = a.at[p].set(row_p).at[q].set(row_q)
    wp, wq = v[:, p], v[:, q]                     # V rows: (R, B)
    v = v.at[:, p].set(c * wp - s * wq).at[:, q].set(s * wp + c * wq)
    return a, v


def transfer_amp_sym_lanes(a: jnp.ndarray, t: jnp.ndarray, in_spin: int,
                           out_spin: int, sweeps: int | None = None
                           ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Split transfer amplitude <out| exp(-i t A) |in> for REAL symmetric
    A in LANES layout: a (n, n, B), t (B,) -> (phr, phi) each (B,).

    The real-symmetric rotation does ~1/3 the arithmetic of the Hermitian
    one — this is the RL-environment hot kernel (the training-side physics
    never leaves the reals, RLreinforce...:122-133)."""
    n = a.shape[0]
    b = a.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(a.dtype, n)
    eps = _eps_for(a.dtype)

    v = jnp.zeros((2, n, b), a.dtype)
    v = v.at[0, in_spin].set(1.0).at[1, out_spin].set(1.0)
    v = v + 0.0 * a[:1, :1]

    def sweep(_, carry):
        a, v = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                a, v = _sym_rotate_lanes(a, v, p, q, eps)
        return a, v

    a, v = jax.lax.fori_loop(0, sweeps, sweep, (a, v))

    lam = jnp.stack([a[i, i] for i in range(n)])    # (n, B), unsorted
    w = v[1] * v[0]                                 # V[out,:] * V[in,:]
    ang = lam * t[None, :]
    phr = jnp.sum(w * jnp.cos(ang), axis=0)
    phi = jnp.sum(w * -jnp.sin(ang), axis=0)
    return phr, phi


def fidelity_sym_lanes(a: jnp.ndarray, t: jnp.ndarray, in_spin: int,
                       out_spin: int, sweeps: int | None = None
                       ) -> jnp.ndarray:
    """Batched |<out| exp(-i t A) |in>|^2, REAL symmetric lanes layout:
    a (n, n, B), t (B,) -> (B,)."""
    phr, phi = transfer_amp_sym_lanes(a, t, in_spin, out_spin, sweeps)
    return phr * phr + phi * phi


def jacobi_eigh_sym_lanes(a: jnp.ndarray, sweeps: int | None = None
                          ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full eigendecomposition in lanes layout: a (n, n, B) real symmetric
    -> (lam (n, B) UNSORTED, v (n, n, B)) with v[r, k] = V[r, k] (the
    r-th component of eigenvector k), A = V diag(lam) V^T.

    The full eigenvector matrix rides as n carried rows — needed by the
    exact-gradient kernel (every row enters the Daleckii-Krein
    contraction), unlike the fidelity kernels which carry only two."""
    n = a.shape[0]
    b = a.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(a.dtype, n)
    eps = _eps_for(a.dtype)

    v = jnp.zeros((n, n, b), a.dtype)
    for i in range(n):
        v = v.at[i, i].set(1.0)
    v = v + 0.0 * a[:1, :1]

    def sweep(_, carry):
        a, v = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                a, v = _sym_rotate_lanes(a, v, p, q, eps)
        return a, v

    a, v = jax.lax.fori_loop(0, sweeps, sweep, (a, v))
    lam = jnp.stack([a[i, i] for i in range(n)])
    return lam, v


def infidelity_and_gradient_sym_lanes(h0: jnp.ndarray, xs: jnp.ndarray,
                                      in_spin: int, out_spin: int,
                                      sweeps: int | None = None):
    """Batched exact (infidelity, gradient) in lanes layout.

    h0 (n, n) real-symmetric drift, xs (B, n+1) controllers ->
    (err (B,), grad (B, n+1)).  Same Daleckii-Krein formulation as
    ``infidelity_and_gradient_sym`` (value parity <=1e-10 at f64,
    tests/test_realform.py) but the whole batch rides the lane dimension
    through ONE Jacobi chain — the optimizer-zoo hot path."""
    n = h0.shape[-1]
    b = xs.shape[0]
    dt = h0.dtype
    biases = xs[:, :n].astype(dt)
    t = jnp.abs(xs[:, n]).astype(dt)                     # (B,)

    a = jnp.broadcast_to(h0[:, :, None], (n, n, b)).astype(dt)
    for i in range(n):
        a = a.at[i, i].add(biases[:, i])
    lam, v = jacobi_eigh_sym_lanes(a, sweeps)            # (n,B), (n,n,B)

    v_out = v[out_spin]                                  # (n, B)
    v_in = v[in_spin]
    w = v_out * v_in
    ang = lam * t[None, :]
    fr, fi = jnp.cos(ang), -jnp.sin(ang)                 # (n, B)
    phr = jnp.sum(w * fr, axis=0)
    phi = jnp.sum(w * fi, axis=0)
    err = 1.0 - (phr * phr + phi * phi)

    # split Daleckii-Krein matrix, lanes layout: (n, n, B), via the
    # cancellation-free sinc identity (see _gamma_parts): accurate at
    # every eigenvalue gap incl. the ring topology's exact degeneracies
    dl = lam[:, None, :] - lam[None, :, :]
    mid = 0.5 * (lam[:, None, :] + lam[None, :, :])
    mang = mid * t[None, None, :]
    s = _sinc(0.5 * dl * t[None, None, :])
    gr = -t[None, None, :] * s * jnp.sin(mang)
    gi = -t[None, None, :] * s * jnp.cos(mang)

    # A[l,j] = V[out,j] V[l,j]; B[l,k] = V[l,k] V[in,k]; contraction over
    # (j, k) with the batch in the last axis
    a_lj = v_out[None, :, :] * v                         # (l, j, B)
    b_lk = v * v_in[None, :, :]                          # (l, k, B)
    # precision pin: see infidelity_and_gradient_sym
    dphr = jnp.einsum("ljb,jkb,lkb->lb", a_lj, gr, b_lk,
                      precision=jax.lax.Precision.HIGHEST)
    dphi = jnp.einsum("ljb,jkb,lkb->lb", a_lj, gi, b_lk,
                      precision=jax.lax.Precision.HIGHEST)
    grad_bias = -2.0 * (dphr * phr[None, :] + dphi * phi[None, :])

    hur = jnp.sum(lam * w * fr, axis=0)
    hui = jnp.sum(lam * w * fi, axis=0)
    grad_t = -2.0 * (hui * phr - hur * phi)

    grad = jnp.concatenate([grad_bias.T, grad_t[:, None]], axis=1)
    return err, grad


def fidelity_herm_lanes(ar: jnp.ndarray, ai: jnp.ndarray, t: jnp.ndarray,
                        in_spin: int, out_spin: int,
                        sweeps: int | None = None) -> jnp.ndarray:
    """Batched |<out| exp(-i t A) |in>|^2 with A = ar + i ai in LANES
    layout: ar/ai (n, n, B), t (B,); returns (B,)."""
    n = ar.shape[0]
    b = ar.shape[-1]
    if sweeps is None:
        sweeps = _sweeps_for(ar.dtype, n)
    eps = _eps_for(ar.dtype)

    vr = jnp.zeros((2, n, b), ar.dtype)
    vr = vr.at[0, in_spin].set(1.0).at[1, out_spin].set(1.0)
    vr = vr + 0.0 * ar[:1, :1]          # inherit device-varying axes
    vi = jnp.zeros_like(vr)

    def sweep(_, carry):
        ar, ai, vr, vi = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                ar, ai, vr, vi = _herm_rotate_lanes(ar, ai, vr, vi, p, q,
                                                    eps)
        return ar, ai, vr, vi

    ar, ai, vr, vi = jax.lax.fori_loop(0, sweeps, sweep, (ar, ai, vr, vi))

    lam = jnp.stack([ar[i, i] for i in range(n)])   # (n, B), unsorted
    bir, bii = vr[0], vi[0]      # V[in, :]  as (n, B)
    aor, aoi = vr[1], vi[1]      # V[out, :]
    gr = aor * bir + aoi * bii
    gi = aoi * bir - aor * bii
    ang = lam * t[None, :]
    fr, fi = jnp.cos(ang), -jnp.sin(ang)
    phr = jnp.sum(gr * fr - gi * fi, axis=0)
    phi = jnp.sum(gr * fi + gi * fr, axis=0)
    return phr * phr + phi * phi
