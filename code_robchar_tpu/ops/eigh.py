"""Batched Hermitian eigendecomposition via cyclic Jacobi rotations.

Why not `jnp.linalg.eigh` everywhere?  The MC robustness engine diagonalises
O(1e7) *tiny* (n<=10) Hermitian matrices per sweep (SURVEY.md §6 north star).
XLA's stock eigh targets large matrices; for a huge batch of tiny ones the
right shape is the opposite: make the *batch* the vector dimension and
run the O(n^2) rotation schedule in lockstep across it.  Every operation in
a Jacobi sweep (rotation angles, row/column updates) is elementwise over the
batch, so a (B, n, n) problem compiles to ~sweeps * n(n-1)/2 fused
(B,)-shaped vector ops — no per-matrix control flow, no dynamic shapes.

Algorithm: classic cyclic-by-rows complex Jacobi.  For the (p, q) pivot with
a_pq = r e^{i alpha}:

    tau = (a_qq - a_pp) / (2 r),  t = sign(tau)/(|tau| + sqrt(1+tau^2)),
    c = 1/sqrt(1+t^2),  s = t c,
    J restricted to (p,q):  [[c, s e^{i alpha}], [-s e^{-i alpha}, c]]

zeroes A[p,q] exactly; A <- J^H A J, V <- V J.  Off-diagonal Frobenius mass
decays quadratically once sweeps converge; the default sweep schedule is
realform._sweeps_for, measured to the rounding floor for n <= 10 (the paper
envelope, incl. hard/degenerate spectra) at float32 (throughput regime) and
float64 (parity regime) — validated against LAPACK eigh in
tests/test_propagate.py.  For n > 10 pass ``sweeps`` explicitly.

This file is the pure-XLA formulation; the Pallas kernels in
``code_robchar_tpu.ops.pallas_jacobi`` implement the same rotations with
each matrix entry held in registers for the whole solve.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

_TINY = 1e-300


def _rotation(app: jnp.ndarray, aqq: jnp.ndarray, apq: jnp.ndarray,
              eps: float) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched Jacobi rotation parameters (c, s, e^{i alpha}).

    Degenerate pivots (|a_pq| <= eps * scale) get the identity rotation via
    `where`, keeping the schedule branch-free.
    """
    r = jnp.abs(apq)
    scale = jnp.abs(app) + jnp.abs(aqq) + r
    active = r > eps * scale
    safe_r = jnp.where(active, r, 1.0)
    phase = jnp.where(active, apq / safe_r.astype(apq.dtype), 1.0 + 0j)
    tau = (aqq - app) / (2.0 * safe_r)
    t = jnp.sign(tau) / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
    t = jnp.where(jnp.abs(tau) < _TINY, 1.0, t)  # tau == 0 -> 45 deg
    c = 1.0 / jnp.sqrt(1.0 + t * t)
    s = t * c
    c = jnp.where(active, c, 1.0)
    s = jnp.where(active, s, 0.0)
    phase = jnp.where(active, phase, 1.0 + 0j)
    t_eff = jnp.where(active, t, 0.0)
    return c, s, phase, t_eff, r, active


def _apply_rotation(a: jnp.ndarray, v: jnp.ndarray, p: int, q: int,
                    eps: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One (p, q) pivot: A <- J^H A J, V <- V J, batched over leading axes.

    Symmetric update (same algebra as realform/pallas_jacobi): only the
    column pair is rotated; rows p, q are conjugate mirrors and the 2x2
    pivot block is closed-form (A[p,q] zeroed exactly, Rutishauser
    diagonal) — ~2/3 the arithmetic, and the diagonal stays exactly real.
    """
    app = a[..., p, p].real
    aqq = a[..., q, q].real
    apq = a[..., p, q]
    c, s, phase, t_eff, r, active = _rotation(app, aqq, apq, eps)
    cc = c[..., None].astype(a.dtype)
    ss = s[..., None].astype(a.dtype)
    ph = phase[..., None]

    # column update: (A J)[:, p] = c A[:,p] - s e^{-ia} A[:,q]
    #                (A J)[:, q] = s e^{+ia} A[:,p] + c A[:,q]
    col_p = a[..., :, p]
    col_q = a[..., :, q]
    new_p = cc * col_p - ss * ph.conj() * col_q
    new_q = ss * ph * col_p + cc * col_q
    a = a.at[..., :, p].set(new_p).at[..., :, q].set(new_q)

    # rows p, q by Hermitian symmetry + closed-form pivot block
    npp = (app - t_eff * r).astype(a.dtype)
    nqq = (aqq + t_eff * r).astype(a.dtype)
    zpq = jnp.where(active, jnp.zeros_like(apq), apq)
    new_rp = new_p.conj().at[..., p].set(npp).at[..., q].set(zpq)
    new_rq = new_q.conj().at[..., p].set(zpq.conj()).at[..., q].set(nqq)
    a = a.at[..., p, :].set(new_rp).at[..., q, :].set(new_rq)

    # eigenvector columns: V <- V J (same column ops as A J)
    vcol_p = v[..., :, p]
    vcol_q = v[..., :, q]
    nv_p = cc * vcol_p - ss * ph.conj() * vcol_q
    nv_q = ss * ph * vcol_p + cc * vcol_q
    v = v.at[..., :, p].set(nv_p).at[..., :, q].set(nv_q)
    return a, v


def _default_sweeps(n: int, dtype) -> int:
    # Single source of truth for the measured sweep schedule; finfo of a
    # complex dtype reports its real component's precision, so the policy
    # applies unchanged to the complex path.
    from code_robchar_tpu.ops.realform import _sweeps_for
    return _sweeps_for(jnp.zeros((), dtype).real.dtype, n)


@partial(jax.jit, static_argnames=("sweeps",))
def jacobi_eigh(h: jnp.ndarray, sweeps: int | None = None
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Drop-in batched replacement for jnp.linalg.eigh on Hermitian input.

    Returns (eigenvalues ascending, eigenvectors as columns), shapes
    (..., n) and (..., n, n).  Fixed rotation schedule => fully unrolled,
    branch-free XLA program, ideal for huge leading batch dims.
    """
    n = h.shape[-1]
    if sweeps is None:
        sweeps = _default_sweeps(n, h.dtype)
    eps = 1e-7 if jnp.finfo(jnp.zeros((), h.dtype).real.dtype).bits <= 32 \
        else 1e-15

    a = h
    # identity init written as 0*h + I so v inherits h's device-varying
    # axes (keeps the fori_loop carry consistent under shard_map).
    v = jnp.zeros_like(h) + jnp.eye(n, dtype=h.dtype)

    def sweep(_, carry):
        a, v = carry
        for p in range(n - 1):
            for q in range(p + 1, n):
                a, v = _apply_rotation(a, v, p, q, eps)
        return a, v

    # one sweep is traced once; fori_loop keeps the XLA program O(n^2) ops
    # instead of O(sweeps * n^2).
    a, v = jax.lax.fori_loop(0, sweeps, sweep, (a, v))

    lam = jnp.diagonal(a, axis1=-2, axis2=-1).real
    order = jnp.argsort(lam, axis=-1)
    lam_sorted = jnp.take_along_axis(lam, order, axis=-1)
    v_sorted = jnp.take_along_axis(v, order[..., None, :], axis=-1)
    return lam_sorted, v_sorted
