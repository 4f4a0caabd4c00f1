"""Plain float64 reference of the spin-chain transfer problem.

Everything here is written from the paper's definitions (arXiv:2207.07801,
sections II-III) in NumPy and SciPy, and imports nothing of the program:

- the single-excitation XX chain of length n: real symmetric drift with
  the configuration's nearest-neighbour coupling;
- a controller x = (b_0 .. b_{n-1}, T): H = H0 + diag(b), read out at
  time |T|; its transfer fidelity is |<out| exp(-i |T| H) |in>|^2;
- characterisation noise: real diagonal and complex nearest-neighbour
  perturbations of width sigma (draws from reference/prng.py);
- the five robustness metrics of a fidelity sample and their DKW bands.

``precision="float64"`` is the reference.  ``precision="bfloat16"`` is
the control: the same computation with every array it stores rounded to
bfloat16 (the eigendecomposition itself runs in float32 on the rounded
matrix, since LAPACK has no bfloat16), the step below the float32 that
the configurations state.
"""

from __future__ import annotations

import numpy as np
import ml_dtypes
from scipy.optimize import minimize

from reference import prng

RIM = r"$W(.,\delta(x-1))$"
#: fidelity thresholds of the two yield metrics
Q_TH = {"Q th. 0.95": 0.95, "Q th. 0.98": 0.98}


def _round(a, precision):
    if precision == "float64":
        return a
    if precision != "bfloat16":
        raise ValueError(f"unknown precision {precision!r}")
    if np.iscomplexobj(a):
        return _round(a.real, precision) + 1j * _round(a.imag, precision)
    return a.astype(ml_dtypes.bfloat16).astype(np.float64)


def drift(n: int, coupling: float) -> np.ndarray:
    """Open XX chain, single-excitation subspace: (n, n) float64."""
    h = np.zeros((n, n))
    i = np.arange(n - 1)
    h[i, i + 1] = h[i + 1, i] = coupling
    return h


def transfer_fidelity(h, t, in_spin: int, out_spin: int,
                      precision: str = "float64") -> np.ndarray:
    """|<out| exp(-i t H) |in>|^2 for Hermitian h (..., n, n), t (...)."""
    h = _round(np.asarray(h), precision)
    t = _round(np.abs(np.asarray(t, np.float64)), precision)
    if precision == "float64":
        lam, v = np.linalg.eigh(h)
    else:
        lam, v = np.linalg.eigh(h.astype(np.complex64 if np.iscomplexobj(h)
                                         else np.float32))
        lam, v = _round(lam.astype(np.float64), precision), \
            _round(v.astype(np.complex128 if np.iscomplexobj(v)
                            else np.float64), precision)
    ang = _round(lam * t[..., None], precision)
    ph = _round(np.cos(ang) - 1j * np.sin(ang), precision)
    w = _round(v[..., out_spin, :] * np.conj(v[..., in_spin, :]), precision)
    amp = _round(np.sum(w * ph, axis=-1), precision)
    return np.abs(amp) ** 2


def controller_fidelity(h0, x, in_spin: int, out_spin: int,
                        precision: str = "float64") -> np.ndarray:
    """Noiseless fidelity of controllers x (..., n + 1)."""
    x = np.asarray(x, np.float64)
    n = h0.shape[-1]
    h = h0 + x[..., :n, None] * np.eye(n)
    return transfer_fidelity(h, x[..., n], in_spin, out_spin, precision)


def perturbed_hamiltonians(h0, key, gids, sigma, x) -> np.ndarray:
    """Noisy Hamiltonians of lattice elements ``gids`` (uint32, m) drawn
    from the call's raw ``key`` words, at widths ``sigma`` (m,), with
    controllers ``x`` (m, n + 1): complex128 (m, n, n)."""
    n = h0.shape[-1]
    ek = prng.fold_in(key, gids)
    kd, kn, k2 = prng.split(ek, 3)
    sigma = np.asarray(sigma, np.float64)[:, None]
    diag = prng.normal(kd, n) * sigma
    nn = prng.normal(kn, n - 1) * sigma
    nn2 = prng.normal(k2, n - 1) * sigma
    h = np.zeros((len(gids), n, n), np.complex128) + h0
    i = np.arange(n)
    h[:, i, i] += diag + np.asarray(x, np.float64)[:, :n]
    j = np.arange(1, n)
    h[:, j, j - 1] += nn + 1j * nn2
    h[:, j - 1, j] += nn - 1j * nn2
    return h


def dkw_eps(alpha: float, nobs: int) -> float:
    """DKW band half-width sqrt(log(2 / alpha) / (2 n))."""
    return float(np.sqrt(np.log(2.0 / alpha) / (2.0 * nobs)))


def metric_values(fids: np.ndarray, alpha: float) -> dict:
    """The five metrics and their bands of samples fids (cells, B):
    {name: (cells,)}, names as the characterisation cache stores them.
    The "upper" band is computed from fids - eps and "lower" from
    fids + eps, both clipped to [0, 1]."""
    eps = dkw_eps(alpha, fids.shape[-1])
    out = {}
    for suffix, f in (("", fids), (" upper", np.clip(fids - eps, 0, 1)),
                      (" lower", np.clip(fids + eps, 0, 1))):
        out[RIM + suffix] = np.mean(1.0 - f, axis=-1)
        for name, th in Q_TH.items():
            out[name + suffix] = -np.mean(f >= th, axis=-1)
        out["std" + suffix] = np.std(f, axis=-1)
        out["worst case fid" + suffix] = -np.min(f, axis=-1)
    return out


def yield_bounds(fids: np.ndarray, alpha: float, tol: float) -> dict:
    """For the yield metrics, the range of values that fidelities within
    ``tol`` of the reference's could give: {name: (lo, hi)} of (cells,)."""
    eps = dkw_eps(alpha, fids.shape[-1])
    out = {}
    for suffix, f in (("", fids), (" upper", np.clip(fids - eps, 0, 1)),
                      (" lower", np.clip(fids + eps, 0, 1))):
        for name, th in Q_TH.items():
            out[name + suffix] = (-np.mean(f >= th - tol, axis=-1),
                                  -np.mean(f >= th + tol, axis=-1))
    return out


def _central_grad(fun, x, h=1e-6):
    g = np.empty_like(x)
    for i in range(x.size):
        e = np.zeros_like(x)
        e[i] = h
        g[i] = (fun(x + e) - fun(x - e)) / (2 * h)
    return g


def local_optimum(h0, x, in_spin: int, out_spin: int, bounds,
                  precision: str = "float64"):
    """SciPy's L-BFGS-B from ``x`` on the infidelity in ``precision``, with
    its default stopping rules (projected gradient below 1e-5, relative
    decrease below factr 1e7 times the float64 epsilon), which are the
    paper's collection settings; central-difference gradient.  Returns
    the controller it stops at."""
    step = 1e-6 if precision == "float64" else 1e-2

    def infid(z):
        return 1.0 - float(controller_fidelity(h0, z, in_spin, out_spin,
                                               precision))

    res = minimize(infid, np.asarray(x, np.float64),
                   jac=lambda z: _central_grad(infid, z, step),
                   method="L-BFGS-B", bounds=bounds)
    return res.x


def ascent_gain(h0, x, in_spin: int, out_spin: int, bounds) -> float:
    """How much float64 fidelity the reference optimiser still gains from
    controller x: near 0 where x is a point at which it would stop too."""
    f0 = float(controller_fidelity(h0, x, in_spin, out_spin))
    xo = local_optimum(h0, x, in_spin, out_spin, bounds)
    return max(0.0, float(controller_fidelity(h0, xo, in_spin, out_spin))
               - f0)
