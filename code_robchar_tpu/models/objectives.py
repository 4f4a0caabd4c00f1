"""Device-side objective builders shared by the optimizer zoo.

The reference builds per-optimizer ``infidelity`` closures over four noise
regimes (qnewton.py:383-455, 500-514):

- noiseless:          1 - |<out|U|in>|^2, exact gradient available
- ham_noisy:          a fresh *real-offdiagonal* structured perturbation per
                      objective call (qnewton.py:391-392 + 366-379)
- fid_noisy:          binomial shot noise on the fidelity (qnewton.py:405-409),
                      optionally the adaptive Bayesian protocol (410-423)
- use_fixed_ham:      mean fidelity over a pre-drawn ensemble
                      (qnewton.py:425-444), each call billed train_size
                      function calls (SURVEY.md §5 fcall accounting)

Here each regime is one pure function `(x, key) -> (infidelity, fcalls)`;
the fcall increment rides in-band so the exact accounting survives jit.
All builders vmap/grad cleanly; everything is traced once per optimizer.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from code_robchar_tpu.metrics.rim import wd_from_ideal
from code_robchar_tpu.ops import noise as noise_ops, realform, select


class ObjectiveSpec(NamedTuple):
    h0: jnp.ndarray                 # (n, n) drift
    in_spin: int
    out_spin: int
    noise: float                    # sigma for ham noise
    fid_noisy: bool
    ham_noisy: bool
    draws: int
    adaptive: bool
    adp_tol: float
    fixed_hams: Optional[jnp.ndarray]  # (R, n, n) pre-perturbed ensemble
    mul_fac: int                    # fcall multiplier (train_size or 1)


def make_infidelity(spec: ObjectiveSpec
                    ) -> Callable[[jnp.ndarray, jax.Array],
                                  Tuple[jnp.ndarray, jnp.ndarray]]:
    """(x, key) -> (infidelity, fcall_increment).

    The whole training path is REAL symmetric (XX drift + real training
    noise, SURVEY.md quirk 7), so everything runs on the split-real
    kernels (ops/realform.py) — no complex dtype.
    """
    n = spec.h0.shape[-1]
    h0r = jnp.real(spec.h0)
    fixed_r = jnp.real(spec.fixed_hams) if spec.fixed_hams is not None \
        else None

    def clean_fid(hr, x):
        return realform.fidelity_from_controller_sym(
            hr, x, spec.in_spin, spec.out_spin)

    def one_fid(x, key):
        kh, ks = jax.random.split(key)
        h = h0r
        if spec.ham_noisy:
            # training-side noise is the REAL-offdiagonal variant
            # (qnewton.py:366-379; SURVEY.md quirk 7)
            zr, _ = noise_ops.structured_perturbation_parts(
                kh, n, spec.noise, complex_offdiag=False, dtype=h.dtype)
            h = h + zr
        fid = clean_fid(h, x)
        if spec.fid_noisy:
            if spec.adaptive:
                fid, extra = noise_ops.adaptive_shot_fidelity(
                    ks, fid, spec.draws, spec.adp_tol)
                return fid, (extra + spec.draws).astype(jnp.int32)
            fid = noise_ops.shot_noise_fidelity(ks, fid, spec.draws)
        return fid, jnp.asarray(1, jnp.int32)

    if spec.fixed_hams is not None:
        def infid(x, key):
            # mean fidelity over the fixed ensemble.  The increment is the
            # RAW call count (1); the train_size multiplier (qnewton.py:558,
            # nmplus.py:252) is applied by each optimizer's billing layer so
            # the reference's per-optimizer accounting quirks stay local.
            fids = jax.vmap(lambda h: clean_fid(h, x))(fixed_r)
            fid = jnp.mean(fids)
            if spec.fid_noisy:
                fid = noise_ops.shot_noise_fidelity(key, fid, spec.draws)
            return 1.0 - fid, jnp.asarray(1, jnp.int32)
        return infid

    def infid(x, key):
        fid, calls = one_fid(x, key)
        return 1.0 - fid, calls
    return infid


def make_exact_gradient(spec: ObjectiveSpec):
    """(x) -> (infidelity, grad): the analytic eigenbasis gradient
    (noiseless drift; the reference's exact-gradient path qnewton.py:497),
    on the split-real kernels."""
    h0r = jnp.real(spec.h0)

    def f(x):
        return realform.infidelity_and_gradient_sym(h0r, x, spec.in_spin,
                                                    spec.out_spin)
    return f


def make_exact_gradient_batch(spec: ObjectiveSpec):
    """(xs (K, d)) -> (errs (K,), grads (K, d)): the exact analytic
    gradient with the restart batch riding the LANE dimension through one
    Jacobi chain — the optimizer zoo's hot path.  Where ops/select.py
    picks the Pallas kernel the whole evaluation (full-V eigh +
    Daleckii-Krein contraction) is one launch
    (pallas_jacobi.infidelity_and_gradient_sym_pallas); elsewhere the XLA
    lanes kernel (realform.infidelity_and_gradient_sym_lanes)."""
    h0r = jnp.real(spec.h0)
    use_pallas = select.use_pallas()

    def f(xs):
        if use_pallas:
            from code_robchar_tpu.ops.pallas_jacobi import \
                infidelity_and_gradient_sym_pallas
            return infidelity_and_gradient_sym_pallas(
                h0r, xs, spec.in_spin, spec.out_spin)
        return realform.infidelity_and_gradient_sym_lanes(
            h0r, xs, spec.in_spin, spec.out_spin)
    return f


def _make_fid_lanes(in_spin: int, out_spin: int):
    """(a (n, n, B), t (B,)) -> fids (B,): the shared lanes fidelity
    kernel — the Pallas kernel or the XLA lanes path, as ops/select.py
    picks."""
    use_pallas = select.use_pallas()

    def fid_lanes(a, t):
        if use_pallas:
            from code_robchar_tpu.ops.pallas_jacobi import \
                fidelity_sym_pallas
            return fidelity_sym_pallas(a, t, in_spin, out_spin)
        return realform.fidelity_sym_lanes(a, t, in_spin, out_spin)
    return fid_lanes


def _assemble_lanes(h0r, xs, zdiag=None, znn=None):
    """(n, n, K) lanes Hamiltonians: drift + per-lane diagonal controls
    (+ optional pre-scaled structured-noise draws)."""
    n = h0r.shape[-1]
    k = xs.shape[0]
    dt = h0r.dtype
    a = jnp.broadcast_to(h0r[:, :, None], (n, n, k)).astype(dt)
    add_diag = xs[:, :n].T.astype(dt)
    if zdiag is not None:
        add_diag = add_diag + zdiag.T
    for i in range(n):
        a = a.at[i, i].add(add_diag[i])
    if znn is not None:
        for i in range(1, n):
            a = a.at[i, i - 1].add(znn[:, i - 1])
            a = a.at[i - 1, i].add(znn[:, i - 1])
    return a


def _structured_draws_lanes(key, count, n, noise, dt):
    """Per-lane real structured-noise draws (qnewton.py:366-379): one
    (zdiag (count, n), znn (count, n-1)) pair per lane, keys folded from
    the lane index with the reference's 3-way split/order (the third
    stream is the complex-offdiagonal part, unused in the real
    training-noise variant)."""
    keys = jax.vmap(jax.random.fold_in, (None, 0))(
        key, jnp.arange(count, dtype=jnp.uint32))
    parts = jax.vmap(lambda kk: jax.random.split(kk, 3))(keys)
    zdiag = jax.vmap(
        lambda kk: jax.random.normal(kk, (n,), dt))(parts[:, 0]) * noise
    znn = jax.vmap(
        lambda kk: jax.random.normal(kk, (n - 1,), dt))(parts[:, 1]) * noise
    return zdiag, znn


def make_infidelity_batch(spec: ObjectiveSpec):
    """(xs (K, d), key) -> (infids (K,), fcalls (K,)) — the batched lanes
    counterpart of make_infidelity (same noise semantics and billing; draw
    streams fold the lane index, so they differ from vmapping the
    single-point objective — parity is distributional, SURVEY §7.4)."""
    n = spec.h0.shape[-1]
    h0r = jnp.real(spec.h0)
    fixed_r = jnp.real(spec.fixed_hams) if spec.fixed_hams is not None \
        else None
    fid_lanes = _make_fid_lanes(spec.in_spin, spec.out_spin)

    def infid(xs, key):
        k = xs.shape[0]
        dt = h0r.dtype
        t = jnp.abs(xs[:, n]).astype(dt)
        kh, ks = jax.random.split(key)
        if fixed_r is not None:
            # mean FIDELITY over the pre-drawn ensemble (qnewton.py:425-444)
            r = fixed_r.shape[0]
            base = jnp.transpose(fixed_r, (1, 2, 0)).astype(dt)  # (n,n,R)
            a = jnp.broadcast_to(base[:, :, None, :], (n, n, k, r))
            for i in range(n):
                a = a.at[i, i].add(xs[:, i].astype(dt)[:, None])
            fids = fid_lanes(a.reshape(n, n, k * r),
                             jnp.repeat(t, r)).reshape(k, r)
            fid = jnp.mean(fids, axis=1)
            if spec.fid_noisy:
                keys = jax.vmap(jax.random.fold_in, (None, 0))(
                    ks, jnp.arange(k, dtype=jnp.uint32))
                fid = jax.vmap(lambda kk, f: noise_ops.shot_noise_fidelity(
                    kk, f, spec.draws))(keys, fid)
            return 1.0 - fid, jnp.full((k,), 1, jnp.int32)

        zdiag = znn = None
        if spec.ham_noisy:
            zdiag, znn = _structured_draws_lanes(kh, k, n, spec.noise, dt)
        a = _assemble_lanes(h0r, xs, zdiag, znn)
        fid = fid_lanes(a, t)
        calls = jnp.full((xs.shape[0],), 1, jnp.int32)
        if spec.fid_noisy:
            keys = jax.vmap(jax.random.fold_in, (None, 0))(
                ks, jnp.arange(xs.shape[0], dtype=jnp.uint32))
            if spec.adaptive:
                fid, extra = jax.vmap(
                    lambda kk, f: noise_ops.adaptive_shot_fidelity(
                        kk, f, spec.draws, spec.adp_tol))(keys, fid)
                calls = (extra + spec.draws).astype(jnp.int32)
            else:
                fid = jax.vmap(lambda kk, f: noise_ops.shot_noise_fidelity(
                    kk, f, spec.draws))(keys, fid)
        return 1.0 - fid, calls

    return infid


def make_fd_gradient(infid_fn, dim: int, eps: float = 1e-8):
    """Forward-difference gradient of a (possibly noisy) objective.

    Mirrors scipy's approx_grad accounting: one gradient costs dim+1
    objective calls (qnewton.py:513-514 uses approx_grad=True).  All dim+1
    probes evaluate in one vmap.
    """
    def grad(x, key):
        keys = jax.random.split(key, dim + 1)
        f0, c0 = infid_fn(x, keys[0])
        probes = x + eps * jnp.eye(dim, dtype=x.dtype)
        fs, cs = jax.vmap(infid_fn)(probes, keys[1:])
        g = (fs - f0) / eps
        return f0, g, (c0 + jnp.sum(cs)).astype(jnp.int32)
    return grad


def make_fd_gradient_batch(infid_batch_fn, dim: int, eps: float = 1e-8):
    """Batched forward-difference gradient: (xs (K, d), key) ->
    (f0 (K,), g (K, d), fcalls (K,)).  All K*(d+1) probes ride one lanes
    batch; accounting matches make_fd_gradient (dim+1 objective calls per
    gradient, qnewton.py:513-514)."""
    def grad(xs, key):
        k = xs.shape[0]
        eye = jnp.eye(dim, dtype=xs.dtype)
        probes = jnp.concatenate(
            [xs[:, None, :], xs[:, None, :] + eps * eye[None, :, :]],
            axis=1)                                   # (K, d+1, d)
        fs, cs = infid_batch_fn(probes.reshape(k * (dim + 1), dim), key)
        fs = fs.reshape(k, dim + 1)
        cs = cs.reshape(k, dim + 1)
        f0 = fs[:, 0]
        g = (fs[:, 1:] - f0[:, None]) / eps
        return f0, g, jnp.sum(cs, axis=1).astype(jnp.int32)
    return grad


def make_wass_cost(spec: ObjectiveSpec, bootstrap_reps: int = 5):
    """Wasserstein robustness cost (qnewton.py:447-455): RIM_1 of
    ``bootstrap_reps`` ham-noisy fidelity draws around x.  Note the
    reference probes with the real-offdiagonal training noise."""
    n = spec.h0.shape[-1]
    h0r = jnp.real(spec.h0)

    def cost(x, key):
        keys = jax.random.split(key, bootstrap_reps)

        def draw(k):
            zr, _ = noise_ops.structured_perturbation_parts(
                k, n, spec.noise, complex_offdiag=False, dtype=h0r.dtype)
            return realform.fidelity_from_controller_sym(
                h0r + zr, x, spec.in_spin, spec.out_spin)
        fids = jax.vmap(draw)(keys)
        return wd_from_ideal(jnp.clip(fids, 0.0, 1.0))
    return cost


def make_wass_cost_batch(spec: ObjectiveSpec, bootstrap_reps: int = 5):
    """(xs (K, d), key) -> (costs (K,), fcalls (K,)): batched Wasserstein
    robustness cost, the use_wass_cost training objective (qnewton.py:512
    selects it in the noisy LBFGS branch; the cost itself at :447-455
    probes ham_noisy fidelity ``bootstrap_reps`` times, so each objective
    call bills ``bootstrap_reps`` function calls).  All K * reps probe
    Hamiltonians ride one lanes batch; the per-lane RIM_1 reduction is
    a trailing-axis wd_from_ideal."""
    n = spec.h0.shape[-1]
    h0r = jnp.real(spec.h0)
    fid_lanes = _make_fid_lanes(spec.in_spin, spec.out_spin)

    def cost(xs, key):
        k = xs.shape[0]
        dt = h0r.dtype
        kr = k * bootstrap_reps
        # one real-offdiagonal structured draw per (lane, rep)
        zdiag, znn = _structured_draws_lanes(key, kr, n, spec.noise, dt)
        xr = jnp.repeat(xs, bootstrap_reps, axis=0)          # (K*R, d)
        a = _assemble_lanes(h0r, xr, zdiag, znn)
        fids = fid_lanes(a, jnp.abs(xr[:, n]).astype(dt))
        fids = jnp.clip(fids, 0.0, 1.0).reshape(k, bootstrap_reps)
        return wd_from_ideal(fids), \
            jnp.full((k,), bootstrap_reps, jnp.int32)
    return cost
