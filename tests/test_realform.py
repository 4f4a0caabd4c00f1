"""Split-real kernel parity vs the complex reference implementations.

The production path never touches a complex dtype (ops/realform.py);
these tests pin it to the complex oracles at float64 <= 1e-10.
"""

import numpy as np
import jax
import jax.numpy as jnp

from code_robchar_tpu.ops import chain, noise, propagate, realform


def rand_controller(rng, n):
    return jnp.asarray(np.concatenate([rng.uniform(-10, 10, n),
                                       rng.uniform(0.5, 30, 1)]))


def test_jacobi_sym_matches_lapack(rng):
    for n in (4, 7, 10):
        a = rng.normal(size=(16, n, n))
        h = (a + np.transpose(a, (0, 2, 1))) / 2
        lam, v = realform.jacobi_eigh_sym(jnp.asarray(h))
        np.testing.assert_allclose(np.asarray(lam), np.linalg.eigvalsh(h),
                                   atol=1e-10)
        hv = np.einsum("bij,bjk->bik", h, np.asarray(v))
        vl = np.asarray(v) * np.asarray(lam)[:, None, :]
        np.testing.assert_allclose(hv, vl, atol=1e-9)


def test_jacobi_herm_matches_lapack(rng):
    for n in (4, 7, 10):
        a = rng.normal(size=(16, n, n)) + 1j * rng.normal(size=(16, n, n))
        h = (a + np.conj(np.transpose(a, (0, 2, 1)))) / 2
        lam, vr, vi = realform.jacobi_eigh_herm(
            jnp.asarray(h.real), jnp.asarray(h.imag))
        np.testing.assert_allclose(np.asarray(lam), np.linalg.eigvalsh(h),
                                   atol=1e-10)
        v = np.asarray(vr) + 1j * np.asarray(vi)
        hv = np.einsum("bij,bjk->bik", h, v)
        vl = v * np.asarray(lam)[:, None, :]
        np.testing.assert_allclose(hv, vl, atol=1e-9)


def test_fidelity_sym_parity(rng):
    for n, out in [(4, 2), (5, 2), (7, 6)]:
        h0c = chain.xx_hamiltonian(n)
        h0r = jnp.real(h0c)
        for _ in range(5):
            x = rand_controller(rng, n)
            f_complex = float(propagate.fidelity_from_controller(
                h0c, x, 0, out))
            f_real = float(realform.fidelity_from_controller_sym(
                h0r, x, 0, out))
            assert abs(f_complex - f_real) < 1e-10


def test_fidelity_herm_parity(rng):
    n, out = 6, 3
    h0c = chain.xx_hamiltonian(n)
    for i in range(5):
        k = jax.random.key(i)
        z = noise.structured_perturbation(k, n, 0.05, complex_offdiag=True)
        zr, zi = noise.structured_perturbation_parts(k, n, 0.05,
                                                     complex_offdiag=True)
        # same key -> same draws in both representations
        np.testing.assert_allclose(np.asarray(z),
                                   np.asarray(zr) + 1j * np.asarray(zi),
                                   atol=0)
        x = rand_controller(np.random.default_rng(i), n)
        f_complex = float(propagate.fidelity_from_controller(
            h0c + z, x, 0, out))
        f_real = float(realform.fidelity_herm(
            jnp.real(h0c) + zr + jnp.eye(n) * x[:n], zi, jnp.abs(x[n]),
            0, out))
        assert abs(f_complex - f_real) < 1e-10


def test_gradient_sym_parity(rng):
    for n, out in [(4, 2), (7, 6)]:
        h0c = chain.xx_hamiltonian(n)
        h0r = jnp.real(h0c)
        for _ in range(5):
            x = rand_controller(rng, n)
            e1, g1 = propagate.infidelity_and_gradient(h0c, x, 0, out)
            e2, g2 = realform.infidelity_and_gradient_sym(h0r, x, 0, out)
            assert abs(float(e1) - float(e2)) < 1e-10
            np.testing.assert_allclose(np.asarray(g1), np.asarray(g2),
                                       atol=1e-9)


def test_gradient_sym_degenerate_ring():
    n = 6
    h0r = jnp.real(chain.xx_hamiltonian(n, topo="ring"))
    x = jnp.asarray(np.concatenate([np.full(n, 1.7), [5.0]]))
    err, grad = realform.infidelity_and_gradient_sym(h0r, x, 0, 3)
    assert np.isfinite(float(err)) and np.all(np.isfinite(np.asarray(grad)))


def test_batched_shapes(rng):
    n = 5
    h = jnp.asarray(rng.normal(size=(3, 4, n, n)))
    h = (h + jnp.swapaxes(h, -1, -2)) / 2
    lam, v = realform.jacobi_eigh_sym(h)
    assert lam.shape == (3, 4, n) and v.shape == (3, 4, n, n)
    fid = realform.fidelity_sym(h, jnp.asarray(2.0), 0, 2)
    assert fid.shape == (3, 4)


def test_fidelity_sym_lanes_matches_rows(rng):
    """The real-symmetric lanes kernel (RL env hot path) must agree with
    the rows-path fidelity_sym to full precision."""
    from code_robchar_tpu.ops import realform
    n, b = 5, 7
    a = rng.normal(size=(b, n, n))
    a = (a + a.transpose(0, 2, 1)) / 2
    t = rng.uniform(1, 20, b)
    want = np.asarray(realform.fidelity_sym(jnp.asarray(a),
                                            jnp.asarray(t), 0, 3))
    got = np.asarray(realform.fidelity_sym_lanes(
        jnp.asarray(a.transpose(1, 2, 0)), jnp.asarray(t), 0, 3))
    np.testing.assert_allclose(got, want, atol=1e-11, rtol=0)


def test_gradient_sym_lanes_matches_rows(rng):
    """The lanes exact-gradient kernel (optimizer-zoo hot path) must agree
    with the rows-path Daleckii-Krein gradient to <=1e-10."""
    from code_robchar_tpu.ops import realform
    n, b = 5, 9
    h0 = jnp.asarray(np.asarray(
        rng.normal(size=(n, n))), dtype=jnp.float64)
    h0 = (h0 + h0.T) / 2
    xs = jnp.asarray(np.column_stack([rng.uniform(-5, 5, (b, n)),
                                      rng.uniform(0.5, 20, b)]))
    err_l, grad_l = realform.infidelity_and_gradient_sym_lanes(h0, xs, 0, 3)
    for i in range(b):
        err_r, grad_r = realform.infidelity_and_gradient_sym(h0, xs[i], 0, 3)
        np.testing.assert_allclose(float(err_l[i]), float(err_r),
                                   atol=1e-10, rtol=0)
        np.testing.assert_allclose(np.asarray(grad_l[i]),
                                   np.asarray(grad_r), atol=1e-10, rtol=0)


def test_gradient_sym_lanes_negative_time(rng):
    """T = |x[n]| contract: gradient w.r.t. raw x[n] uses |t| like the
    rows path (both differentiate through the abs the same way)."""
    from code_robchar_tpu.ops import realform
    n = 4
    h0 = jnp.asarray(np.diag(np.zeros(n)) + np.eye(n, k=1) + np.eye(n, k=-1))
    x = np.array([1.0, -2.0, 0.5, 3.0, -7.0])
    err_l, grad_l = realform.infidelity_and_gradient_sym_lanes(
        h0, jnp.asarray(x)[None], 0, 2)
    err_r, grad_r = realform.infidelity_and_gradient_sym(
        h0, jnp.asarray(x), 0, 2)
    np.testing.assert_allclose(np.asarray(grad_l[0]), np.asarray(grad_r),
                               atol=1e-10, rtol=0)


def test_f32_sweep_policy_converges_on_hard_spectra(rng):
    """Regression guard for the _sweeps_for policy: at float32 the default
    sweep count must reach the f32 rounding floor (<= 1e-5 fidelity error
    vs the f64 oracle) on the hardest workload classes — the unbiased XX
    chain, the ring with exact degeneracies, and near-zero biases with
    small complex noise — across the paper's T range [0, 30]."""
    n, b = 7, 64
    h0 = np.eye(n, k=1) + np.eye(n, k=-1)
    ring = h0.copy()
    ring[0, n - 1] = ring[n - 1, 0] = 1.0
    t = rng.uniform(0.0, 30.0, b)

    # the n=10 ring (exact degeneracies, off-paper chain length) pins the
    # reduced n>8 margin; measured floor is identical at 5/6/7 sweeps
    ring10 = np.eye(10, k=1) + np.eye(10, k=-1)
    ring10[0, 9] = ring10[9, 0] = 1.0

    for base, bias_scale, nscale in ((h0, 0.0, 0.0), (ring, 0.0, 0.0),
                                     (h0, 0.01, 0.001),
                                     (ring10, 0.0, 0.001)):
        n = base.shape[0]
        ar = np.repeat(base[:, :, None], b, axis=2)
        ar[np.arange(n), np.arange(n)] += rng.uniform(
            -bias_scale, bias_scale, (n, b))
        ai = np.zeros((n, n, b))
        if nscale > 0:
            nn = rng.normal(scale=nscale, size=(n - 1, b))
            ar[np.arange(1, n), np.arange(n - 1)] += nn
            ar[np.arange(n - 1), np.arange(1, n)] += nn
            nn2 = rng.normal(scale=nscale, size=(n - 1, b))
            ai[np.arange(1, n), np.arange(n - 1)] += nn2
            ai[np.arange(n - 1), np.arange(1, n)] -= nn2
        w, v = np.linalg.eigh((ar + 1j * ai).transpose(2, 0, 1))
        ph = np.einsum("bk,bk,bk->b", v[:, n - 1, :],
                       np.exp(-1j * t[:, None] * w), v[:, 0, :].conj())
        fid64 = np.abs(ph) ** 2
        got = realform.fidelity_herm_lanes(
            jnp.asarray(ar, jnp.float32), jnp.asarray(ai, jnp.float32),
            jnp.asarray(t, jnp.float32), 0, n - 1)
        assert np.abs(np.asarray(got) - fid64).max() < 1e-5


def _augmented_expm_gradient(h0, x, in_spin, out_spin):
    """Reference oracle: the augmented-matrix expm gradient
    (qnewton.py:162-212) in f64 scipy — fully independent of the
    framework's Daleckii-Krein formulation."""
    import scipy.linalg

    n = h0.shape[0]
    t = abs(x[n])
    h = h0 + np.diag(x[:n])
    th = -1j * t * h
    u = scipy.linalg.expm(th)
    phi = u[out_spin, in_spin]
    err = 1.0 - (phi.real * phi.real + phi.imag * phi.imag)
    grad = np.zeros(n + 1)
    a = np.zeros((2 * n, 2 * n), dtype=complex)
    a[:n, :n] = th
    a[n:, n:] = th
    for l in range(n):
        a[n:, :n] = 0.0
        a[n + l, l] = -1j * t
        du = scipy.linalg.expm(a)[n:, :n]
        grad[l] = -2.0 * (du[out_spin, in_spin] * phi.conjugate()).real
    hu = h @ u
    grad[n] = -2.0 * (hu[out_spin, in_spin] * phi.conjugate()).imag
    return err, grad


def test_gradient_lanes_ring_degeneracies():
    """VERDICT r4 next #4: the lanes-path gradient at the ring
    topology's EXACT degeneracies (qnewton.py:145-147 — the periodic
    XX chain has doubly-degenerate eigenvalues 2cos(2 pi k/n)) and at
    near-degenerate spectra (tiny biases splitting the pairs by
    ~1e-4).  Before the sinc-form Daleckii-Krein the f32 device
    gradient measured up to 1.5e-2 off the f64 oracle here
    (docs/ROADMAP.md round-3); the sinc identity has no cancellation
    at any gap.  Targets: <= 1e-4 at f32, oracle-exact (1e-10) at f64.
    Oracle: the reference's own augmented-expm trick in scipy f64."""
    rng = np.random.default_rng(42)
    for n in (5, 6):
        ring = (np.eye(n, k=1) + np.eye(n, k=-1))
        ring[0, n - 1] = ring[n - 1, 0] = 1.0
        cases = []
        for scale in (0.0, 1e-4, 1e-2):
            for _ in range(4):
                cases.append(np.concatenate([
                    rng.uniform(-scale, scale, n),
                    rng.uniform(2.0, 20.0, 1)]))
        xs = np.asarray(cases)
        oracle = np.asarray([
            _augmented_expm_gradient(ring, x, 0, n - 1)[1] for x in xs])

        # f64 lanes: oracle-exact
        _, g64 = realform.infidelity_and_gradient_sym_lanes(
            jnp.asarray(ring), jnp.asarray(xs), 0, n - 1)
        np.testing.assert_allclose(np.asarray(g64), oracle, atol=1e-10)

        # f32 lanes: the production path on the CPU
        _, g32 = realform.infidelity_and_gradient_sym_lanes(
            jnp.asarray(ring, jnp.float32), jnp.asarray(xs, jnp.float32),
            0, n - 1)
        err = np.abs(np.asarray(g32, dtype=float) - oracle).max()
        assert err < 1e-4, f"n={n}: f32 lanes gradient off by {err:.2e}"

        # complex eigh path (propagate._gamma_matrix) at the same
        # degeneracies, f64: oracle-exact
        err64, gp = propagate.infidelity_and_gradient(
            jnp.asarray(ring, jnp.complex128), jnp.asarray(xs), 0, n - 1)
        np.testing.assert_allclose(np.asarray(gp), oracle, atol=1e-10)
