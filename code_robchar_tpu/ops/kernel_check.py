"""Compare each Pallas Jacobi kernel with the plain f64 reference.

The reference is ``jnp.linalg.eigh`` in float64 on the host CPU device
of the same process, applied to the same f32 inputs the kernel sees.
Inputs look like production ones: the XX chain plus controller biases
in [-10, 10], readout times in [0, 30] and structured noise of scale
0.1 (complex off-diagonal for the characterisation kernel, real for
the training kernels).

``chip_smoke.py`` and the GPU-marked tests call ``check_kernel`` with
``interpret=False`` on the card; the CPU tests call it in interpret
mode at small widths.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

#: absolute error bound on an f32 fidelity: the f32 Jacobi rounding
#: floor (eigenvalue error times T <= 30 dominates; the XLA lanes path
#: reaches 5e-6 at n = 7 on these inputs, 65536 elements)
FID_TOL = 3e-5
#: absolute bound on an amplitude component (phr, phi): the phase error
#: that |amp|^2 cancels shows here; the lanes path itself reaches 3.3e-5
#: at n = 7 on these inputs (65536 elements), so twice that
AMP_TOL = 6e-5
#: bound on max |grad - ref| / max |ref| over a batch
GRAD_RTOL = 1e-4

KINDS = ("herm_fid", "sym_amp", "sym_grad")


def make_inputs(kind: str, n: int, b: int, seed: int = 0):
    """f32 numpy inputs: (H (b, n, n) complex or real, t (b,)) for the
    fidelity kernels, (h0 (n, n), xs (b, n+1)) for the gradient."""
    rng = np.random.default_rng(seed)
    h0 = np.zeros((n, n))
    for i in range(1, n):
        h0[i - 1, i] = h0[i, i - 1] = 1.0
    bias = rng.uniform(-10, 10, (b, n))
    t = rng.uniform(0, 30, b)
    if kind == "sym_grad":
        xs = np.column_stack([bias, t]).astype(np.float32)
        return h0.astype(np.float32), xs
    h = np.broadcast_to(h0, (b, n, n)).astype(complex)
    idx = np.arange(n)
    h[:, idx, idx] += bias + 0.1 * rng.normal(size=(b, n))
    off = 0.1 * rng.normal(size=(b, n - 1))
    if kind == "herm_fid":
        off = off + 0.1j * rng.normal(size=(b, n - 1))
    h[:, idx[1:], idx[:-1]] += off
    h[:, idx[:-1], idx[1:]] += np.conj(off)
    h = h.astype(np.complex64)
    if kind == "sym_amp":
        h = h.real
    return h, t.astype(np.float32)


def reference(kind: str, inputs, in_spin: int, out_spin: int):
    """f64 outputs on the host CPU: fidelities (b,), amplitudes (2, b) or
    (errors (b,), gradients (b, n+1))."""
    from code_robchar_tpu.ops import realform

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        if kind == "sym_grad":
            h0, xs = (jnp.asarray(x, jnp.float64) for x in inputs)
            return jax.jit(jax.vmap(lambda x: realform.
                                    infidelity_and_gradient_sym(
                                        h0, x, in_spin, out_spin,
                                        eigh_sym=jnp.linalg.eigh)))(xs)
        h, t = inputs
        h = jnp.asarray(h, jnp.complex128 if np.iscomplexobj(h)
                        else jnp.float64)
        lam, v = jnp.linalg.eigh(h)
        amp = jnp.einsum("bk,bk,bk->b", v[:, out_spin, :],
                         jnp.conj(v[:, in_spin, :]),
                         jnp.exp(-1j * lam * jnp.asarray(t, jnp.float64)
                                 [:, None]))
        if kind == "sym_amp":
            return jnp.stack([amp.real, amp.imag])
        return jnp.abs(amp) ** 2


def run_kernel(kind: str, inputs, in_spin: int, out_spin: int,
               interpret: bool = False, block=None):
    """The kernel's outputs on the default device."""
    from code_robchar_tpu.ops import pallas_jacobi as pj

    if kind == "sym_grad":
        h0, xs = (jnp.asarray(x) for x in inputs)
        return pj.infidelity_and_gradient_sym_pallas(
            h0, xs, in_spin, out_spin, block=block, interpret=interpret)
    h, t = inputs
    a = jnp.asarray(np.moveaxis(h.real, 0, -1).copy())
    t = jnp.asarray(t)
    if kind == "sym_amp":
        return jnp.stack(pj.transfer_amp_sym_pallas(
            a, t, in_spin, out_spin, block=block, interpret=interpret))
    ai = jnp.asarray(np.moveaxis(h.imag, 0, -1).copy())
    return pj.fidelity_herm_pallas(a, ai, t, in_spin, out_spin,
                                   block=block, interpret=interpret)


def check_kernel(kind: str, n: int, b: int, interpret: bool = False,
                 seed: int = 0, block=None) -> dict:
    """One kernel at one (n, b) against the reference: a row with the
    maximum error, its tolerance and ``ok``."""
    in_spin, out_spin = 0, n - 1
    inputs = make_inputs(kind, n, b, seed)
    got = jax.device_get(run_kernel(kind, inputs, in_spin, out_spin,
                                    interpret, block))
    want = jax.device_get(reference(kind, inputs, in_spin, out_spin))
    if kind == "sym_grad":
        e_err = float(np.max(np.abs(got[0] - want[0])))
        g_err = float(np.max(np.abs(got[1] - want[1])) /
                      np.max(np.abs(want[1])))
        ok = e_err <= FID_TOL and g_err <= GRAD_RTOL
        row = dict(err_abs=e_err, tol_abs=FID_TOL, grad_rel=g_err,
                   tol_grad_rel=GRAD_RTOL)
    else:
        tol = AMP_TOL if kind == "sym_amp" else FID_TOL
        err = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
        ok = err <= tol
        row = dict(err_abs=err, tol_abs=tol)
    finite = bool(np.all([np.all(np.isfinite(x))
                          for x in jax.tree.leaves(got)]))
    return dict(kind=kind, n=n, b=b, ok=bool(ok and finite), **row)


def reference_rims(h0, ctrl, noises, key, bootreps: int, in_spin: int,
                   out_spin: int, c_global: int, c_offset: int = 0):
    """f64 RIM ((L, C): mean of 1 - F over the bootstrap reps) of the
    controller block ``ctrl`` on the host CPU, with the draws of the MC
    engine: element (l, c, b) folds the global lattice id
    ((l * c_global + c + c_offset) * bootreps + b) into ``key`` and
    draws its structured noise in float32 exactly as
    mc/engine._chunk_kernel_lanes does; the Hamiltonian is then solved
    with complex128 ``jnp.linalg.eigh``."""
    cpu = jax.devices("cpu")[0]
    ctrl = np.asarray(ctrl, np.float64)
    noises = np.asarray(noises, np.float32)
    num_l, num_c, n = len(noises), len(ctrl), ctrl.shape[1] - 1
    l_idx, c_idx, b_idx = (a.ravel() for a in np.meshgrid(
        np.arange(num_l), np.arange(num_c), np.arange(bootreps),
        indexing="ij"))
    gid = ((l_idx * c_global + c_idx + c_offset) * bootreps + b_idx
           ).astype(np.uint32)
    with jax.enable_x64(True), jax.default_device(cpu):
        keys = jax.vmap(jax.random.fold_in, (None, 0))(
            jax.device_put(key, cpu), jnp.asarray(gid))
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)

        def normal(k, m):
            return jax.vmap(lambda kk: jax.random.normal(
                kk, (m,), jnp.float32))(k)
        scale = jnp.asarray(noises[l_idx])[:, None]
        diag = np.asarray(normal(ks[:, 0], n) * scale, np.float64)
        re = np.asarray(normal(ks[:, 1], n - 1) * scale, np.float64)
        im = np.asarray(normal(ks[:, 2], n - 1) * scale, np.float64)
        x = ctrl[c_idx]
        h = np.broadcast_to(np.asarray(h0, np.float64),
                            (len(gid), n, n)).astype(complex)
        idx = np.arange(n)
        h[:, idx, idx] += diag + x[:, :n]
        h[:, idx[1:], idx[:-1]] += re + 1j * im
        h[:, idx[:-1], idx[1:]] += re - 1j * im
        lam, v = jnp.linalg.eigh(jnp.asarray(h))
        t = jnp.abs(jnp.asarray(x[:, n]))
        amp = jnp.einsum("ek,ek,ek->e", v[:, out_spin, :],
                         jnp.conj(v[:, in_spin, :]),
                         jnp.exp(-1j * lam * t[:, None]))
        fid = np.asarray(jnp.abs(amp) ** 2)
    return (1.0 - fid).reshape(num_l, num_c, bootreps).mean(axis=-1)
