"""PRNG-key-threaded noise models and shot-noise protocols.

Covers the L1 layer of the reference (noise_model.py:21-201 plus the inlined
copies at qnewton.py:340-379 and RLreinforce...:122-133) and the shot-noise /
adaptive estimation protocols (qnewton.py:402-423, RLreinforce...:206-226).

The reference keeps THREE diverging copies of ``structured_perturbation``:
the MC-characterisation one makes nearest-neighbour couplings complex
(noise_model.py:139-146) while the two training-side copies are real
(qnewton.py:369-379, RLreinforce...:122-133).  mcsim characterises with the
complex variant; optimizers train with the real one.  That asymmetry is part
of the published results, so it is preserved here explicitly via the
``complex_offdiag`` flag (SURVEY.md §5 quirk 7) instead of by code
duplication.

RNG contract: the reference uses the *global* numpy RNG (and clobbers it
with np.random.seed(4) mid-run, SURVEY.md quirk 6), so bitwise draw parity is
impossible by construction.  Here every draw is a pure function of an
explicit `jax.random` key; determinism is per-key and reproducible across
hosts/devices.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from code_robchar_tpu import config


def structured_perturbation(key: jax.Array, n: int, scale: jnp.ndarray,
                            complex_offdiag: bool = True,
                            dtype=None) -> jnp.ndarray:
    """Structured Gaussian perturbation of an XX-chain Hamiltonian.

    z[i,i] ~ N(0, scale); nearest-neighbour couplings get a symmetric real
    part nn ~ N(0, scale) and, when ``complex_offdiag``, an antisymmetric
    imaginary part nn2 ~ N(0, scale) (z[i,i-1] = nn + i nn2,
    z[i-1,i] = nn - i nn2) — the Hermitian complex variant of
    noise_model.py:135-147.  With ``complex_offdiag=False`` this is the real
    training-side variant (qnewton.py:366-379).  Next-nearest-neighbour terms
    are identically zero in the reference (noise_model.py:139-140) and are
    omitted.

    ``scale`` may be a traced scalar — noise level sweeps stay inside jit.
    Batched draws: vmap over ``key``.
    """
    if dtype is None:
        dtype = config.complex_dtype()
    rdt = jnp.zeros((), dtype).real.dtype
    kd, kn, k2 = jax.random.split(key, 3)
    scale = jnp.asarray(scale, rdt)
    diag = jax.random.normal(kd, (n,), rdt) * scale
    nn = jax.random.normal(kn, (n - 1,), rdt) * scale
    z = jnp.zeros((n, n), dtype)
    z = z + jnp.diag(diag).astype(dtype)
    if complex_offdiag:
        nn2 = jax.random.normal(k2, (n - 1,), rdt) * scale
        off = (nn + 1j * nn2).astype(dtype)
        z = z + jnp.diag(off, k=-1) + jnp.diag(off.conj(), k=1)
    else:
        off = nn.astype(dtype)
        z = z + jnp.diag(off, k=-1) + jnp.diag(off, k=1)
    return z


def structured_perturbation_parts(key: jax.Array, n: int, scale: jnp.ndarray,
                                  complex_offdiag: bool = True, dtype=None):
    """Split-real form of ``structured_perturbation``: returns (zr, zi)
    with zr symmetric (diag + nn real couplings) and zi antisymmetric
    (+nn2 at (i, i-1), -nn2 at (i-1, i) — the imaginary part of the
    Hermitian complex variant).  Same per-key draws as the complex form:
    folding the same key yields z == zr + 1j*zi (pinned in tests).

    This is the production path — no complex dtype is ever formed.
    """
    if dtype is None:
        dtype = jnp.zeros((), config.complex_dtype()).real.dtype
    kd, kn, k2 = jax.random.split(key, 3)
    scale = jnp.asarray(scale, dtype)
    diag = jax.random.normal(kd, (n,), dtype) * scale
    nn = jax.random.normal(kn, (n - 1,), dtype) * scale
    zr = jnp.zeros((n, n), dtype) + jnp.diag(diag) \
        + jnp.diag(nn, k=-1) + jnp.diag(nn, k=1)
    if complex_offdiag:
        nn2 = jax.random.normal(k2, (n - 1,), dtype) * scale
        zi = jnp.diag(nn2, k=-1) - jnp.diag(nn2, k=1)
    else:
        zi = jnp.zeros((n, n), dtype)
    return zr, zi


def _direction_table(n: int) -> jnp.ndarray:
    """Hermitian-pair index table of directional_perturbation
    (noise_model.py:155-163): corners, the tridiagonal band of interior
    sites, and the explicit boundary off-diagonal pairs."""
    dirs = [(0, 0), (n - 1, n - 1)]
    for d in range(1, n - 1):
        for o in (-1, 0, 1):
            dirs.append((d, d + o))
    dirs += [(0, 1), (1, 0), (n - 2, n - 1), (n - 1, n - 2)]
    return jnp.asarray(dirs, jnp.int32)


def directional_perturbation(key: jax.Array, n: int, scale: jnp.ndarray,
                             dtype=None) -> jnp.ndarray:
    """Perturb one randomly-chosen Hermitian pair (noise_model.py:165-201):
    z[p] = a + i b, z[p^T] = a - i b with a, b ~ N(0, scale)."""
    if dtype is None:
        dtype = config.complex_dtype()
    rdt = jnp.zeros((), dtype).real.dtype
    table = _direction_table(n)
    ki, kv = jax.random.split(key)
    idx = jax.random.randint(ki, (), 0, table.shape[0])
    ij = table[idx]
    ab = jax.random.normal(kv, (2,), rdt) * jnp.asarray(scale, rdt)
    val = (ab[0] + 1j * ab[1]).astype(dtype)
    z = jnp.zeros((n, n), dtype)
    z = z.at[ij[0], ij[1]].add(val)
    z = z.at[ij[1], ij[0]].add(val.conj())
    # diagonal picks (i == j) must stay real: the two .add calls above put
    # val + conj(val) = 2 Re(val) there, but the reference assigns val then
    # conj(val) (last write wins -> conj). Match the reference: overwrite.
    on_diag = ij[0] == ij[1]
    z = jnp.where(on_diag,
                  jnp.zeros((n, n), dtype).at[ij[0], ij[1]].set(val.conj()),
                  z)
    return z


def shot_noise_fidelity(key: jax.Array, fid: jnp.ndarray,
                        draws: int) -> jnp.ndarray:
    """Finite-measurement fidelity: Binomial(draws, fid)/draws
    (qnewton.py:407, RLreinforce...:209-211)."""
    fid = jnp.clip(fid, 0.0, 1.0)
    sample = jax.random.binomial(key, draws, fid)
    return sample.astype(fid.dtype) / draws


@partial(jax.jit, static_argnames=("draws",))
def adaptive_shot_fidelity(key: jax.Array, fid: jnp.ndarray, draws: int,
                           adp_tol: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Adaptive Bayesian shot protocol (qnewton.py:410-423).

    Beta posterior from a Jeffreys prior (a=b=0.5); keep sampling batches of
    ``draws`` Binomial shots until the posterior std of the reference's
    (biased) running mean estimate ``(a+s)/(a+b+draws)`` drops below
    ``adp_tol``.  Returns (estimate, extra_function_calls) where the call
    accounting matches ``adp_func_calls_increment`` += draws per batch.
    Implemented as a `lax.while_loop` so it jits and vmaps.
    """
    fid = jnp.clip(fid, 0.0, 1.0)
    rdt = fid.dtype

    def cond(state):
        _, _, _, var, _, _ = state
        return jnp.sqrt(var) > adp_tol

    def body(state):
        a, b, mean, var, calls, k = state
        k, ks = jax.random.split(k)
        s = jax.random.binomial(ks, draws, fid).astype(rdt)
        a = a + s
        b = b + (draws - s)
        mean = (a + s) / (a + b + draws)
        var = mean * (1.0 - mean) / (a + b + draws + 1.0)
        return a, b, mean, var, calls + draws, k

    a0 = jnp.asarray(0.5, rdt)
    b0 = jnp.asarray(0.5, rdt)
    mean0 = a0 / (a0 + b0)
    var0 = mean0 * (1.0 - mean0) / (a0 + b0 + 1.0)
    state = (a0, b0, mean0, var0, jnp.asarray(0, jnp.int32), key)
    _, _, mean, _, calls, _ = jax.lax.while_loop(cond, body, state)
    return mean, calls


def fixed_hamiltonian_ensemble(key: jax.Array, h0: jnp.ndarray,
                               scale: float, train_size: int = 100,
                               test_size: int = 10000,
                               complex_offdiag: bool = False
                               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pre-drawn perturbed-Hamiltonian train/test sets for the
    "non-stochastic" fixed-ensemble objective (qnewton.py:122-137,
    RLreinforce...:58-73; real-offdiag noise there, hence the default).

    The reference hard-seeds numpy's global RNG with seed 4; here the seed
    contract is the explicit ``key`` (pass jax.random.key(4) for the
    documented default stream).
    """
    n = h0.shape[-1]
    k1, k2 = jax.random.split(key)

    def draw(k):
        return h0 + structured_perturbation(k, n, scale,
                                            complex_offdiag=complex_offdiag,
                                            dtype=h0.dtype)

    train = jax.vmap(draw)(jax.random.split(k1, train_size))
    test = jax.vmap(draw)(jax.random.split(k2, test_size))
    return train, test
