"""Spin-chain Hamiltonian assembly.

Covers the L0 physics-assembly capability of the reference
(qnewton.py:140-159 ``sys_hamiltonian``/``controls``,
RLreinforceXXchain_actionedtime.py:82-103 ``system_hamiltonian``,
noise_model.py:79-95) as pure functions of static configuration.

The single-excitation XX chain of length ``n`` has nearest-neighbour
couplings 1; a ``ring`` topology closes the chain; the optional XXZ
("heisenberg") interaction adds the diagonal
``t = 0.5*sum(triu(H))*ones - row_sums(H)`` (qnewton.py:148-150 — note
README.md:6 of the reference: the paper does *not* enable it).

Controls are diagonal projectors ``C_k = e_k e_k^T`` (qnewton.py:153-159);
because they are diagonal we never materialise them — adding a bias vector
``x`` to a Hamiltonian is ``H + diag(x)``.  ``add_bias`` states that
contract as a callable; the hot paths (ops/propagate.py, ops/realform.py,
models/base.py) inline the same expression in their own batch layouts
rather than calling it, so a change to bias-add semantics must be applied
at those sites too.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from code_robchar_tpu import config


def xx_hamiltonian(n: int, topo: str = "chain", heisenberg: bool = False,
                   dtype=None) -> jnp.ndarray:
    """Drift Hamiltonian of the length-``n`` XX chain.

    ``topo`` is "chain"/"linear" (open chain) or "ring" (periodic).
    ``heisenberg=True`` adds the XXZ diagonal (see module docstring).
    Built host-side with numpy (static config), returned as a JAX array.
    """
    if dtype is None:
        dtype = config.complex_dtype()
    h = np.zeros((n, n), dtype=np.complex128)
    for l in range(1, n):
        h[l - 1, l] = 1.0
        h[l, l - 1] = 1.0
    if topo == "ring":
        h[n - 1, 0] = 1.0
        h[0, n - 1] = 1.0
    elif topo not in ("chain", "linear"):
        raise ValueError(f"unknown topology {topo!r}; use 'chain' or 'ring'")
    if heisenberg:
        t = 0.5 * np.triu(h).sum().real * np.ones(n) - np.sum(h, axis=1).real
        h = h + np.diag(t)
    # real dtypes are first-class: the XX/XXZ drift is real symmetric —
    # pass e.g. jnp.float32 to get the split-real production form
    # (ops/realform.py).
    if not np.issubdtype(np.dtype(dtype), np.complexfloating):
        return jnp.asarray(h.real, dtype=dtype)
    return jnp.asarray(h, dtype=dtype)


def xx_hamiltonian_real(n: int, topo: str = "chain",
                        heisenberg: bool = False, dtype=None) -> jnp.ndarray:
    """Real-symmetric drift for the production (split-real) path."""
    if dtype is None:
        dtype = config.real_dtype()
    return xx_hamiltonian(n, topo=topo, heisenberg=heisenberg, dtype=dtype)


def basis_state(n: int, k: int, dtype=None) -> jnp.ndarray:
    """Single-excitation basis vector |k> (RLreinforce...:105-108)."""
    if dtype is None:
        dtype = config.complex_dtype()
    psi = np.zeros(n)
    psi[k] = 1.0
    return jnp.asarray(psi, dtype=dtype)


def control_projectors(n: int, dtype=None) -> jnp.ndarray:
    """Stacked diagonal projectors C[k] = e_k e_k^T, shape (n, n, n).

    Provided for API parity with the reference's ``controls()``
    (qnewton.py:153-159); the compute path never materialises the
    projectors — it inlines the equivalent diag-add (``add_bias`` states
    the contract).
    """
    if dtype is None:
        dtype = config.complex_dtype()
    eye = np.eye(n)
    cc = np.einsum("ki,kj->kij", eye, eye)
    return jnp.asarray(cc, dtype=dtype)


def add_bias(h: jnp.ndarray, biases: jnp.ndarray) -> jnp.ndarray:
    """H + sum_l x_l C_l  ==  H + diag(x)  (qnewton.py:177-179).

    API-parity/specification helper: the hot paths inline this
    expression in their own batch layouts (module docstring)."""
    n = h.shape[-1]
    return h + jnp.eye(n, dtype=h.dtype) * biases[..., None, :].astype(h.dtype)
