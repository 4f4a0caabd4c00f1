"""The Monte-Carlo robustness sweep as ONE jitted device program.

Reference behavior being replaced: MCDataSim.get_algo_fid_dist
(mcsim.py:422-460) runs a Python triple loop (noise level x controller x
bootstrap rep), calling scipy expm once per iteration — ~1.1e6 sequential
expm calls per figure, with multiprocessing.Pool over bootreps as the only
(disabled, "slow, TODO fix") parallelism.

Design: the full (L, C, B) lattice is a single `vmap` program over one
pure element kernel

    fid[l, c, b] = |<out| exp(-i T_c (H0 + Z(key_lcb, sigma_l) + diag(x_c)))
                    |in>|^2

evaluated with the eigenbasis propagator.  The lattice is processed in
fixed-size chunks through `lax.map` (so device memory holds one chunk of
(n, n) matrices at a time regardless of lattice size), and the chunk axis
shards across a device mesh in code_robchar_tpu.parallel.  Metric tensors
are computed on-device as batched trailing-axis reductions (metrics/rim.py)
— the .mcm triple loop (mcsim.py:487-498) becomes three fused reductions.
The eigensolver of a chunk is picked by ops/select.py: the Pallas Jacobi
kernel on the GPU, the XLA lanes path on the CPU.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from code_robchar_tpu.metrics.rim import (
    wd_from_ideal, wd_from_ideal_zero, compute_dkw_error)
from code_robchar_tpu.metrics.stats import metric_registry
from code_robchar_tpu.ops import realform, select
from code_robchar_tpu.ops.noise import (structured_perturbation,
                                        structured_perturbation_parts)
from code_robchar_tpu.ops.propagate import fidelity_from_controller

#: lattice elements per lax.map step, by the kernel ops/select.py picks:
#: on the GPU the best of the chunk sweep in PERF.md (PR 1); on the CPU
#: small steps bound the lanes path's (n, n, chunk) intermediates
DEFAULT_CHUNK = {"triton": 262144, "xla": 8192}


def _resolve_chunk(chunk) -> int:
    return DEFAULT_CHUNK[select.jacobi_kernel()] if chunk is None else chunk


def _resolve_pallas(use_pallas) -> bool:
    return select.use_pallas() if use_pallas is None else use_pallas


def _element_kernel(h0r, x, scale, key, in_spin, out_spin, complex_offdiag,
                    use_jacobi):
    """One lattice element on the library-eigensolver path: reconstructs
    the complex Hermitian and uses jnp.linalg.eigh (LAPACK on the CPU,
    cuSOLVER's batched solver on the GPU)."""
    n = h0r.shape[-1]
    h0c = h0r.astype(jnp.complex128 if h0r.dtype == jnp.float64
                     else jnp.complex64)
    z = structured_perturbation(key, n, scale,
                                complex_offdiag=complex_offdiag,
                                dtype=h0c.dtype)
    return fidelity_from_controller(h0c + z, x, in_spin, out_spin)


def _chunk_kernel_lanes(h0r, xs, scales, keys, in_spin, out_spin,
                        complex_offdiag, use_pallas=False):
    """One chunk in the batch-in-lanes layout (ops/realform.py): the
    perturbed Hamiltonians are assembled DIRECTLY as (n, n, B) tiles —
    diagonal noise + controller biases on the diagonal lanes, symmetric
    real / antisymmetric imaginary nearest-neighbour couplings — and
    diagonalised by the Pallas kernel or the XLA lanes Jacobi.

    Draw parity: the per-element key split/order matches
    structured_perturbation_parts exactly (pinned in tests/test_mc.py via
    the scipy cross-check).
    """
    n = h0r.shape[-1]
    b = xs.shape[0]
    dt = h0r.dtype

    ks = jax.vmap(lambda k: jax.random.split(k, 3))(keys)   # (B, 3)
    diag = jax.vmap(lambda k: jax.random.normal(k, (n,), dt))(ks[:, 0])
    nn = jax.vmap(lambda k: jax.random.normal(k, (n - 1,), dt))(ks[:, 1])
    diag = diag * scales[:, None]
    nn = nn * scales[:, None]

    ar = jnp.zeros((n, n, b), dt) + h0r[:, :, None]
    for i in range(n):
        ar = ar.at[i, i].add(diag[:, i] + xs[:, i])
    for i in range(1, n):
        ar = ar.at[i, i - 1].add(nn[:, i - 1])
        ar = ar.at[i - 1, i].add(nn[:, i - 1])

    ai = jnp.zeros((n, n, b), dt)
    if complex_offdiag:
        nn2 = jax.vmap(lambda k: jax.random.normal(k, (n - 1,), dt))(
            ks[:, 2]) * scales[:, None]
        for i in range(1, n):
            ai = ai.at[i, i - 1].add(nn2[:, i - 1])
            ai = ai.at[i - 1, i].add(-nn2[:, i - 1])

    t = jnp.abs(xs[:, n])
    if use_pallas:
        from code_robchar_tpu.ops.pallas_jacobi import fidelity_herm_pallas
        return fidelity_herm_pallas(ar, ai, t, in_spin, out_spin)
    return realform.fidelity_herm_lanes(ar, ai, t, in_spin, out_spin)


def _sweep_core(h0, ctrl, noises, key, bootreps, in_spin, out_spin,
                complex_offdiag, chunk, use_jacobi,
                c_offset, c_global, use_pallas=False) -> jnp.ndarray:
    """Sweep a (local) controller block.

    Per-element PRNG keys are derived by folding the *global* flat lattice
    id (layout (L, C_global, B)) into ``key``, so a sharded execution over
    controller blocks reproduces the unsharded sweep bit-for-bit.
    """
    num_l = noises.shape[0]
    num_c = ctrl.shape[0]
    total = num_l * num_c * bootreps
    h0r = jnp.real(h0) if jnp.iscomplexobj(h0) else h0

    chunk = min(chunk, total)
    padded = -(-total // chunk) * chunk
    ids = jnp.arange(padded, dtype=jnp.uint32) % total  # pad wraps around
    l_idx = ids // (num_c * bootreps)
    c_idx = (ids // bootreps) % num_c
    b_idx = ids % bootreps
    gids = ((l_idx * c_global + c_idx + c_offset) * bootreps + b_idx
            ).astype(jnp.uint32)

    if use_jacobi:
        def do_chunk(args):
            lid, cid, gid = args
            keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, gid)
            return _chunk_kernel_lanes(h0r, ctrl[cid], noises[lid], keys,
                                       in_spin, out_spin, complex_offdiag,
                                       use_pallas)
    else:
        def elem(args):
            lid, cid, gid = args
            k = jax.random.fold_in(key, gid)
            return _element_kernel(h0r, ctrl[cid], noises[lid], k, in_spin,
                                   out_spin, complex_offdiag, use_jacobi)

        def do_chunk(args):
            return jax.vmap(elem)(args)

    args = (l_idx.reshape(-1, chunk), c_idx.reshape(-1, chunk),
            gids.reshape(-1, chunk))
    fids = jax.lax.map(do_chunk, args).reshape(-1)[:total]
    return fids.reshape(num_l, num_c, bootreps)


def _metrics_core(h0, ctrl, noises, key, bootreps, in_spin, out_spin,
                  complex_offdiag, chunk, use_jacobi, c_offset, c_global,
                  use_pallas, alpha) -> Dict[str, jnp.ndarray]:
    """Fused sweep + metric reduction: never materialises the (L, C, B)
    tensor (the .mcm fast path, mcsim.py:463-510 semantics unchanged).

    Because the lattice layout puts the bootstrap axis fastest, a chunk
    whose element count is a multiple of ``bootreps`` holds only WHOLE
    (noise, controller) cells — so each lax.map step computes fidelities
    for its cells and immediately reduces them to the five-metric x
    three-band stack on a complete (cells_per_chunk, B) slice.  Identical
    draws and key derivation to _sweep_core (same global flat ids):
    fidelities are bitwise equal to the unfused sweep's, and the metric
    tensors agree with metric_tensors(mc_fidelity_sweep(...)) to reduction
    reassociation rounding (<=1e-14; XLA may vectorise the B-axis mean
    differently inside lax.map) — pinned in tests/test_mc.py."""
    num_l = noises.shape[0]
    num_c = ctrl.shape[0]
    cells = num_l * num_c
    h0r = jnp.real(h0) if jnp.iscomplexobj(h0) else h0

    cc = max(1, min(chunk // bootreps, cells))   # whole cells per step
    padded = -(-cells // cc) * cc
    cell_ids = jnp.arange(padded, dtype=jnp.uint32) % cells  # pad wraps
    l_idx = cell_ids // num_c
    c_idx = cell_ids % num_c
    brange = jnp.arange(bootreps, dtype=jnp.uint32)

    def do_chunk(args):
        lid, cid = args                                     # (cc,)
        gid = ((lid * c_global + cid + c_offset)[:, None] * bootreps
               + brange[None, :]).reshape(-1)               # (cc*B,)
        keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, gid)
        xs = jnp.repeat(ctrl[cid], bootreps, axis=0)
        scales = jnp.repeat(noises[lid], bootreps)
        if use_jacobi:
            fids = _chunk_kernel_lanes(h0r, xs, scales, keys, in_spin,
                                       out_spin, complex_offdiag,
                                       use_pallas)
        else:
            fids = jax.vmap(
                lambda x, s, k: _element_kernel(h0r, x, s, k, in_spin,
                                                out_spin, complex_offdiag,
                                                use_jacobi)
            )(xs, scales, keys)
        return metric_tensors(fids.reshape(cc, bootreps), alpha)

    out = jax.lax.map(do_chunk, (l_idx.reshape(-1, cc),
                                 c_idx.reshape(-1, cc)))
    return {k: v.reshape(-1)[:cells].reshape(num_l, num_c)
            for k, v in out.items()}


@partial(jax.jit,
         static_argnames=("bootreps", "in_spin", "out_spin",
                          "complex_offdiag", "chunk", "use_jacobi",
                          "use_pallas", "alpha"))
def mc_metric_sweep(h0: jnp.ndarray, controllers: jnp.ndarray,
                    noises: jnp.ndarray, key: jax.Array, bootreps: int,
                    in_spin: int, out_spin: int,
                    complex_offdiag: bool = True,
                    chunk: Optional[int] = None,
                    use_jacobi: bool = True,
                    use_pallas: Optional[bool] = None,
                    alpha: float = 0.05) -> Dict[str, jnp.ndarray]:
    """Metric tensors (5 metrics x 3 DKW bands, each (L, C)) computed with
    the metric reduction fused into the sweep — same draws as
    ``metric_tensors(mc_fidelity_sweep(...), alpha)`` (values agree to
    reduction rounding), without ever holding the (L, C, B) fidelity
    tensor in device memory.  ``chunk=None`` takes the platform's
    DEFAULT_CHUNK; ``use_pallas=None`` asks ops/select.py."""
    return _metrics_core(h0, controllers, noises, key, bootreps, in_spin,
                         out_spin, complex_offdiag, _resolve_chunk(chunk),
                         use_jacobi, jnp.uint32(0), controllers.shape[0],
                         _resolve_pallas(use_pallas), alpha)


@partial(jax.jit,
         static_argnames=("bootreps", "in_spin", "out_spin",
                          "complex_offdiag", "chunk", "use_jacobi",
                          "use_pallas"))
def mc_fidelity_sweep(h0: jnp.ndarray, controllers: jnp.ndarray,
                      noises: jnp.ndarray, key: jax.Array, bootreps: int,
                      in_spin: int, out_spin: int,
                      complex_offdiag: bool = True,
                      chunk: Optional[int] = None,
                      use_jacobi: bool = True,
                      use_pallas: Optional[bool] = None) -> jnp.ndarray:
    """Fidelity-distribution tensor of shape (L, C, B).

    h0: (n, n) drift Hamiltonian; controllers: (C, n+1); noises: (L,).
    ``complex_offdiag=True`` is the MC-characterisation noise variant
    (noise_model.py:139-146); the sweep at noise level l uses
    sigma = noises[l] for every draw (mcsim.py:425).
    """
    return _sweep_core(h0, controllers, noises, key, bootreps, in_spin,
                       out_spin, complex_offdiag, _resolve_chunk(chunk),
                       use_jacobi, jnp.uint32(0), controllers.shape[0],
                       _resolve_pallas(use_pallas))


@partial(jax.jit, static_argnames=("alpha",))
def metric_tensors(fids: jnp.ndarray, alpha: float = 0.05
                   ) -> Dict[str, jnp.ndarray]:
    """All five metrics x {center, upper, lower} as (L, C) tensors.

    Key-name contract matches the .mcm schema (mcsim.py:487-498), including
    the reference's deliberate band-naming inversion: the "upper" tensor is
    computed from fids - dkw and "lower" from fids + dkw, because the ideal
    sits at fidelity 1 (mcsim.py:483-485).

    Performance: the RIM is computed through the exact identity
    W1(F, delta_1) = E[1 - F] for F in [0, 1] (the reference's own test
    suite asserts wd_from_ideal == RIM_1; see metrics/rim.py) — so no
    metric here needs a sort and the whole tensor is a few fused
    reductions over the bootstrap axis.
    """
    eps = compute_dkw_error(alpha, fids.shape[-1])
    shifted_lower = jnp.clip(fids + eps, 0.0, 1.0)
    shifted_upper = jnp.clip(fids - eps, 0.0, 1.0)

    def rim_sortless(f):
        return jnp.mean(1.0 - f, axis=-1)

    registry = dict(metric_registry)
    registry[r"$W(.,\delta(x-1))$"] = rim_sortless
    out = {}
    for name, fn in registry.items():
        out[name] = fn(fids)
        out[name + " upper"] = fn(shifted_upper)
        out[name + " lower"] = fn(shifted_lower)
    return out


def characterise(h0, controllers, noises, key, bootreps: int, in_spin: int,
                 out_spin: int, *, alpha: float = 0.05,
                 complex_offdiag: bool = True, chunk: Optional[int] = None,
                 use_pallas: Optional[bool] = None, mesh=None,
                 return_fids: bool = True) -> Dict[str, jnp.ndarray]:
    """One-call robustness characterisation: fidelity sweep + the full
    five-metric x three-band tensor dict, optionally sharded over a device
    mesh (controller axis).

    ``use_pallas=None`` asks ops/select.py: the Pallas kernel on the GPU,
    the XLA lanes path on the CPU.  ``return_fids=False`` takes the fused
    sweep+reduce path (mc_metric_sweep): identical metric values, but the
    (L, C, B) fidelity tensor is never materialised — use it whenever the
    .mc cache isn't needed.
    """
    use_pallas = _resolve_pallas(use_pallas)
    controllers = jnp.asarray(controllers)
    if not return_fids:
        if mesh is not None:
            from code_robchar_tpu.parallel.mesh import sharded_mc_metrics
            return dict(sharded_mc_metrics(
                mesh, h0, controllers, noises, key, bootreps, in_spin,
                out_spin, complex_offdiag=complex_offdiag, chunk=chunk,
                use_pallas=use_pallas, alpha=alpha))
        return dict(mc_metric_sweep(
            h0, controllers, noises, key, bootreps, in_spin, out_spin,
            complex_offdiag=complex_offdiag, chunk=chunk,
            use_pallas=use_pallas, alpha=alpha))
    if mesh is not None:
        from code_robchar_tpu.parallel.mesh import sharded_mc_sweep
        fids = sharded_mc_sweep(mesh, h0, controllers, noises, key,
                                bootreps, in_spin, out_spin,
                                complex_offdiag=complex_offdiag,
                                chunk=chunk, use_pallas=use_pallas)
    else:
        fids = mc_fidelity_sweep(h0, controllers, noises, key, bootreps,
                                 in_spin, out_spin,
                                 complex_offdiag=complex_offdiag,
                                 chunk=chunk, use_pallas=use_pallas)
    out = dict(metric_tensors(fids, alpha))
    out["fids"] = fids
    return out


def arim_from_rims(rims: jnp.ndarray) -> jnp.ndarray:
    """Algorithm-level RIM: Wasserstein distance of the trailing-axis RIM
    sample (over controllers) from delta(x-0), i.e.
    wd_from_ideal_zero(RIMs) (generate_arim_all_fig5.py:119,166)."""
    return wd_from_ideal_zero(jnp.clip(rims, 0.0, 1.0))


def bootstrap_statistic_std(key: jax.Array, sample: jnp.ndarray,
                            statistic, bootsamples: int = 100) -> jnp.ndarray:
    """Nonparametric bootstrap std of a trailing-axis statistic
    (mcsim.py:267-275 ``bootstrap_resampling_std``), vectorised: all
    ``bootsamples`` resamples evaluate in one vmap."""
    n = sample.shape[-1]
    idx = jax.random.randint(key, (bootsamples, n), 0, n)
    stats = jax.vmap(lambda i: statistic(jnp.take(sample, i, axis=-1)))(idx)
    return jnp.std(stats, axis=0)
