"""Mesh construction and sharded batch execution.

The reference's only parallelism is a default-off multiprocessing.Pool over
bootstrap reps (mcsim.py:452-455; commented-out MPI hooks in ppo.py are the
other fossil, SURVEY.md §2.4).  Here: a 1-D device mesh over the
embarrassingly-parallel batch axis ("batch" = controllers for the MC
engine, restarts for optimizers, environments for PPO).  Inputs are laid
out with `jax.device_put` + NamedSharding and every multi-device program
runs under `jax.shard_map` (manual axes): each device runs the same
single-device program, Pallas kernels included, on its block.  The batch
axes are embarrassingly parallel, so the programs carry at most a gather
of the (L, C) metric reductions.  The cards of one host reach each other
all to all over NVLink, so the mesh follows the algorithm alone and stays
1-D.

``make_mesh(4)`` spans four cards; the same code path runs on the
8-virtual-device CPU mesh in tests (tests/test_parallel.py) and in
__graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from code_robchar_tpu.mc import engine

BATCH_AXIS = "batch"


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (BATCH_AXIS,))


def shard_batch(mesh: Mesh, x: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Place ``x`` with its ``axis`` dimension split across the mesh."""
    spec = [None] * x.ndim
    spec[axis] = BATCH_AXIS
    return jax.device_put(x, NamedSharding(mesh, P(*spec)))


def shard_leading_tree(mesh: Mesh, tree, batch_size: int):
    """device_put every array leaf whose leading dimension equals
    ``batch_size`` with that axis split across the mesh (other leaves are
    left as-is).  This is how the agent/stream batch of a whole optimizer
    state pytree (PPO AgentState, Adam stream) is laid out before feeding
    the shard_map-wrapped epoch/segment programs: placing the leaves on
    their owning devices up front avoids an implicit reshard on the first
    dispatch."""
    def put(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == batch_size:
            spec = P(BATCH_AXIS, *([None] * (x.ndim - 1)))
            return jax.device_put(x, NamedSharding(mesh, spec))
        return x
    return jax.tree.map(put, tree)


def check_divisible(mesh: Mesh, k: int, what: str = "batch") -> int:
    n_dev = mesh.devices.size
    if k % n_dev:
        raise ValueError(f"{what} count {k} must be a multiple of the "
                         f"mesh size {n_dev}")
    return n_dev


def sharded_mc_sweep(mesh: Mesh, h0, controllers, noises, key, bootreps: int,
                     in_spin: int, out_spin: int, *,
                     complex_offdiag: bool = True,
                     use_jacobi: bool = True,
                     use_pallas: Optional[bool] = None,
                     chunk=None) -> jnp.ndarray:
    """(L, C, B) fidelity tensor with the controller axis sharded.

    shard_map over the controller axis: each device sweeps its block with
    per-element keys folded from the *global* lattice id, so the result is
    bit-identical to the unsharded sweep (tests/test_parallel.py pins this).
    The output stays sharded along C for on-device metric reduction.
    """
    shard_map = jax.shard_map

    controllers = jnp.asarray(controllers)
    c_global = controllers.shape[0]
    n_dev = check_divisible(mesh, c_global, "controller")
    c_local = c_global // n_dev
    use_pallas = engine._resolve_pallas(use_pallas)
    local_chunk = min(engine._resolve_chunk(chunk),
                      noises.shape[0] * c_local * bootreps)

    def local_sweep(ctrl_block):
        dev = jax.lax.axis_index(BATCH_AXIS)
        offset = (dev * c_local).astype(jnp.uint32)
        return engine._sweep_core(
            h0, ctrl_block, noises, key, bootreps, in_spin, out_spin,
            complex_offdiag, local_chunk, use_jacobi, offset, c_global,
            use_pallas)

    # check_vma off: a pallas_call's outputs carry no varying-axes type
    # (see build_sharded_batch_fn); the sweep is elementwise along C
    fn = shard_map(local_sweep, mesh=mesh,
                   in_specs=P(BATCH_AXIS, None),
                   out_specs=P(None, BATCH_AXIS, None), check_vma=False)
    ctrl = shard_batch(mesh, controllers, axis=0)
    return jax.jit(fn)(ctrl)


def sharded_mc_metrics(mesh: Mesh, h0, controllers, noises, key,
                       bootreps: int, in_spin: int, out_spin: int, *,
                       complex_offdiag: bool = True,
                       use_pallas: Optional[bool] = None,
                       chunk=None,
                       alpha: float = 0.05):
    """Fused sweep+metric reduction with the controller axis sharded.

    Each device runs engine._metrics_core on its controller block (global
    lattice ids -> bit-identical draws to the unsharded fused sweep) and
    the (L, C_local) metric tensors stay sharded along C.  The (L, C, B)
    fidelity tensor never exists, on any device."""
    shard_map = jax.shard_map

    controllers = jnp.asarray(controllers)
    c_global = controllers.shape[0]
    n_dev = check_divisible(mesh, c_global, "controller")
    c_local = c_global // n_dev
    use_pallas = engine._resolve_pallas(use_pallas)
    local_chunk = min(engine._resolve_chunk(chunk),
                      noises.shape[0] * c_local * bootreps)

    def local_metrics(ctrl_block):
        dev = jax.lax.axis_index(BATCH_AXIS)
        offset = (dev * c_local).astype(jnp.uint32)
        return engine._metrics_core(
            h0, ctrl_block, noises, key, bootreps, in_spin, out_spin,
            complex_offdiag, local_chunk, True, offset, c_global,
            use_pallas, alpha)

    names = [k for base in engine.metric_registry
             for k in (base, base + " upper", base + " lower")]
    fn = shard_map(local_metrics, mesh=mesh,
                   in_specs=P(BATCH_AXIS, None),
                   out_specs={k: P(None, BATCH_AXIS) for k in names},
                   check_vma=False)
    ctrl = shard_batch(mesh, controllers, axis=0)
    return jax.jit(fn)(ctrl)


def build_sharded_batch_fn(mesh: Mesh, opt):
    """shard_map wrapper over a FRESH copy of ``opt``'s batched restart
    program: ``fn(x0s, keys, noise[, fixed]) -> BatchResult`` with the
    restart axis split over the mesh and the noise level / fixed-ham
    ensemble replicated operands (so, like the plain programs, one
    compile serves every sigma cell).

    Manual axes (shard_map) rather than GSPMD auto-partitioning because
    the production batch programs contain Pallas kernels, which GSPMD
    cannot partition.  Under shard_map each device lowers and runs the
    identical single-device program (Pallas kernels included) on its
    block; restarts are embarrassingly parallel, so there are no
    collectives.  Lane freezing/recycling is device-local: a device
    whose block converges early stops iterating without waiting.

    The inner program MUST be a fresh ``_build_batch_fn()`` product, not
    the shared _PROGRAM_CACHE entry: tracing a cached jitted program
    inside shard_map poisons its trace cache for later plain calls (the
    manual-axes trace collides with the same-shape plain entry).
    Callers cache the returned wrapper instead
    (base.ControlOptimizer._run_batch_sharded).

    Determinism: a sharded run is deterministic given (mesh, inputs) —
    two identical calls are bitwise equal.  It is NOT bitwise equal to
    the unsharded batch: XLA emits position-dependent SIMD/FMA variants
    along the lane axis, so re-blocking shifts restarts by a few ulp,
    which optimizer accept/reject boundaries then amplify (measured:
    identical trajectories for alignment-preserved lanes, 1e-13..1e-7
    drift otherwise — the same thing that happens re-running scipy on a
    differently-compiled BLAS).  Each restart remains a valid
    trajectory of the same optimizer; results are statistically
    equivalent.
    """
    raw = opt._build_batch_fn()

    if opt.use_fixed_ham:
        def local_run(x0s_blk, keys_blk, noise, fixed):
            return raw(x0s_blk, keys_blk, noise, fixed)
        in_specs = (P(BATCH_AXIS), P(BATCH_AXIS), P(), P())
    else:
        def local_run(x0s_blk, keys_blk, noise):
            return raw(x0s_blk, keys_blk, noise)
        in_specs = (P(BATCH_AXIS), P(BATCH_AXIS), P())

    # check_vma off: the optimizer kernels init loop carries from fresh
    # zero constants (unvaried), which trips shard_map's varying-axis
    # bookkeeping; the program is purely elementwise along the restart
    # axis (no collectives), so replication checking adds nothing here.
    return jax.shard_map(local_run, mesh=mesh, in_specs=in_specs,
                         out_specs=P(BATCH_AXIS), check_vma=False)


def sharded_run_batch(mesh: Mesh, opt, x0s, keys):
    """Optimizer-zoo restart batch sharded over the mesh.

    ``opt`` is a ControlOptimizer.  Stateless-batch optimizers
    (lbfgs/nmplus/snob — optimizers exposing ``_build_batch_fn``) run
    under the cached shard_map program (see build_sharded_batch_fn for
    semantics + determinism contract).  Adam's persistent segment
    streams carry state on the instance; for it this function configures
    the instance's ``mesh`` and advances the stream batch ONE segment
    with the stream axis sharded (the same shard_map path as
    ``Adam(mesh=...)`` — see models/adam.py).  The instance keeps the
    mesh afterwards — subsequent run()/segments continue sharded.
    """
    x0s = jnp.asarray(x0s)
    k = x0s.shape[0]
    check_divisible(mesh, k, "restart")

    if not hasattr(opt, "_build_batch_fn"):
        # Adam-style persistent streams: RESET any existing stream
        # (otherwise a previously-initialised unsharded stream would
        # advance instead and the given x0s would be silently ignored).
        opt.mesh = mesh
        opt._stream = None
        opt._table = None
        return opt._run_batch(shard_batch(mesh, x0s, axis=0),
                              shard_batch(mesh, keys, axis=0))

    saved, opt.mesh = opt.mesh, mesh
    try:
        return opt._run_batch_sharded(shard_batch(mesh, x0s, axis=0),
                                      shard_batch(mesh, keys, axis=0))
    finally:
        opt.mesh = saved
