"""Pallas Jacobi kernels (Triton route) in interpret mode, the block and
padding choice, and the kernel selector.  On the card the same kernels
are compiled and checked by tests/test_gpu.py and chip_smoke.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from code_robchar_tpu.ops import kernel_check, realform, select
from code_robchar_tpu.ops import pallas_jacobi as pj
from code_robchar_tpu.ops.pallas_jacobi import fidelity_herm_pallas


def _herm_lanes(rng, n, b):
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    sym = (a + np.transpose(a, (0, 2, 1))) / 2
    anti = (a - np.transpose(a, (0, 2, 1))) / 2
    ar = jnp.asarray(np.moveaxis(sym, 0, -1).copy())
    ai = jnp.asarray(np.moveaxis(anti, 0, -1).copy())
    t = jnp.asarray(rng.uniform(1, 5, b).astype(np.float32))
    return ar, ai, t


def test_pallas_matches_lanes_interpret(rng):
    n, b = 4, 128
    ar, ai, t = _herm_lanes(rng, n, b)
    ref = realform.fidelity_herm_lanes(ar, ai, t, 0, 2, sweeps=6)
    out = fidelity_herm_pallas(ar, ai, t, 0, 2, sweeps=6, block=128,
                               interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


def test_pallas_sym_grad_matches_lanes_interpret(rng):
    """The fused gradient kernel must match the XLA lanes gradient
    (which itself matches the rows path at 1e-10)."""
    n, b = 5, 8
    h0 = np.asarray(rng.normal(size=(n, n)))
    h0 = jnp.asarray((h0 + h0.T) / 2, dtype=jnp.float32)
    xs = jnp.asarray(np.column_stack(
        [rng.uniform(-5, 5, (b, n)), rng.uniform(0.5, 20, b)]
    ).astype(np.float32))
    want_e, want_g = realform.infidelity_and_gradient_sym_lanes(
        h0, xs, 0, 3, sweeps=6)
    got_e, got_g = pj.infidelity_and_gradient_sym_pallas(
        h0, xs, 0, 3, sweeps=6, interpret=True)
    np.testing.assert_allclose(np.asarray(got_e), np.asarray(want_e),
                               atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got_g), np.asarray(want_g),
                               atol=2e-5, rtol=1e-4)


def test_pallas_sym_amp_matches_lanes_interpret(rng):
    """The RL-rollout amplitude kernel must match the XLA lanes amplitude
    (the real-symmetric training-path physics)."""
    n, b = 4, 128
    ar, _, t = _herm_lanes(rng, n, b)
    ref_r, ref_i = realform.transfer_amp_sym_lanes(ar, t, 0, 2, sweeps=6)
    got_r, got_i = pj.transfer_amp_sym_pallas(ar, t, 0, 2, sweeps=6,
                                              block=128, interpret=True)
    np.testing.assert_allclose(np.asarray(got_r), np.asarray(ref_r),
                               atol=2e-5)
    np.testing.assert_allclose(np.asarray(got_i), np.asarray(ref_i),
                               atol=2e-5)


@pytest.mark.parametrize("n,b", [(4, 37), (5, 70)])
@pytest.mark.parametrize("kind", kernel_check.KINDS)
def test_triton_kernels_match_lanes_at_odd_widths(kind, n, b, rng):
    """Every kernel against the XLA lanes path at a width that is not a
    multiple of the block (the wrapper edge-pads and slices back)."""
    ar, ai, t = _herm_lanes(rng, n, b)
    out_spin = n - 1
    if kind == "herm_fid":
        want = [realform.fidelity_herm_lanes(ar, ai, t, 0, out_spin)]
        got = [fidelity_herm_pallas(ar, ai, t, 0, out_spin,
                                    interpret=True)]
        tol = dict(atol=2e-5)
    elif kind == "sym_amp":
        want = realform.transfer_amp_sym_lanes(ar, t, 0, out_spin)
        got = pj.transfer_amp_sym_pallas(ar, t, 0, out_spin,
                                         interpret=True)
        tol = dict(atol=2e-5)
    else:
        xs = jnp.asarray(np.column_stack(
            [rng.uniform(-5, 5, (b, n)), rng.uniform(0.5, 20, b)]
        ).astype(np.float32))
        h0 = ar[:, :, 0]
        want = realform.infidelity_and_gradient_sym_lanes(h0, xs, 0,
                                                          out_spin)
        got = pj.infidelity_and_gradient_sym_pallas(h0, xs, 0, out_spin,
                                                    interpret=True)
        tol = dict(atol=5e-5, rtol=1e-4)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **tol)


@pytest.mark.parametrize("kind", kernel_check.KINDS)
def test_kernel_check_against_f64_reference_interpret(kind):
    """The card's check (kernel vs f64 jnp.linalg.eigh on the host CPU)
    passes on production-like inputs in interpret mode."""
    row = kernel_check.check_kernel(kind, 4, 33, interpret=True)
    assert row["ok"], row
    assert row["err_abs"] <= row["tol_abs"]


def test_pallas_auto_tile_padded_width_interpret(rng):
    """block=None must handle a batch that no block divides (b = 1153,
    odd) by edge-padding to the block width and slicing back."""
    n, b = 4, 1153
    ar, _, t = _herm_lanes(rng, n, b)
    ai = jnp.zeros_like(ar)
    ref = realform.fidelity_herm_lanes(ar, ai, t, 0, 2, sweeps=6)
    out = fidelity_herm_pallas(ar, ai, t, 0, 2, sweeps=6, interpret=True)
    assert out.shape == (b,)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("b,want", [
    (1, (pj.BLOCK_NARROW, 32)),
    (1024, (pj.BLOCK_NARROW, 1024)),          # zoo / PPO batches
    (1153, (pj.BLOCK_NARROW, 1184)),          # odd width: padded
    (pj.WIDE_FROM - 1, (pj.BLOCK_NARROW, pj.WIDE_FROM)),
    (65536, (pj.BLOCK_WIDE, 65536)),          # MC chunk
    (99999, (pj.BLOCK_WIDE, 100096)),
])
def test_pick_block_pads_to_whole_power_of_two_blocks(b, want):
    block, bp = pj.pick_block(b)
    assert (block, bp) == want
    assert block & (block - 1) == 0 and block % 32 == 0
    assert bp % block == 0 and b <= bp < b + block


@pytest.mark.parametrize("platform,kernel", [("gpu", "triton"),
                                             ("cpu", "xla")])
def test_select_known_platforms(platform, kernel):
    assert select.jacobi_kernel(platform) == kernel
    assert select.use_pallas(platform) == (kernel == "triton")


@pytest.mark.parametrize("platform", ["cuda", "rocm", "METAL"])
def test_select_unknown_platform_raises(platform):
    with pytest.raises(ValueError, match="unsupported platform"):
        select.jacobi_kernel(platform)


def test_select_defaults_to_the_running_backend():
    assert jax.default_backend() == "cpu"
    assert select.jacobi_kernel() == "xla"
    assert select.use_pallas() is False


def test_objectives_dispatch_through_selector(monkeypatch, rng):
    """The objective builders send every batch width down the Pallas path
    when the selector picks it.  Spy on the Pallas entry points with the
    selector forced to the GPU answer."""
    import code_robchar_tpu.models.objectives as obj
    from code_robchar_tpu.ops import chain

    monkeypatch.setattr(select, "use_pallas", lambda platform=None: True)
    calls = []
    monkeypatch.setattr(
        pj, "infidelity_and_gradient_sym_pallas",
        lambda h0, xs, i, o, **kw:
            calls.append(("grad", xs.shape[0])) or
            realform.infidelity_and_gradient_sym_lanes(h0, xs, i, o))
    monkeypatch.setattr(
        pj, "fidelity_sym_pallas",
        lambda a, t, i, o, **kw:
            calls.append(("fid", a.shape[-1])) or
            realform.fidelity_sym_lanes(a, t, i, o))

    n = 4
    h0 = jnp.real(chain.xx_hamiltonian_real(n, dtype=jnp.float32))
    spec = obj.ObjectiveSpec(h0=h0, in_spin=0, out_spin=2, noise=0.0,
                             fid_noisy=False, ham_noisy=False, draws=0,
                             adaptive=False, adp_tol=0.0,
                             fixed_hams=None, mul_fac=1)
    for b in (7, 1153):
        xs = jnp.asarray(rng.uniform(-5, 5, (b, n + 1)).astype(np.float32))
        e, g = obj.make_exact_gradient_batch(spec)(xs)
        assert e.shape == (b,) and g.shape == (b, n + 1)
        a = jnp.broadcast_to(h0[:, :, None], (n, n, b))
        t = jnp.asarray(rng.uniform(1, 5, b).astype(np.float32))
        assert obj._make_fid_lanes(0, 2)(a, t).shape == (b,)
    assert calls == [("grad", 7), ("fid", 7), ("grad", 1153),
                     ("fid", 1153)]


def test_pair_schedule_covers_all_pairs_disjointly():
    """Round-robin ordering: every sweep must still visit each of the
    n(n-1)/2 pivots exactly once, and a stage's pairs must be pairwise
    disjoint (that disjointness is what makes the hoisted angle
    computation exact)."""
    for n in range(2, 12):
        for order in ("cyclic", "roundrobin"):
            stages = pj.pair_schedule(n, order)
            flat = [pq for st in stages for pq in st]
            assert sorted(flat) == [(p, q) for p in range(n - 1)
                                    for q in range(p + 1, n)], (n, order)
            for st in stages:
                touched = [i for pq in st for i in pq]
                assert len(touched) == len(set(touched)), (n, order, st)
    # cyclic must reproduce the exact row-major order
    assert [st[0] for st in pj.pair_schedule(4, "cyclic")] == [
        (0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    with pytest.raises(ValueError):
        pj.pair_schedule(5, "zigzag")


@pytest.mark.parametrize("n", range(2, 12))
def test_stage_relabel_walks_the_round_robin_schedule(n):
    """Looping one relabelled stage visits the pairs of every round-robin
    stage in turn and brings every slot back after a sweep."""
    pairs, perm = pj.stage_relabel(n)
    assert all(p < q for p, q in pairs)
    assert sorted(perm) == list(range(n))
    label = list(range(n))                 # slot -> original index
    for stage in pj.pair_schedule(n):
        got = sorted(tuple(sorted((label[p], label[q]))) for p, q in pairs)
        assert got == sorted(stage)
        label = [label[perm[j]] for j in range(n)]
    assert label == list(range(n))


def test_roundrobin_matches_cyclic_at_convergence(rng):
    """The kernels' round-robin order must not move the converged result
    beyond the f32 floor: at the production sweep count the kernel
    agrees with the x64 oracle to ~1e-5."""
    n, b = 5, 256
    a = rng.normal(size=(b, n, n)).astype(np.float32)
    sym = (a + np.transpose(a, (0, 2, 1))) / 2
    sk = rng.normal(size=(b, n, n)).astype(np.float32)
    skew = (sk - np.transpose(sk, (0, 2, 1))) / 2
    ar = jnp.asarray(np.moveaxis(sym, 0, -1).copy())
    ai = jnp.asarray(np.moveaxis(skew, 0, -1).copy())
    t = jnp.asarray(rng.uniform(1, 5, b).astype(np.float32))
    f_rr = fidelity_herm_pallas(ar, ai, t, 0, 4, sweeps=5, interpret=True)
    # x64 oracle
    H = sym.astype(np.float64) + 1j * skew.astype(np.float64)
    lam, V = np.linalg.eigh(H)
    ph = np.einsum("bk,bk,bk->b", V[:, 4, :], np.conj(V[:, 0, :]),
                   np.exp(-1j * lam * np.asarray(t, np.float64)[:, None]))
    np.testing.assert_allclose(np.asarray(f_rr).ravel(),
                               np.abs(ph) ** 2, atol=3e-5)


@pytest.mark.parametrize("kernel,chunk", [("triton", 262144),
                                          ("xla", 8192)])
def test_mc_chunk_follows_the_selected_kernel(monkeypatch, kernel, chunk):
    """chunk=None takes the chunk measured for the platform's kernel; an
    explicit chunk wins."""
    from code_robchar_tpu.mc import engine

    monkeypatch.setattr(select, "jacobi_kernel",
                        lambda platform=None: kernel)
    assert engine._resolve_chunk(None) == chunk
    assert engine._resolve_chunk(64) == 64
