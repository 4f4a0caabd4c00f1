"""The plain float64 references (benchmark/reference/) against the
program's CPU path on the same draws, at a tiny lattice.  The reference
imports nothing of the program; these tests are where the two meet."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from reference import chain as ref
from reference import prng

from code_robchar_tpu.mc import engine
from code_robchar_tpu.ops import chain, realform

N, IN, OUT = 7, 0, 6
SEED = 2 ** 31 + 12345          # above 32 signed bits, as benchmark seeds are


def test_threefry_matches_jax_random():
    key = jax.random.key(np.uint32(SEED))
    kw = np.asarray(jax.random.key_data(key))
    gid = np.array([0, 1, 77, 2 ** 31 + 3, 2 ** 32 - 1], np.uint32)
    folded = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.asarray(gid))
    mine = prng.fold_in((kw[0], kw[1]), gid)
    assert np.array_equal(np.asarray(jax.random.key_data(folded)),
                          np.stack(mine, 1))
    subs = jax.vmap(lambda k: jax.random.split(k, 3))(folded)
    for j, sub in enumerate(prng.split(mine, 3)):
        assert np.array_equal(np.asarray(jax.random.key_data(subs[:, j])),
                              np.stack(sub, 1))
        z = np.asarray(jax.vmap(
            lambda k: jax.random.normal(k, (N,), jnp.float32))(subs[:, j]))
        # the same uniform bits; float32 erfinv against float64 erfinv
        np.testing.assert_allclose(prng.normal(sub, N), z, rtol=0,
                                   atol=4e-6)


def lattice(num_c=6, num_l=3, bootreps=5):
    rng = np.random.default_rng(0)
    ctrl = np.column_stack([rng.uniform(-10, 10, (num_c, N)),
                            rng.uniform(0, 30, num_c)]).astype(np.float32)
    noises = np.linspace(0, 0.1, num_l).astype(np.float32)
    return ctrl, noises, bootreps


def test_reference_fidelities_match_the_program_on_the_same_draws():
    ctrl, noises, B = lattice()
    key = jax.random.key(np.uint32(SEED))
    h0 = chain.xx_hamiltonian_real(N, dtype=jnp.float32)
    prog = np.asarray(engine.mc_fidelity_sweep(
        h0, jnp.asarray(ctrl), jnp.asarray(noises), key, B, IN, OUT))
    L, C = len(noises), len(ctrl)
    l, c, b = np.meshgrid(np.arange(L), np.arange(C), np.arange(B),
                          indexing="ij")
    gid = ((l * C + c) * B + b).astype(np.uint32).ravel()
    kw = np.asarray(jax.random.key_data(key))
    h = ref.perturbed_hamiltonians(ref.drift(N, 1.0), (kw[0], kw[1]), gid,
                                   noises.astype(np.float64)[l.ravel()],
                                   ctrl[c.ravel()])
    want = ref.transfer_fidelity(h, ctrl[c.ravel(), N], IN, OUT)
    np.testing.assert_allclose(prog.ravel(), want, rtol=0, atol=5e-6)

    metrics = engine.characterise(h0, jnp.asarray(ctrl), jnp.asarray(noises),
                                  key, B, IN, OUT, return_fids=False)
    mine = ref.metric_values(want.reshape(L * C, B), 0.05)
    assert set(mine) == set(metrics)
    for name, v in metrics.items():
        np.testing.assert_allclose(np.asarray(v).ravel(), mine[name],
                                   rtol=0, atol=5e-6, err_msg=name)


def test_controller_fidelity_matches_the_program():
    rng = np.random.default_rng(3)
    x = np.column_stack([rng.uniform(-10, 10, (16, N)),
                         rng.uniform(0, 30, 16)])
    h0 = chain.xx_hamiltonian_real(N, dtype=jnp.float32)
    prog = np.asarray(jax.vmap(lambda z: realform.fidelity_from_controller_sym(
        h0, z, IN, OUT))(jnp.asarray(x, jnp.float32)))
    want = ref.controller_fidelity(ref.drift(N, 1.0),
                                   x.astype(np.float32), IN, OUT)
    np.testing.assert_allclose(prog, want, rtol=0, atol=5e-6)


def test_two_site_transfer_oracle():
    # n = 2, no bias, T = pi / 2: complete transfer 0 -> 1
    x = np.array([0.0, 0.0, np.pi / 2])
    assert ref.controller_fidelity(ref.drift(2, 1.0), x, 0, 1) == \
        pytest.approx(1.0, abs=1e-14)


def test_ascent_gain_is_zero_at_a_reference_optimum_only():
    h0 = ref.drift(N, 1.0)
    bounds = [(-10, 10)] * N + [(0, 30)]
    rng = np.random.default_rng(5)
    best = None
    for _ in range(20):
        x0 = np.concatenate([rng.uniform(-3, 3, N), rng.uniform(5, 25, 1)])
        x = ref.local_optimum(h0, x0, IN, OUT, bounds)
        f = float(ref.controller_fidelity(h0, x, IN, OUT))
        if best is None or f > best[0]:
            best = (f, x, x0)
    f, x, x0 = best
    assert f > 0.9
    assert ref.ascent_gain(h0, x, IN, OUT, bounds) < 1e-7
    assert ref.ascent_gain(h0, x0, IN, OUT, bounds) > 1e-3


def test_bfloat16_control_departs_from_the_reference():
    h0 = ref.drift(N, 1.0)
    rng = np.random.default_rng(7)
    x = np.column_stack([rng.uniform(-10, 10, (256, N)),
                         rng.uniform(0, 30, 256)])
    f = ref.controller_fidelity(h0, x, IN, OUT)
    low = ref.controller_fidelity(h0, x, IN, OUT, "bfloat16")
    assert np.max(np.abs(low - f)) > 1e-3
