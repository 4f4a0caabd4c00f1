"""The plain-JAX actor-critic: parameter layout, initialisation,
heads, log-density and matmul precision."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.stats

from code_robchar_tpu.models import actor_critic as ac


@pytest.mark.parametrize("obs_dim,act_dim", [(5, 5), (8, 8)])
def test_param_shapes_and_head_outputs(obs_dim, act_dim):
    params = ac.init(jax.random.key(0), obs_dim, act_dim)
    for head, out in (("pi", act_dim), ("v", 1)):
        shapes = [(l["w"].shape, l["b"].shape)
                  for l in params[head]["layers"]]
        assert shapes == [((obs_dim, 100), (100,)), ((100, 100), (100,)),
                          ((100, out), (out,))]
    obs = jnp.ones((7, obs_dim), jnp.float32)
    mu, log_std, v = ac.apply(params, obs)
    assert mu.shape == (7, act_dim) and log_std.shape == (act_dim,)
    assert v.shape == (7,)
    assert ac.critic(params, obs[0]).shape == ()
    assert ac.count_vars(params) == sum(
        (i * o + o) for i, o in ((obs_dim, 100), (100, 100),
                                 (100, act_dim), (obs_dim, 100),
                                 (100, 100), (100, 1))) + act_dim


def test_init_statistics():
    """LeCun-normal weights (truncated normal of variance 1/fan_in, cut
    at two standard deviations of the underlying normal), zero biases,
    log_std at -0.5, float32 throughout."""
    params = ac.init(jax.random.key(3), 100, 8)
    w = np.asarray(params["pi"]["layers"][1]["w"])
    assert abs(w.std() - 0.1) < 0.005
    assert np.abs(w).max() <= 2 * 0.1 / 0.87962566 + 1e-6
    assert abs(w.mean()) < 0.005
    for head in ("pi", "v"):
        for layer in params[head]["layers"]:
            assert np.all(np.asarray(layer["b"]) == 0.0)
    np.testing.assert_array_equal(np.asarray(params["pi"]["log_std"]),
                                  np.full(8, -0.5))
    assert {x.dtype for x in jax.tree.leaves(params)} == {
        np.dtype(np.float32)}


def test_gaussian_logp_matches_scipy(rng):
    mu = rng.normal(size=(4, 6))
    log_std = rng.normal(size=6) * 0.3
    act = rng.normal(size=(4, 6))
    want = scipy.stats.norm.logpdf(act, mu, np.exp(log_std)).sum(-1)
    got = ac.gaussian_logp(jnp.asarray(mu), jnp.asarray(log_std),
                           jnp.asarray(act))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-12)


def test_policy_step_and_precision():
    """Every dense layer asks for HIGHEST precision (a float32 dot on
    the GPU otherwise runs in TF32)."""
    params = ac.init(jax.random.key(0), 5, 5)
    obs = jnp.zeros(5, jnp.float32)
    a, v, logp = ac.policy_step(params, obs, jax.random.key(1))
    assert a.shape == (5,) and v.shape == () and np.isfinite(float(logp))
    jaxpr = str(jax.make_jaxpr(ac.apply)(params, obs))
    assert jaxpr.count("dot_general") == 6
    assert jaxpr.count("Precision.HIGHEST") >= 6
