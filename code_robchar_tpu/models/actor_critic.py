"""Actor-critic for PPO controller synthesis, in plain JAX.

Reference: ppo_core.py:18-118 (torch MLPs).  Same architecture contract:
tanh MLP with (100, 100) hidden units for both heads, Gaussian policy with
a state-independent learned log-std initialised at -0.5, log-prob summed
over action dims, value head squeezed to a scalar.

Parameters are a dict pytree::

    {"pi": {"layers": [{"w": (in, out), "b": (out,)}, ...],
            "log_std": (act_dim,)},
     "v":  {"layers": [...]}}

with LeCun-normal weights (truncated normal, variance 1/fan_in) and zero
biases, in float32.  Every dense layer multiplies at ``PRECISION``: a
float32 dot on the GPU otherwise runs in TF32, which keeps about three
decimal digits.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

HIDDEN = (100, 100)
LOG_STD_INIT = -0.5
PRECISION = jax.lax.Precision.HIGHEST


def _mlp_init(key, sizes: Sequence[int]):
    init = jax.nn.initializers.lecun_normal()
    keys = jax.random.split(key, len(sizes) - 1)
    return [{"w": init(k, (m, n), jnp.float32),
             "b": jnp.zeros((n,), jnp.float32)}
            for k, m, n in zip(keys, sizes[:-1], sizes[1:])]


def _mlp(layers, x):
    for i, layer in enumerate(layers):
        x = jnp.dot(x, layer["w"], precision=PRECISION) + layer["b"]
        if i < len(layers) - 1:
            x = jnp.tanh(x)
    return x


def init(key, obs_dim: int, act_dim: int,
         hidden: Sequence[int] = HIDDEN) -> Dict:
    """Fresh parameters for observations of ``obs_dim`` and actions of
    ``act_dim`` (ppo_core.py:98-107)."""
    kpi, kv = jax.random.split(key)
    return {"pi": {"layers": _mlp_init(kpi, (obs_dim, *hidden, act_dim)),
                   "log_std": jnp.full((act_dim,), LOG_STD_INIT,
                                       jnp.float32)},
            "v": {"layers": _mlp_init(kv, (obs_dim, *hidden, 1))}}


def actor(params, obs) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mu, log_std) of the Gaussian policy."""
    return _mlp(params["pi"]["layers"], obs), params["pi"]["log_std"]


def critic(params, obs) -> jnp.ndarray:
    return jnp.squeeze(_mlp(params["v"]["layers"], obs), axis=-1)


def apply(params, obs):
    """(mu, log_std, v): both heads on ``obs``."""
    mu, log_std = actor(params, obs)
    return mu, log_std, critic(params, obs)


def gaussian_logp(mu, log_std, act):
    """Diagonal-Gaussian log-density summed over the action axis
    (ppo_core.py:85-86)."""
    std = jnp.exp(log_std)
    z = (act - mu) / std
    return jnp.sum(-0.5 * z**2 - log_std - 0.5 * jnp.log(2 * jnp.pi),
                   axis=-1)


def policy_step(params, obs, key) -> Tuple[jnp.ndarray, jnp.ndarray,
                                           jnp.ndarray]:
    """Sample (action, value, logp) — the no-grad acting step
    (ppo_core.py:109-115)."""
    mu, log_std, v = apply(params, obs)
    a = mu + jnp.exp(log_std) * jax.random.normal(key, mu.shape, mu.dtype)
    logp = gaussian_logp(mu, log_std, a)
    return a, v, logp


def count_vars(params) -> int:
    return sum(int(jnp.size(p)) for p in jax.tree.leaves(params))
