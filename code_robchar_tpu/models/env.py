"""XX spin-chain control environment.

Reference: RLreinforceXXchain_actionedtime.py:14-276.  The environment is a
*pure step function* over an explicit EnvState (action bias vector,
accumulated time, PRNG key) so whole rollouts compile into a single
`lax.scan` and hundreds of environments batch with vmap; a thin stateful
``Environment`` class wraps it for reference-API parity and for the
host-side golden tests.

Faithful semantics (quirks preserved deliberately):

- actions ACCUMULATE into a diagonal bias; when any |bias| exceeds bmax the
  whole vector wraps by ``b % (sign(b) * bmax)`` (RLreinforce...:261-262).
- the time coordinate is |t| mod maxtime when above maxtime
  (RLreinforce...:150-151).
- the reward evolves a FRESH |in> every step (the in-state is reset after
  each step, RLreinforce...:270), so controllers are time-global.
- ``done`` compares the normalised time against the pre-step
  ``final_time`` — with the PPO driver setting final_time = accumulated
  time each step (ppo.py:359-361), episodes effectively only end at epoch
  boundaries (SURVEY.md quirk 9).  Mirrored exactly.
- training-side Hamiltonian noise is the REAL-offdiagonal structured
  perturbation (RLreinforce...:122-133).
- ``use_fixed_ham`` averages the PROPAGATOR over the pre-drawn ensemble
  before applying it (RLreinforce...:153-162) — not the fidelity.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from code_robchar_tpu.ops import chain, noise as noise_ops, realform


class EnvConfig(NamedTuple):
    n: int
    in_spin: int
    out_spin: int
    bmax: float
    maxtime: float
    noise: float
    fid_noisy: bool
    ham_noisy: bool
    draws: int
    adaptive: bool
    adp_tol: float


class EnvState(NamedTuple):
    action: jnp.ndarray    # (n,) accumulated diagonal bias
    timestep: jnp.ndarray  # () accumulated readout time
    final_time: jnp.ndarray


def env_reset(cfg: EnvConfig) -> Tuple[EnvState, jnp.ndarray]:
    state = EnvState(action=jnp.zeros(cfg.n),
                     timestep=jnp.asarray(0.0),
                     final_time=jnp.asarray(float(cfg.maxtime)))
    obs = jnp.concatenate([state.action, state.timestep[None]])
    return state, obs


def _normalise_time(t, maxtime):
    t = jnp.abs(t)
    return jnp.where(t > maxtime, t % maxtime, t)


def _wrap_action(a, bmax):
    # the over-bound check is per ACTION VECTOR (RLreinforce...:253-257:
    # one |action|>bmax entry wraps the whole vector); batched inputs
    # (..., n) wrap per trailing vector
    over = jnp.any(jnp.abs(a) > bmax, axis=-1, keepdims=True)
    wrapped = a % (jnp.sign(a) * bmax + jnp.where(a == 0, 1.0, 0.0))
    return jnp.where(over, wrapped, a)


def env_step(cfg: EnvConfig, h0: jnp.ndarray, state: EnvState,
             a_bias: jnp.ndarray, a_time: jnp.ndarray, key: jax.Array,
             fixed_hams: Optional[jnp.ndarray] = None,
             with_true_fid: bool = True):
    """One control step.  Returns (state', obs, reward, true_fid, done,
    fcalls) — fcalls carries the shot-noise draw accounting in-band.

    ``h0`` (and ``fixed_hams``) are REAL symmetric: the training-side
    physics never leaves the reals (SURVEY.md quirk 7), so the whole step
    runs on the split-real kernels (ops/realform.py) — no complex dtype.

    ``with_true_fid=False`` skips the noiseless-fidelity eigendecomposition
    (returns 0.0 in that slot): inside a sequential rollout scan this
    halves the serial eigh depth — callers recompute true fidelities for
    the whole trajectory in ONE batched call afterwards
    (``true_fidelity_batch``).
    """
    kh, ks = jax.random.split(key)
    h0 = jnp.real(h0) if jnp.iscomplexobj(h0) else h0

    action = _wrap_action(state.action + a_bias, cfg.bmax)
    raw_t = state.timestep + a_time
    # the PPO driver pins final_time to the accumulated time (ppo.py:359-361)
    final_time = raw_t
    t = _normalise_time(raw_t, cfg.maxtime)

    hc = h0 + jnp.eye(cfg.n, dtype=h0.dtype) * action.astype(h0.dtype)

    if fixed_hams is not None:
        # averaged-propagator path (RLreinforce...:153-162): only the
        # (out, in) amplitude of the ensemble-mean propagator is needed,
        # so average the per-ensemble transfer amplitudes.
        fixed_r = jnp.real(fixed_hams) if jnp.iscomplexobj(fixed_hams) \
            else fixed_hams
        bias = jnp.eye(cfg.n, dtype=h0.dtype) * action.astype(h0.dtype)

        def amp(h):
            lam, v = realform.jacobi_eigh_sym(h + bias)
            w = v[cfg.out_spin, :] * v[cfg.in_spin, :]
            ang = lam * t
            return jnp.sum(w * jnp.cos(ang)), jnp.sum(w * -jnp.sin(ang))

        ar, ai = jax.vmap(amp)(fixed_r)
        amp_r, amp_i = jnp.mean(ar), jnp.mean(ai)
        fid = amp_r * amp_r + amp_i * amp_i
    else:
        h = hc
        if cfg.ham_noisy:
            zr, _ = noise_ops.structured_perturbation_parts(
                kh, cfg.n, cfg.noise, complex_offdiag=False, dtype=h.dtype)
            h = h + zr
        fid = realform.fidelity_sym(h, t, cfg.in_spin, cfg.out_spin)

    if with_true_fid:
        true_fid = realform.fidelity_sym(hc, t, cfg.in_spin, cfg.out_spin)
    else:
        true_fid = jnp.asarray(0.0, h0.dtype)

    fcalls = jnp.asarray(1, jnp.int32)
    reward = fid
    if cfg.fid_noisy:
        if cfg.adaptive:
            reward, extra = noise_ops.adaptive_shot_fidelity(
                ks, fid, cfg.draws, cfg.adp_tol)
            fcalls = (extra + cfg.draws).astype(jnp.int32)
        else:
            reward = noise_ops.shot_noise_fidelity(ks, fid, cfg.draws)

    done = t > final_time
    state = EnvState(action=action, timestep=t, final_time=final_time)
    obs = jnp.concatenate([action, t[None]])
    return state, obs, reward, true_fid, done, fcalls


def true_fidelity_batch(cfg: EnvConfig, h0: jnp.ndarray,
                        stores: jnp.ndarray) -> jnp.ndarray:
    """Noiseless fidelities of a (T, n+1) trajectory of controller
    snapshots (action biases + time) as one batched lanes-friendly call."""
    n = cfg.n
    h = h0 + jnp.eye(n, dtype=h0.dtype) * stores[:, None, :n]
    return realform.fidelity_sym(h, stores[:, n], cfg.in_spin, cfg.out_spin)


class Environment:
    """Stateful reference-API wrapper (reset/step/fidelity/true_fid/state)
    around the pure kernel; used by tests and host-side exploration."""

    def __init__(self, nspin, in_spin, out_spin, action_vector=None,
                 final_time=6, topo="linear", timestep_res=0.01, max_time=30,
                 bmin=-20, bmax=20, fid_noisy=False, ham_noisy=False,
                 draws=20, adaptive=False, adp_tol=0.05, noise=0.05,
                 transfer_learning=False, heisenberg_int=False,
                 use_fixed_ham=False, opt_train_size=100, seed=0):
        self.Nspin = nspin
        self.in_spin = in_spin
        self.out_spin = out_spin
        self.noise = noise
        self.maxtime = max_time
        self.max = bmax
        self.min = bmin
        self.tres = timestep_res
        self.use_fixed_ham = use_fixed_ham
        self.train_size = opt_train_size
        self.draws = draws
        self.adaptive = adaptive
        self.adp_var_tol = adp_tol
        self.fid_noisy = fid_noisy
        self.ham_noisy = ham_noisy
        # stored like the reference (RLreinforce...:25-26) so
        # reinit_sys_hamiltonian rebuilds the SAME topology/interaction
        self.topo = topo
        self.heisenberg_int = heisenberg_int
        self._key = jax.random.key(seed)

        self.sys = chain.xx_hamiltonian_real(nspin, topo=topo,
                                             heisenberg=heisenberg_int)
        if transfer_learning:
            # perturbed system with its diagonal masked off
            # (RLreinforce...:30-35)
            pert, _ = noise_ops.structured_perturbation_parts(
                self._next(), nspin, 0.1, complex_offdiag=False,
                dtype=self.sys.dtype)
            mask = 1.0 - jnp.eye(nspin, dtype=self.sys.dtype)
            self.sys = (self.sys + pert) * mask

        if use_fixed_ham:
            self.randH, self.randH_test = noise_ops.fixed_hamiltonian_ensemble(
                jax.random.key(4), self.sys, self.noise,
                train_size=self.train_size, test_size=10000,
                complex_offdiag=False)
        else:
            self.randH = self.randH_test = None

        self.timestep = 0.0
        self.final_time = float(self.maxtime)
        self.action = np.zeros(nspin)
        self.adp_func_calls_increment = draws
        self.tf = 0.0

    def _next(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _cfg(self) -> EnvConfig:
        return EnvConfig(n=self.Nspin, in_spin=self.in_spin,
                         out_spin=self.out_spin, bmax=float(self.max),
                         maxtime=float(self.maxtime),
                         noise=float(self.noise),
                         fid_noisy=bool(self.fid_noisy),
                         ham_noisy=bool(self.ham_noisy),
                         draws=int(self.draws), adaptive=bool(self.adaptive),
                         adp_tol=float(self.adp_var_tol))

    def reset(self):
        self.timestep = 0.0
        self.final_time = float(self.maxtime)
        self.action = np.zeros(self.Nspin)
        return np.diag(self.action)

    def structured_perturabation(self, noise):
        return np.asarray(noise_ops.structured_perturbation(
            self._next(), self.Nspin, noise, complex_offdiag=False))

    def step(self, action_matrix):
        """action_matrix: (n, n) diagonal increment (reference passes
        np.diag(a)); time increments are applied by mutating .timestep
        before the call, as the PPO driver does (ppo.py:359-363)."""
        a_bias = jnp.asarray(np.diag(np.asarray(action_matrix)))
        st = EnvState(action=jnp.asarray(self.action),
                      timestep=jnp.asarray(0.0),
                      final_time=jnp.asarray(float(self.final_time)))
        st, obs, reward, true_fid, done, _ = env_step(
            self._cfg(), self.sys, st, a_bias, jnp.asarray(self.timestep),
            self._next(),
            fixed_hams=self.randH if self.use_fixed_ham else None)
        self.action = np.asarray(st.action)
        self.timestep = float(st.timestep)
        self.tf = float(true_fid)
        return np.diag(self.action), float(reward), bool(done)

    def fidelity(self):
        st = EnvState(action=jnp.asarray(self.action),
                      timestep=jnp.asarray(0.0),
                      final_time=jnp.asarray(float(self.final_time)))
        _, _, reward, _, _, fc = env_step(
            self._cfg(), self.sys, st, jnp.zeros(self.Nspin),
            jnp.asarray(self.timestep), self._next(),
            fixed_hams=self.randH if self.use_fixed_ham else None)
        self.adp_func_calls_increment += int(fc) - 1 if self.adaptive else 0
        return float(reward)

    # ----------------------- reference-API capability shims ----------------

    def state_vector(self, occ):
        return np.asarray(chain.basis_state(self.Nspin, occ,
                                            dtype=jnp.float64).real)

    def input_state(self):
        rho = np.zeros((self.Nspin, self.Nspin))
        rho[self.in_spin, self.in_spin] = 1
        return rho

    def output_state(self):
        rho = np.zeros((self.Nspin, self.Nspin))
        rho[self.out_spin, self.out_spin] = 1
        return rho

    def reinit_sys_hamiltonian(self):
        """Re-draw the masked perturbed system of transfer-learning mode
        (RLreinforce...:75-80; the reference rebuilds the drift via
        system_hamiltonian(), which honours the env's topo and
        heisenberg_int — so must the re-init)."""
        pert, _ = noise_ops.structured_perturbation_parts(
            self._next(), self.Nspin, 0.1, complex_offdiag=False,
            dtype=self.sys.dtype)
        mask = 1.0 - jnp.eye(self.Nspin, dtype=self.sys.dtype)
        drift = chain.xx_hamiltonian_real(self.Nspin, topo=self.topo,
                                          heisenberg=self.heisenberg_int)
        self.sys = (drift + pert) * mask

    def change_sys_ham(self, default_variation: float = 0.1):
        """Perturb the system's couplings in place (RLreinforce...:136-143:
        small Gaussian bumps on nearest-neighbour couplings)."""
        nn, _ = noise_ops.structured_perturbation_parts(
            self._next(), self.Nspin, default_variation,
            complex_offdiag=False, dtype=self.sys.dtype)
        off = nn - jnp.diag(jnp.diag(nn))  # couplings only, no diagonal
        self.sys = self.sys + off

    def normalize(self):
        """Wrap action/time back into bounds (RLreinforce...:253-257)."""
        a = np.asarray(self.action)
        if (np.abs(a) > self.max).any():
            self.action = np.asarray(_wrap_action(jnp.asarray(a),
                                                  float(self.max)))
        self.timestep = float(_normalise_time(jnp.asarray(abs(
            self.timestep)), float(self.maxtime)))

    def true_fid(self, action_matrix, timestep_n=None):
        t = self.timestep if timestep_n is None else timestep_n
        a = jnp.asarray(np.diag(np.asarray(action_matrix)))
        hr = jnp.real(self.sys) + jnp.eye(self.Nspin) * a
        return float(realform.fidelity_sym(hr, jnp.asarray(float(t)),
                                           self.in_spin, self.out_spin))
