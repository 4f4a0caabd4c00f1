"""PPO controller synthesis, compiled end-to-end.

Reference: ppo.py (spinningup-derived torch trainer driving the numpy env
step-by-step, crossing the torch<->numpy boundary twice per step,
SURVEY.md §3.2).  Here one *epoch* — 500-step rollout, GAE-lambda,
KL-early-stopped clipped-surrogate policy updates, value regression — is a
single jitted program: rollouts are `lax.scan` over the pure env kernel,
GAE is a reverse scan, the pi loop is a `lax.while_loop` with the KL gate,
and the v loop a `lax.fori_loop`.  ``num_agents`` vmaps the whole epoch so
hundreds of independent controller searches share one compilation
(BASELINE.json north star).

Hyperparameter contract mirrors the reference exactly, including its quirk
that run() applies its *own* defaults for train_pi_iters / train_v_iters /
clip_ratio / lrs, honouring only the constructor's lam/gamma
(ppo.py:216-231).  Function-call accounting: one env step bills 1 call
(x train_size under fixed-ham, ppo.py:364-371; adaptive shots bill their
draw consumption in-band).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
import optax

from code_robchar_tpu.models import actor_critic as ac
from code_robchar_tpu.models.base import cached_program
from code_robchar_tpu.models.env import EnvConfig, EnvState, env_reset
from code_robchar_tpu.utils.record import RunRecord, TopControllers
from code_robchar_tpu.utils.timeout import Deadline


class AgentState(NamedTuple):
    params: Dict
    pi_opt: optax.OptState
    vf_opt: optax.OptState
    env: EnvState
    obs: jnp.ndarray
    ep_len: jnp.ndarray
    key: jax.Array


class EpochOut(NamedTuple):
    rewards: jnp.ndarray      # (T,)
    true_fids: jnp.ndarray    # (T,)
    stores: jnp.ndarray       # (T, d) controller = (bias..., time)
    fcalls: jnp.ndarray       # (T,)
    kl: jnp.ndarray
    pi_iters: jnp.ndarray


def gae_and_returns(rewards, values, boundaries, bootstrap, gamma, lam):
    """GAE-lambda advantages + discounted rewards-to-go with in-scan
    trajectory boundaries (PPOBuffer.finish_path semantics, ppo.py:58-84:
    at a boundary the tail value is the bootstrap estimate)."""
    def back(carry, xs):
        adv_next, ret_next, v_next = carry
        r, v, b, boot = xs
        v_tail = jnp.where(b, boot, v_next)
        ret_tail = jnp.where(b, boot, ret_next)
        delta = r + gamma * v_tail - v
        adv = delta + gamma * lam * jnp.where(b, 0.0, adv_next)
        ret = r + gamma * ret_tail
        return (adv, ret, v), (adv, ret)

    init = (jnp.asarray(0.0), jnp.asarray(0.0), jnp.asarray(0.0))
    _, (advs, rets) = jax.lax.scan(
        back, init, (rewards, values, boundaries, bootstrap), reverse=True)
    return advs, rets


class PPO_en:
    name = "ppo"

    def __init__(self, nspin=3, in_spin=0, out_spin=2, bmin=-10, bmax=10,
                 max_time=30, repeats=100, fid_threshold=0.98,
                 timestep_res=0.5, epochs=10000, rollouts=4000, log=False,
                 ac_kwargs=None, save=False, timeout=1800, verbose=False,
                 fid_noisy=False, ham_noisy=False, draws=10, adaptive=False,
                 adp_tol=0.05, testing=False, noise=0.05,
                 transfer_learning=False, run_until_told_to_stop=False,
                 run_until_completion_its=6e5,
                 landscape_exploration=False, save_topc=1000,
                 train_pi_iters=200, train_v_iters=200, clip_ratio=0.2,
                 lam=0.97, gamma=0.99, pi_lr=3e-3, vf_lr=1e-3,
                 use_fixed_ham=False, opt_train_size=100,
                 records_update_rate=None, num_agents: int = 1,
                 seed: Optional[int] = None,
                 use_wass_value_targets: bool = False,
                 wass_bootstrap_reps: int = 30,
                 rollout_sweeps: Optional[int] = None,
                 mesh=None):
        self.nspin = nspin
        self.In = in_spin
        self.Out = out_spin
        self.Bmin, self.Bmax = bmin, bmax
        self.Tmax = max_time
        self.fid_threshold = fid_threshold
        self.fid_noisy = fid_noisy
        self.ham_noisy = ham_noisy
        self.draws = draws
        self.adaptive = adaptive
        self.adp_tol = adp_tol
        self.verbose = verbose
        self.timeout = timeout
        self.save = save
        self.testing = testing
        self.lam, self.gamma = lam, gamma
        self.run_until_told_to_stop = run_until_told_to_stop
        self.run_until_completion_its = run_until_completion_its
        self.landscape_exploration = landscape_exploration
        self.save_topc = save_topc
        self.use_fixed_ham = use_fixed_ham
        self.train_size = opt_train_size
        self.records_update_rate = records_update_rate
        self.num_agents = num_agents
        #: optional jax.sharding.Mesh: the agent batch axis of the whole
        #: AgentState pytree is split over the mesh and the jitted epoch
        #: partitions under GSPMD — data parallelism over independent
        #: controller searches, replacing the reference's commented-out
        #: MPI hooks (ppo.py:222-223, SURVEY §2.4)
        self.mesh = mesh
        if mesh is not None and num_agents % mesh.devices.size:
            raise ValueError(
                f"num_agents {num_agents} must be a multiple of the mesh "
                f"size {mesh.devices.size}")
        # Wasserstein-cost value targets (ppo.py:277-286): the reference
        # wires this behind `update(max_fid_seen > 1)` — unreachable since
        # fidelities are <= 1 — but the capability is part of the trainer's
        # surface, so here it is an explicit opt-in flag.
        self.use_wass_value_targets = use_wass_value_targets
        self.wass_bootstrap_reps = wass_bootstrap_reps
        # reduced-sweep Jacobi for the in-rollout reward eigh (None =
        # dtype-accurate default; RL reward shaping tolerates ~1e-3, so
        # 4 sweeps at f32 is a sanctioned throughput mode)
        self.rollout_sweeps = rollout_sweeps
        # the Experiment driver mutates .env.noise post-construction
        # (noise_analysis.py:343-344), so the env wrapper is the config home
        from code_robchar_tpu.models.env import Environment
        self.env = Environment(nspin, in_spin, out_spin, np.zeros(nspin),
                               max_time=max_time, bmin=bmin, bmax=bmax,
                               fid_noisy=fid_noisy, ham_noisy=ham_noisy,
                               draws=draws, adaptive=adaptive,
                               adp_tol=adp_tol, noise=noise,
                               transfer_learning=transfer_learning,
                               use_fixed_ham=use_fixed_ham,
                               opt_train_size=opt_train_size)

        if seed is None:
            seed = 0 if testing else int(np.random.randint(0, 2**31 - 1))
        self.seed_ = seed

        self.record = {"time_to_get_fid": None, "func_calls": None,
                       "iterations": None, "repeats": None, "best_fid": None,
                       "controller": None}
        self.records = {}
        self.filename = "ppo_en_record_s{}_o{}_t{}_b{}_r_{}.json".format(
            nspin, out_spin, max_time, bmax, repeats)

        # Monte_env capability (ppo.py:179): fidelity re-evaluation helper
        from code_robchar_tpu.models.lbfgs import LBFGS
        self.Monte_env = LBFGS(nspin, in_spin, out_spin, noise=noise,
                               testing=True)


    # ----------------------------------------------------------- builders

    def _cfg(self) -> EnvConfig:
        return EnvConfig(n=self.nspin, in_spin=self.In, out_spin=self.Out,
                         bmax=float(self.env.max),
                         maxtime=float(self.env.maxtime),
                         noise=float(self.env.noise),
                         fid_noisy=bool(self.fid_noisy),
                         adaptive=bool(self.adaptive),
                         adp_tol=float(self.adp_tol),
                         ham_noisy=bool(self.ham_noisy),
                         draws=int(self.draws))

    def _build_epoch(self, steps_per_epoch, clip_ratio, pi_lr, vf_lr,
                     max_ep_len, train_pi_iters, train_v_iters, target_kl):
        """One PPO epoch for ALL agents at once, as `epoch_fn(st)`.

        The returned callable reads ``self.env.noise`` at CALL time and
        feeds it to a cached jitted program as a runtime operand
        (base._PROGRAM_CACHE): the Experiment driver trains one PPO per
        sigma cell (noise_analysis.py:343-344), and without the shared
        program every cell would pay the epoch's full XLA compile.  The
        drift / fixed-ensemble arrays are folded into the cache key by
        content digest (transfer_learning perturbs the drift per
        instance, models/env.py)."""
        import hashlib

        h0 = jnp.real(self.env.sys)
        dig = hashlib.sha1(np.asarray(h0).tobytes())
        if self.use_fixed_ham:
            dig.update(np.asarray(self.env.randH).tobytes())
        cfg = self._cfg()
        key = ("ppo_epoch", cfg._replace(noise=0.0), dig.hexdigest(),
               str(h0.dtype), self.gamma, self.lam, self.rollout_sweeps,
               self.use_fixed_ham,
               self.train_size, self.use_wass_value_targets,
               self.wass_bootstrap_reps, self.num_agents == 1,
               steps_per_epoch, clip_ratio, pi_lr, vf_lr, max_ep_len,
               train_pi_iters, train_v_iters, target_kl)
        if self.mesh is not None and self.num_agents > 1:
            # agent axis split over the mesh, as a shard_map program: the
            # epoch is elementwise along agents (each agent trains its own
            # actor-critic), and manual axes are REQUIRED because the
            # Pallas physics kernel cannot be GSPMD-partitioned.  A fresh
            # epoch impl — tracing the plain cached program inside
            # shard_map would poison its trace cache for plain calls.
            from jax.sharding import PartitionSpec as P

            from code_robchar_tpu.parallel.mesh import BATCH_AXIS

            def build_sharded():
                raw = self._build_epoch_impl(
                    steps_per_epoch, clip_ratio, pi_lr, vf_lr, max_ep_len,
                    train_pi_iters, train_v_iters, target_kl)
                return jax.shard_map(
                    raw, mesh=self.mesh,
                    in_specs=(P(BATCH_AXIS), P()),
                    out_specs=P(BATCH_AXIS), check_vma=False)

            fn = cached_program(key + ("sharded", self.mesh),
                                build_sharded)
        else:
            fn = cached_program(key, lambda: self._build_epoch_impl(
                steps_per_epoch, clip_ratio, pi_lr, vf_lr, max_ep_len,
                train_pi_iters, train_v_iters, target_kl))

        def epoch_fn(st):
            return fn(st, jnp.asarray(float(self.env.noise), h0.dtype))
        return epoch_fn

    def _build_epoch_impl(self, steps_per_epoch, clip_ratio, pi_lr, vf_lr,
                          max_ep_len, train_pi_iters, train_v_iters,
                          target_kl):
        """Builds the jitted `(st, noise) -> (st, EpochOut)` program.

        The rollout keeps the agent batch in the LANES dimension of the
        env physics — perturbed Hamiltonians are assembled directly as
        (n, n, A) tiles and diagonalised by the real-symmetric lanes
        Jacobi (ops/realform.transfer_amp_sym_lanes), the same layout
        that makes the MC sweep fast.  The scan body contains exactly ONE
        policy forward and ONE lanes eigh; bootstrap values and true
        fidelities are recomputed for the whole trajectory in single
        batched calls after the scan (VERDICT r1 weak #5 / ROADMAP #1a).
        """
        from code_robchar_tpu.ops import realform, select
        from code_robchar_tpu.models.env import (_normalise_time,
                                                 _wrap_action)

        cfg = self._cfg()
        h0 = jnp.real(self.env.sys)
        fixed = self.env.randH if self.use_fixed_ham else None
        fixed_r = (jnp.real(fixed) if fixed is not None and
                   jnp.iscomplexobj(fixed) else fixed)
        gamma, lam = self.gamma, self.lam
        n = self.nspin
        d = n + 1
        mul = self.train_size if self.use_fixed_ham else 1
        sweeps = self.rollout_sweeps
        dt = h0.dtype

        pi_tx = optax.adam(pi_lr)
        vf_tx = optax.adam(vf_lr)

        use_pallas = select.use_pallas()
        eff_sweeps = (sweeps if sweeps is not None
                      else realform._sweeps_for(dt, n))

        def sym_amp(ar, t):
            """(n, n, B), (B,) -> (phr, phi): the Pallas kernel or the XLA
            lanes path, as ops/select.py picks."""
            if use_pallas:
                from code_robchar_tpu.ops.pallas_jacobi import \
                    transfer_amp_sym_pallas
                return transfer_amp_sym_pallas(
                    ar, t, cfg.in_spin, cfg.out_spin, eff_sweeps)
            return realform.transfer_amp_sym_lanes(
                ar, t, cfg.in_spin, cfg.out_spin, eff_sweeps)

        def sym_fid(ar, t):
            phr, phi = sym_amp(ar, t)
            return phr * phr + phi * phi

        from code_robchar_tpu.ops import noise as _noise_mod

        def noise_ops_shot(k, f):
            return _noise_mod.shot_noise_fidelity(k, f, cfg.draws)

        def noise_ops_adaptive(k, f):
            return _noise_mod.adaptive_shot_fidelity(k, f, cfg.draws,
                                                     cfg.adp_tol)

        def reward_lanes(action, t, zdiag, znn):
            """(A,) training-objective fidelities with agents in lanes.
            zdiag (A, n) / znn (A, n-1) are this step's pre-scaled
            structured-noise draws (real variant, qnewton.py:366-379),
            precomputed for the whole epoch OUTSIDE the scan — a
            sequential rollout pays RNG launch overhead 500x otherwise."""
            a_cnt = action.shape[0]
            ar = jnp.broadcast_to(h0[:, :, None], (n, n, a_cnt)).astype(dt)
            add_diag = action.T.astype(dt)             # (n, A)
            if cfg.ham_noisy:
                add_diag = add_diag + zdiag.T
            for i in range(n):
                ar = ar.at[i, i].add(add_diag[i])
            if cfg.ham_noisy:
                for i in range(1, n):
                    ar = ar.at[i, i - 1].add(znn[:, i - 1])
                    ar = ar.at[i - 1, i].add(znn[:, i - 1])
            return sym_fid(ar, t.astype(dt))

        def reward_fixed_lanes(action, t):
            """Averaged-PROPAGATOR fixed-ham reward (RLreinforce...:153-162)
            — mean transfer amplitude over the ensemble, agents x ensemble
            flattened into lanes."""
            a_cnt = action.shape[0]
            r_cnt = fixed_r.shape[0]
            base = jnp.transpose(fixed_r, (1, 2, 0)).astype(dt)  # (n,n,R)
            ar = jnp.broadcast_to(base[:, :, None, :],
                                  (n, n, a_cnt, r_cnt))
            for i in range(n):
                ar = ar.at[i, i].add(action[:, i].astype(dt)[:, None])
            ar = ar.reshape(n, n, a_cnt * r_cnt)
            tt = jnp.repeat(t.astype(dt), r_cnt)
            phr, phi = sym_amp(ar, tt)
            phr = phr.reshape(a_cnt, r_cnt).mean(-1)
            phi = phi.reshape(a_cnt, r_cnt).mean(-1)
            return phr * phr + phi * phi

        def rollout(st: AgentState, noise):
            a_cnt = st.obs.shape[0]
            t_len = steps_per_epoch

            # ALL epoch randomness precomputed in three big batched draws
            # (policy-noise eps, structured ham noise, shot keys) and fed
            # to the scan as xs — the scan body contains ZERO RNG ops.
            key0 = st.key[0]
            k_eps, k_hn, k_shot, key_out = jax.random.split(key0, 4)
            eps_all = jax.random.normal(k_eps, (t_len, a_cnt, d), dt)
            if cfg.ham_noisy and fixed_r is None:
                zdiag_all = jax.random.normal(
                    k_hn, (t_len, a_cnt, n), dt) * noise
                znn_all = jax.random.normal(
                    jax.random.fold_in(k_hn, 1),
                    (t_len, a_cnt, n - 1), dt) * noise
            else:
                zdiag_all = jnp.zeros((t_len, 1, 1), dt)
                znn_all = jnp.zeros((t_len, 1, 1), dt)
            if cfg.fid_noisy:
                ks_all = jax.random.split(
                    k_shot, t_len * a_cnt).reshape(t_len, a_cnt)
            else:
                ks_all = jnp.zeros((t_len, 1), jnp.int32)

            def step(carry, xs):
                action, tstep, ep_len = carry
                eps, zdiag, znn, ks = xs

                obs = jnp.concatenate([action, tstep[:, None]], axis=1)
                # actor head ONLY: the sequential dependency is just
                # obs -> mu -> action.  Values and logps are recomputed
                # for the whole trajectory in ONE batched forward after
                # the scan, so the v-head weights (half the per-agent
                # parameter bytes) are read from HBM once per epoch
                # instead of once per step.
                mu, log_std = jax.vmap(ac.actor)(st.params, obs)
                a = mu + jnp.exp(log_std) * eps

                new_action = _wrap_action(action + a[:, :n], cfg.bmax)
                raw_t = tstep + a[:, n]
                # the PPO driver pins final_time to the accumulated time
                # (ppo.py:359-361); done fires when normalisation shrinks
                # the time below it (SURVEY.md quirk 9)
                t = _normalise_time(raw_t, cfg.maxtime)
                done = t > raw_t

                if fixed_r is not None:
                    fid = reward_fixed_lanes(new_action, t)
                else:
                    fid = reward_lanes(new_action, t, zdiag, znn)
                fcalls = jnp.full((a_cnt,), 1, jnp.int32)
                reward = fid
                if cfg.fid_noisy:
                    if cfg.adaptive:
                        reward, extra = jax.vmap(
                            lambda k, f: noise_ops_adaptive(k, f))(ks, fid)
                        fcalls = (extra + cfg.draws).astype(jnp.int32)
                    else:
                        reward = jax.vmap(
                            lambda k, f: noise_ops_shot(k, f))(ks, fid)

                obs2 = jnp.concatenate([new_action, t[:, None]], axis=1)
                ep_len = ep_len + 1
                ttimeout = ep_len == max_ep_len
                terminal = done | ttimeout
                next_action = jnp.where(terminal[:, None], 0.0, new_action)
                next_t = jnp.where(terminal, 0.0, t)
                ep_len = jnp.where(terminal, 0, ep_len)
                out = (obs, a, reward, obs2, done, ttimeout, fcalls)
                return (next_action, next_t, ep_len), out

            carry0 = (st.env.action, st.env.timestep, st.ep_len)
            (action, tstep, ep_len), traj = jax.lax.scan(
                step, carry0, (eps_all, zdiag_all, znn_all, ks_all),
                length=steps_per_epoch)
            env_st = EnvState(action=action, timestep=tstep,
                              final_time=tstep)
            obs_f = jnp.concatenate([action, tstep[:, None]], axis=1)
            # refresh the per-agent key leaf so the state layout survives
            keys_out = jax.random.split(key_out, a_cnt)
            return (env_st, obs_f, ep_len, keys_out), traj

        def update(params, pi_opt, vf_opt, data):
            obs, act, adv, logp_old, ret = data

            def pi_loss(p):
                mu, log_std, _ = ac.apply(p, obs)
                logp = ac.gaussian_logp(mu, log_std, act)
                ratio = jnp.exp(logp - logp_old)
                clipped = jnp.clip(ratio, 1 - clip_ratio, 1 + clip_ratio)
                loss = -jnp.mean(jnp.minimum(ratio * adv, clipped * adv))
                kl = jnp.mean(logp_old - logp)
                return loss, kl

            def pi_body(carry):
                p, opt, i, _ = carry
                (loss, kl), g = jax.value_and_grad(pi_loss, has_aux=True)(p)
                # the reference checks KL at the CURRENT params and
                # `break`s BEFORE backward()/step() (ppo.py:303-314): the
                # round that trips the gate must leave params untouched,
                # so the update computed this round is applied only when
                # the gate holds
                ok = kl <= 1.5 * target_kl
                updates, opt2 = pi_tx.update(g, opt, p)
                p2 = optax.apply_updates(p, updates)
                keep = lambda a, b: jnp.where(ok, b, a)
                p = jax.tree.map(keep, p, p2)
                opt = jax.tree.map(keep, opt, opt2)
                return p, opt, i + ok.astype(jnp.int32), kl

            def pi_cond(carry):
                _, _, i, kl = carry
                return (i < train_pi_iters) & (kl <= 1.5 * target_kl)

            # kl0 = 0 always passes the gate, so the first body round
            # runs unconditionally, exactly like the reference's first
            # for-iteration; pi_iters counts APPLIED updates (the break
            # round contributes 0).  kl0 is derived from a real pi_loss
            # eval only to pin the carry dtype under either x64 regime.
            _, kl0 = pi_loss(params)
            params, pi_opt, pi_iters, kl = jax.lax.while_loop(
                pi_cond, pi_body, (params, pi_opt, 0, kl0 * 0.0))

            def v_loss(p):
                return jnp.mean((ac.critic(p, obs) - ret) ** 2)

            def v_body(_, carry):
                p, opt = carry
                g = jax.grad(v_loss)(p)
                updates, opt = vf_tx.update(g, opt, p)
                p = optax.apply_updates(p, updates)
                return p, opt

            params, vf_opt = jax.lax.fori_loop(0, train_v_iters, v_body,
                                               (params, vf_opt))
            return params, pi_opt, vf_opt, kl, pi_iters

        use_wass_targets = self.use_wass_value_targets
        wass_reps = self.wass_bootstrap_reps

        def epoch(st: AgentState, noise):
            """st leaves carry a leading agent axis A (>= 1); noise is the
            sigma_train operand."""
            (env_st, obs_f, ep_len, key), traj = rollout(st, noise)
            (obs, act, rew, obs2, done, ttimeout, fc) = traj
            # traj leaves are (T, A, ...)
            t_len, a_cnt = rew.shape

            # values + logps for the whole trajectory in ONE batched
            # forward per agent (weights read once, M=T matmuls) —
            # numerically the same network on the same obs the scan
            # visited
            def val_logp(p, o, a):
                mu, log_std, v = ac.apply(p, o)
                return v, ac.gaussian_logp(mu, log_std, a)
            val, logp = jax.vmap(val_logp, in_axes=(0, 1, 1),
                                 out_axes=1)(st.params, obs, act)

            # true fidelities for the WHOLE trajectory in one lanes batch
            stores_flat = obs2.reshape(t_len * a_cnt, d)
            hs = jnp.broadcast_to(h0[:, :, None],
                                  (n, n, t_len * a_cnt)).astype(dt)
            for i in range(n):
                hs = hs.at[i, i].add(stores_flat[:, i].astype(dt))
            true_fid = sym_fid(
                hs, stores_flat[:, n].astype(dt)).reshape(t_len, a_cnt)

            # bootstrap values for the whole trajectory in one batched
            # forward per agent (ppo.py:409-417); zero when truly done
            vboot = jax.vmap(ac.critic,
                             in_axes=(0, 1), out_axes=1)(st.params, obs2)
            boot = jnp.where(done & ~ttimeout, 0.0, vboot)
            term = done | ttimeout
            # epoch end always closes the open trajectory (ppo.py:409-421)
            boundaries = term.at[-1].set(True)
            advs, rets = jax.vmap(
                lambda r, v, b, bo: gae_and_returns(r, v, b, bo, gamma,
                                                    lam),
                in_axes=1, out_axes=1)(rew, val, boundaries, boot)
            if use_wass_targets:
                # value targets become -W1(F(obs), delta(1)) per visited
                # controller (ppo.py:280-283), one vmapped batch; the
                # spec is built inside the trace so sigma stays an
                # operand
                from code_robchar_tpu.models import objectives
                spec = objectives.ObjectiveSpec(
                    h0=h0, in_spin=cfg.in_spin, out_spin=cfg.out_spin,
                    noise=noise, fid_noisy=False, ham_noisy=True,
                    draws=cfg.draws, adaptive=False, adp_tol=cfg.adp_tol,
                    fixed_hams=None, mul_fac=1)
                wass = objectives.make_wass_cost(spec, wass_reps)
                kw = jax.random.split(jax.random.fold_in(key[0], 11),
                                      t_len * a_cnt)
                rets = -jax.vmap(wass)(
                    obs.reshape(t_len * a_cnt, d), kw
                ).reshape(t_len, a_cnt)
            mean_a = advs.mean(axis=0, keepdims=True)
            std_a = advs.std(axis=0, keepdims=True)
            advs = (advs - mean_a) / jnp.maximum(std_a, 1e-8)

            # per-agent updates: move the agent axis in front
            def to_af(x):
                return jnp.moveaxis(x, 0, 1)
            obs_af, rets_af = to_af(obs), to_af(rets)
            params, pi_opt, vf_opt, kl, pi_iters = jax.vmap(update)(
                st.params, st.pi_opt, st.vf_opt,
                (obs_af, to_af(act), to_af(advs), to_af(logp), rets_af))
            st = AgentState(params=params, pi_opt=pi_opt, vf_opt=vf_opt,
                            env=env_st, obs=obs_f, ep_len=ep_len, key=key)
            out = EpochOut(rewards=to_af(rew), true_fids=to_af(true_fid),
                           stores=to_af(obs2), fcalls=to_af(fc) * mul,
                           kl=kl, pi_iters=pi_iters)
            return st, out

        epoch_jit = jax.jit(epoch)

        if self.num_agents == 1:
            # unbatched AgentState in, (T,)-shaped EpochOut leaves out
            def single(st: AgentState, noise):
                stb = jax.tree.map(lambda x: jnp.asarray(x)[None], st)
                stb2, out = epoch_jit(stb, noise)
                st2 = jax.tree.map(lambda x: x[0], stb2)
                out = jax.tree.map(lambda x: x[0], out)
                return st2, out
            return single
        return epoch_jit

    def _init_agent(self, key) -> AgentState:
        kp, kk = jax.random.split(key)
        cfg = self._cfg()
        env_st, obs = env_reset(cfg)
        params = ac.init(kp, obs.shape[-1], self.nspin + 1)
        pi_opt = optax.adam(3e-3).init(params)
        vf_opt = optax.adam(1e-3).init(params)
        return AgentState(params=params, pi_opt=pi_opt, vf_opt=vf_opt,
                          env=env_st, obs=obs, ep_len=jnp.asarray(0),
                          key=kk)

    # ---------------------------------------------------------------- run

    def run(self, seed=0, epochs=1000000, steps_per_epoch=500,
            clip_ratio=0.2, pi_lr=3e-3, vf_lr=1e-3, max_ep_len=1000,
            train_pi_iters=200, train_v_iters=200, target_kl=0.01,
            logger_kwargs=None, save_freq=10):
        if self.testing:
            seed_val = seed
        else:
            seed_val = self.seed_
        key = jax.random.key(seed_val)

        epoch_fn = self._build_epoch(steps_per_epoch, clip_ratio, pi_lr,
                                     vf_lr, max_ep_len, train_pi_iters,
                                     train_v_iters, target_kl)

        e = self.num_agents
        if e == 1:
            st = self._init_agent(key)
        else:
            st = jax.vmap(self._init_agent)(jax.random.split(key, e))
            if self.mesh is not None:
                from code_robchar_tpu.parallel import mesh as pmesh
                st = pmesh.shard_leading_tree(self.mesh, st, e)

        deadline = Deadline(self.timeout)
        top = TopControllers(self.save_topc)
        rr = RunRecord(landscape_exploration=self.landscape_exploration,
                       records_update_rate=self.records_update_rate,
                       run_until_completion_its=self.run_until_completion_its)
        self.record = rr.record
        self.records = rr.records

        funcalls = 0
        iterations = 0
        max_fid_seen = 0.0
        best_true = 0.0
        noisy_run = self.ham_noisy or self.fid_noisy

        for epoch_i in range(epochs):
            st, out = epoch_fn(st)
            rew = np.asarray(out.rewards).reshape(-1)
            true = np.asarray(out.true_fids).reshape(-1)
            stores = np.asarray(out.stores).reshape(-1, self.nspin + 1)
            fc = np.asarray(out.fcalls).reshape(-1)
            # the reference's iterations currency counts ONLY the value
            # loop — `iterations += train_v_iters` per epoch
            # (ppo.py:485); the pi loop's count is never added (its
            # StopIter logging is commented out).  One epoch here is e
            # reference runs in lockstep.
            iterations += train_v_iters * e

            cum = funcalls + np.cumsum(fc)

            # threshold stop with per-step resolution (ppo.py:441-448)
            if not self.run_until_told_to_stop:
                hits = np.nonzero(rew >= self.fid_threshold)[0]
                funcalls = int(cum[-1])
                m = rew.max()
                if m > max_fid_seen:
                    max_fid_seen = float(m)
                    best_true = float(true[rew.argmax()])
                if hits.size:
                    i = int(hits[0])
                    rr.save(func_calls=int(cum[i]), iterations=iterations,
                            repeats=epoch_i,
                            controller=stores[i].tolist(),
                            best_fid=float(true[i] if noisy_run
                                           else rew[i]), top=None)
                    if self.save:
                        self.save_record()
                    return max_fid_seen
            else:
                # budget stop with per-step resolution (ppo.py:471-478)
                budget = self.run_until_completion_its or np.inf
                over = np.nonzero(cum + 1 >= budget)[0]
                cut = int(over[0]) + 1 if over.size else len(rew)
                if self.landscape_exploration:
                    top.offer_many(rew[:cut], stores[:cut])
                i = int(rew[:cut].argmax())
                if rew[i] > max_fid_seen:
                    max_fid_seen = float(rew[i])
                    best_true = float(true[i])
                prev = rr.record["best_fid"]
                crit = True if self.landscape_exploration else (
                    rew[i] >= (self.fid_threshold if prev is None else prev))
                funcalls = int(cum[cut - 1])
                if crit:
                    rr.save(func_calls=funcalls, iterations=iterations,
                            repeats=epoch_i, controller=stores[i].tolist(),
                            best_fid=float(best_true if noisy_run
                                           else max_fid_seen), top=top)
                if over.size:
                    return max_fid_seen

            if self.verbose:
                print(f"max_fid_obtained: {max_fid_seen}, true_fid: "
                      f"{best_true}, func calls {funcalls}, "
                      f"kl {np.asarray(out.kl).mean():.4f}")
            deadline.check(self.filename)
        return max_fid_seen

    # --------------------------------------------------------- persistence

    def save_record(self):
        from code_robchar_tpu.utils import io
        io.dump_json(self.record, self.filename)

    def read_record(self):
        return __import__("json").load(open(self.filename))

    def find_min_fid_index(self, controller_list):
        fids = [self.Monte_env.fidelity_ss(c) for c in controller_list]
        return int(np.argmin(fids))
