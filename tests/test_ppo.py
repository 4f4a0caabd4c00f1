"""PPO trainer tests: record protocol, fcall accounting, learning signal."""

import numpy as np

from code_robchar_tpu.models import PPO_en


def test_ppo_budget_mode_and_topc():
    ppo = PPO_en(3, 0, 2, testing=True, fid_threshold=0.0,
                 run_until_told_to_stop=True, run_until_completion_its=200,
                 landscape_exploration=True, save_topc=20, max_time=30)
    best = ppo.run(steps_per_epoch=64, train_pi_iters=3, train_v_iters=3)
    assert 0 <= best <= 1 + 1e-9
    # budget stop with per-step resolution: func_calls lands on the budget
    assert ppo.record["func_calls"] + 1 >= 200
    assert ppo.record["func_calls"] <= 200
    assert "controllers" in ppo.record
    assert 1 <= len(ppo.record["controllers"]) <= 20
    # controllers have the (biases..., time) layout
    assert len(ppo.record["controllers"][0]) == 4


def test_ppo_threshold_mode():
    ppo = PPO_en(3, 0, 2, testing=True, fid_threshold=0.05,
                 run_until_told_to_stop=False)
    best = ppo.run(steps_per_epoch=64, train_pi_iters=2, train_v_iters=2,
                   epochs=50)
    assert best >= 0.05
    assert ppo.record["controller"] is not None
    assert ppo.record["func_calls"] > 0


def test_ppo_multi_agent_vmap():
    ppo = PPO_en(3, 0, 2, testing=True, fid_threshold=0.0,
                 run_until_told_to_stop=True, run_until_completion_its=400,
                 landscape_exploration=True, save_topc=10, num_agents=4)
    best = ppo.run(steps_per_epoch=32, train_pi_iters=2, train_v_iters=2)
    assert 0 <= best <= 1 + 1e-9
    assert len(ppo.record["controllers"]) >= 1


def test_ppo_fixed_ham_fcall_multiplier():
    ppo = PPO_en(3, 0, 2, testing=True, fid_threshold=0.0,
                 run_until_told_to_stop=True, run_until_completion_its=3200,
                 landscape_exploration=True, save_topc=5,
                 use_fixed_ham=True, opt_train_size=8)
    ppo.run(steps_per_epoch=32, train_pi_iters=2, train_v_iters=2)
    # each env step bills train_size calls (ppo.py:365-366)
    assert ppo.record["func_calls"] % 8 == 0


def test_ppo_kl_gate_rejects_tripping_update():
    """The reference checks KL at the current params and breaks BEFORE
    stepping (ppo.py:303-314): the round that trips the gate must leave
    params untouched.  With target_kl ~ 0 the gate trips at the first
    post-update KL, so the epoch must apply exactly ONE pi update and
    land on the same params as an explicit train_pi_iters=1 run (same
    seed => identical rollout)."""
    import jax
    import numpy as np

    def one(pi_iters, tkl):
        ppo = PPO_en(4, 0, 2, testing=True, num_agents=4, seed=7,
                     ham_noisy=True)
        fn = ppo._build_epoch(steps_per_epoch=8, clip_ratio=0.2,
                              pi_lr=3e-3, vf_lr=1e-3, max_ep_len=1000,
                              train_pi_iters=pi_iters, train_v_iters=1,
                              target_kl=tkl)
        st = jax.vmap(ppo._init_agent)(
            jax.random.split(jax.random.key(5), 4))
        return fn(st)

    st_gate, out_gate = one(5, 1e-9)   # gate trips after update 1
    st_one, _ = one(1, 1e9)           # exactly 1 update, gate never trips

    # the tripping round applied no update: counted 1, not 2
    np.testing.assert_array_equal(np.asarray(out_gate.pi_iters),
                                  np.ones(4, dtype=np.int32))
    for a, b in zip(jax.tree.leaves(st_gate.params),
                    jax.tree.leaves(st_one.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
