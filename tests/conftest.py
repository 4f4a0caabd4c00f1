"""Test harness configuration.

All tests run in the parity regime: CPU backend (so float64/complex128 are
LAPACK-exact, matching the reference's numpy/scipy numerics for the 1e-10
fidelity-parity bar) with 8 virtual devices so the multi-device sharding
path (`jax.sharding.Mesh` + shard_map) is exercised without a GPU.  Tests
marked ``gpu`` need the card and skip here; ``chip_smoke.py`` runs the
same checks on the GPU in its own process.
"""

import os

# Must be set before the first CPU client is created.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# No persistent compilation cache under pytest: the suite already skirts a
# jaxlib 0.9.0 XLA-CPU compile crash (see _clear_jax_caches_between_modules
# below); keeping the on-disk cache's serialize/deserialize work out of the
# same fragile path makes full-suite runs deterministic.  Production runs
# keep the cache (config.py).
os.environ.setdefault("ROBCHAR_NO_COMPILATION_CACHE", "1")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def _jaxlib_needs_cache_clear(version: str = None) -> bool:
    """True when the per-module `jax.clear_caches()` workaround is still
    needed: the XLA:CPU compile segfault it skirts is pinned to jaxlib
    0.9.0 (artifacts/xla_cpu_segfault_findings.md).  Self-retiring
    (VERDICT r3 weak #5): newer jaxlibs skip the workaround, and
    tests/test_shims.py::test_xla_cpu_segfault_canary re-runs the
    committed stress repro on upgrade so the verdict (crash fixed vs
    re-pin this bound) surfaces automatically."""
    import re

    if version is None:
        import jaxlib
        version = jaxlib.__version__
    parts = []
    for p in version.split(".")[:3]:
        # LEADING digits only: a pre-release like "0.9.0rc1" must stay
        # on the broken 0.9.0 line ("0rc1" -> 0, not "01" -> 1, which
        # would disable the workaround on a release candidate of the
        # very version the crash is pinned to)
        m = re.match(r"\d+", p)
        parts.append(int(m.group()) if m else 0)
    return tuple(parts) <= (0, 9, 0)


NEEDS_CACHE_CLEAR = _jaxlib_needs_cache_clear()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables at module boundaries.

    A full serial suite run compiles ~10^2 distinct XLA CPU programs in
    one process; letting them all stay live segfaults jaxlib 0.9.0's
    native compile path (`backend_compile_and_load`) during a late
    compile — diagnosed upstream-of-repo in
    artifacts/xla_cpu_segfault_findings.md (reproducibly at the same
    test; isolated runs of that test are fine).  Modules share
    essentially no jitted programs, so per-module clearing costs
    nothing and keeps the compiler healthy.

    Set ROBCHAR_NO_CACHE_CLEAR=1 to reproduce the crash (bisection
    hook for future jax upgrades).  Version-gated: jaxlib > 0.9.0 skips
    the workaround entirely (see _jaxlib_needs_cache_clear)."""
    yield
    if NEEDS_CACHE_CLEAR and not os.environ.get("ROBCHAR_NO_CACHE_CLEAR"):
        # the cross-instance program cache (models/base._PROGRAM_CACHE)
        # holds PjitFunctions at module scope — drop those references
        # first or clear_caches() can't release their executables
        from code_robchar_tpu.models import base as _mbase
        _mbase._PROGRAM_CACHE.clear()
        jax.clear_caches()


# ---------------------------------------------------------------------------
# quick tier: `pytest -m quick` runs the sub-5s tests (< 2 min wall) so CI
# has a fast gate; the full suite stays the release gate.  Durations from a
# full CPU run are pinned here — re-tier when kernels change materially.
# ---------------------------------------------------------------------------

_SLOW_TESTS = {
    # round-5 additions
    "tests/test_models.py::test_nmplus_outcome_distribution_matches_scipy",
    "tests/test_reference_interop.py::"
    "test_ppo_outcome_quality_vs_shipped_store",
    "tests/test_reference_interop.py::"
    "test_vendored_snobfit_distribution_vs_shipped",
    "tests/test_figs_coverage.py::test_fig8_sidecar_staleness_matrix",
    # round-4 additions
    "tests/test_models.py::test_adam_restart_table_never_wraps",
    # round-3 additions
    "tests/test_models.py::"
    "test_program_cache_shares_compiles_across_sigma_cells",
    "tests/test_models.py::test_ppo_epoch_program_shared_across_sigma_cells",
    "tests/test_models.py::test_lbfgs_lane_recycling_preserves_restarts",
    "tests/test_models.py::test_nmplus_lane_recycling_preserves_restarts",
    "tests/test_pallas.py::test_pallas_sym_grad_matches_lanes_interpret",
    "tests/test_pallas.py::test_pallas_sym_amp_matches_lanes_interpret",
    "tests/test_parallel.py::"
    "test_sharded_zoo_restarts_deterministic_and_equivalent",
    "tests/test_parallel.py::test_sharded_zoo_all_families_smoke",
    "tests/test_parallel.py::test_experiment_sharded_ccollector_end_to_end",
    "tests/test_models.py::test_budget_overshoot_bounded",
    "tests/test_models.py::test_lbfgs_outcome_distribution_matches_scipy",
    "tests/test_models.py::test_lbfgs_use_wass_cost_changes_objective",
    "tests/test_models.py::test_lbfgs_wass_billing_is_reps_per_eval",
    "tests/test_reference_interop.py::test_snob_calibration_ks_guardrail",
    "tests/test_reference_interop.py::test_snob_heldout_ks_recorded",
    "tests/test_parallel.py::test_lbfgs_mesh_kwarg_public_run",
    "tests/test_parallel.py::test_adam_mesh_kwarg_public_run",
    "tests/test_parallel.py::test_ppo_mesh_kwarg_public_run",
    "tests/test_realform.py::test_jacobi_herm_matches_lapack",
    "tests/test_mc.py::test_fused_metric_sweep_chunk_invariance",
    "tests/test_propagate.py::test_jacobi_eigh_matches_lapack",
    "tests/test_more_coverage.py::test_run_var_spins",
    "tests/test_realform.py::test_fidelity_herm_parity",
    "tests/test_realform.py::test_fidelity_sym_parity",
    "tests/test_models.py::test_lbfgs_ham_noisy_runs",
    "tests/test_experiment.py::test_singlerun_ccollector_le_schema_and_mc_interop",
    "tests/test_pallas.py::test_pallas_matches_lanes_interpret",
    "tests/test_pallas.py::test_pallas_auto_tile_padded_width_interpret",
    "tests/test_realform.py::test_jacobi_sym_matches_lapack",
    "tests/test_shims.py::test_ppo_wass_value_targets_smoke",
    "tests/test_reference_interop.py::test_shipped_mc_tensor_numeric_parity[N6_0-5]",
    "tests/test_mc.py::test_fused_metric_sweep_matches_unfused",
    "tests/test_models.py::test_snob_budget_accounting",
    "tests/test_experiment.py::test_var_noise_record_schema",
    "tests/test_models.py::test_fixed_ham_multiplier_accounting",
    "tests/test_models.py::test_nmplus_threshold_mode",
    "tests/test_more_coverage.py::test_env_golden_n10",
    "tests/test_models.py::test_adam_restart_retry_and_per_stream_candidates",
    "tests/test_more_coverage.py::test_characterise_one_call",
    "tests/test_ppo.py::test_ppo_multi_agent_vmap",
    "tests/test_ppo.py::test_ppo_fixed_ham_fcall_multiplier",
    "tests/test_reference_interop.py::test_shipped_mc_tensor_numeric_parity[N5_0-2]",
    "tests/test_ppo.py::test_ppo_budget_mode_and_topc",
    "tests/test_models.py::test_lbfgs_gradient_quality_vs_scipy_budget",
    "tests/test_mc.py::test_sweep_element_matches_direct_evaluation",
    "tests/test_models.py::test_lbfgs_noiseless_threshold_mode",
    "tests/test_parallel.py::test_sharded_fused_metrics_match_unsharded",
    "tests/test_more_coverage.py::test_adaptive_shot_optimizer_accounting",
    "tests/test_experiment.py::test_respawn_skips_completed_cells",
    "tests/test_models.py::test_lbfgs_landscape_exploration_collects_topc",
    "tests/test_parallel.py::test_sharded_sweep_bitwise_matches_unsharded",
    "tests/test_realform.py::test_batched_shapes",
    "tests/test_shims.py::test_lbfgs_reference_surface",
    "tests/test_propagate.py::test_fidelity_via_jacobi_matches_lapack_path",
    "tests/test_mc.py::test_characterise_cpu_autoselects_xla",
    "tests/test_experiment.py::test_nstoch_sampling_stores_checkpoints",
    "tests/test_models.py::test_adam_improves_under_budget",
    "tests/test_reference_interop.py::test_shipped_lbfgs_baseline_key",
    "tests/test_reference_interop.py::test_shipped_store_characterises",
    "tests/test_reference_interop.py::test_fig1_reads_real_legacy_records",
    "tests/test_reference_interop.py::test_shipped_mc_tensor_numeric_parity[N4_0-2]",
    "tests/test_figs.py::test_fig8_scaling",
    "tests/test_parallel.py::test_ppo_mesh_sharded_epoch_run",
    "tests/test_models.py::test_nm_stagnation_restart_fires",
    "tests/test_realform.py::test_gradient_sym_parity",
    "tests/test_realform.py::test_fidelity_sym_lanes_matches_rows",
    "tests/test_ppo.py::test_ppo_threshold_mode",
    "tests/test_figs.py::test_fig1_cdf_area",
    "tests/test_mc.py::test_sweep_shape_and_zero_noise_determinism",
    "tests/test_realform.py::test_gradient_sym_degenerate_ring",
    "tests/test_realform.py::test_f32_sweep_policy_converges_on_hard_spectra",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "quick: fast test tier (< 2 min)")
    config.addinivalue_line("markers", "slow: compile-heavy test")
    config.addinivalue_line(
        "markers", "gpu: needs the GPU (skips elsewhere; chip_smoke.py "
        "runs the same checks on the card)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.nodeid in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)
        else:
            item.add_marker(pytest.mark.quick)
