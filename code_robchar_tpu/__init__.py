"""code_robchar_tpu — a JAX framework for statistically characterising
robustness and fidelity of quantum controls on Heisenberg XX/XXZ spin chains.

A ground-up JAX/XLA/Pallas re-design of the capabilities of
qyber-black/Code-RobChar (arXiv:2207.07801).  The design stance: *the batch is
the program*.  Controllers, noise draws, bootstrap repetitions, optimizer
restarts and noise levels are all `vmap` axes over a single pure fidelity
kernel; `jax.sharding` + `shard_map` over a device mesh shards those batch
axes across chips.

Layout (each subpackage cites the reference files whose capability it covers):

- ``ops``      physics + numeric kernels: chain Hamiltonians, batched
               eigendecomposition propagators, analytic fidelity gradients,
               noise models, shot-noise protocols
               (reference: qnewton.py, noise_model.py,
               RLreinforceXXchain_actionedtime.py L0/L1 layers)
- ``metrics``  RIM / Wasserstein robustness metrics, DKW bounds, statistical
               tests (reference: wd_sortof_fast_implementation.py, mcsim.py)
- ``mc``       the cachable Monte-Carlo robustness engine
               (reference: mcsim.py MCDataSim)
- ``models``   the optimizer zoo + RL controller synthesis
               (reference: qnewton.py LBFGS/Adam/SNOB, nmplus.py, ppo.py)
- ``parallel`` device-mesh sharding of the MC / optimizer batch axes
- ``exp``      experiment orchestration, naming, checkpoint/respawn, CLI
               (reference: noise_analysis.py, parse.py)
- ``figs``     the paper figure generators (reference: generate_*.py)
- ``utils``    cache-file conventions, record protocol, timeouts
"""

__version__ = "0.1.0"

from code_robchar_tpu import config as config  # noqa: F401
