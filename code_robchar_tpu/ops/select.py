"""The one place that picks the eigensolver kernel for a platform.

The program runs on two platforms: ``"gpu"``, where the Jacobi
fidelity, amplitude and gradient go through the Pallas kernels of
ops/pallas_jacobi.py (Triton route), and ``"cpu"``, where they take the
XLA lanes path of ops/realform.py (the tests and the f64 parity regime).
Any other platform is an error, not a fallback.
"""

from __future__ import annotations

from typing import Optional

import jax

KERNELS = {"gpu": "triton", "cpu": "xla"}


def jacobi_kernel(platform: Optional[str] = None) -> str:
    """``"triton"`` or ``"xla"`` for ``platform`` (default: JAX's
    default backend)."""
    platform = platform or jax.default_backend()
    try:
        return KERNELS[platform]
    except KeyError:
        raise ValueError(
            f"unsupported platform {platform!r}: this program runs on "
            f"{sorted(KERNELS)}") from None


def use_pallas(platform: Optional[str] = None) -> bool:
    """Whether the Pallas Jacobi kernels run on ``platform``."""
    return jacobi_kernel(platform) == "triton"
