"""Threefry-2x32 counter-based draws in plain NumPy.

The characterisation engine draws every lattice element's noise from a
key it derives from the call's key (the engine's documented derivation):

    k_e          = fold_in(key, gid)          gid = (l * C + c) * B + b
    kd, kn, k2   = split(k_e, 3)
    diag         = normal(kd, (n,))   * sigma_l
    nn           = normal(kn, (n-1,)) * sigma_l   real couplings
    nn2          = normal(k2, (n-1,)) * sigma_l   imaginary couplings

This module re-derives those draws from the raw key words, without JAX,
following the published Threefry-2x32 hash (Salmon et al., SC'11, 20
rounds) and JAX's documented counter layout with
``jax_threefry_partitionable`` on (its default): split and random bits
hash a 64-bit iota split into (hi, lo) words, and 32-bit draws are the
XOR of the two output words.  A normal is ``sqrt(2) * erfinv(u)`` of a
float32 uniform ``u`` on [nextafter(-1, 0), 1); the uniform is formed
bit for bit as the float32 program forms it, and ``erfinv`` is then taken
in float64.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfinv

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block function, elementwise over broadcast
    uint32 arrays.  Returns the two output words."""
    with np.errstate(over="ignore"):
        k1 = np.asarray(k1, np.uint32)
        k2 = np.asarray(k2, np.uint32)
        ks = (k1, k2, k1 ^ k2 ^ _PARITY)
        x = [np.asarray(x1, np.uint32) + ks[0],
             np.asarray(x2, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def fold_in(key, data):
    """fold_in(key, data) for a vector of uint32 ``data``: returns the
    (k1, k2) word arrays of the folded keys."""
    data = np.asarray(data, np.uint32)
    return threefry2x32(key[0], key[1], np.zeros_like(data), data)


def split(keys, num: int):
    """split(k, num) for each key of the (k1, k2) word arrays ``keys``:
    returns a list of ``num`` (k1, k2) pairs."""
    return [threefry2x32(keys[0], keys[1], np.uint32(0), np.uint32(i))
            for i in range(num)]


def bits32(keys, count: int):
    """random_bits(k, 32, (count,)) for each key: (m, count) uint32."""
    k1 = np.asarray(keys[0], np.uint32)[:, None]
    k2 = np.asarray(keys[1], np.uint32)[:, None]
    lo = np.arange(count, dtype=np.uint32)[None, :]
    b1, b2 = threefry2x32(k1, k2, np.uint32(0), lo)
    return b1 ^ b2


def normal(keys, count: int) -> np.ndarray:
    """normal(k, (count,), float32) for each key, the uniform taken bit
    for bit and the inverse error function in float64: (m, count)."""
    bits = bits32(keys, count)
    one = np.array(1.0, np.float32)
    fl = ((bits >> np.uint32(9)) | one.view(np.uint32)).view(np.float32)
    fl = fl - one
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = np.maximum(lo, fl * (one - lo) + lo)
    return np.sqrt(2.0) * erfinv(u.astype(np.float64))
