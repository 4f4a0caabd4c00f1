"""Floating-point operations and device-memory bytes of one element of
each Jacobi transfer kernel, from (kind, n, sweeps) alone.

The count is of the algorithm, not of any implementation: a cyclic
Jacobi eigensolver of an n x n matrix, ``sweeps`` sweeps of n(n-1)/2
rotations, each rotation built in closed form (Rutishauser angles) and
applied to the n - 2 other rows of the matrix (through its symmetry), to
the 2x2 pivot block, and to the carried rows of the eigenvector matrix;
then the transfer amplitude (and, for ``sym_grad``, the exact gradient).
Additions, subtractions, multiplications, divisions, square roots, sines
and cosines count one each; comparisons, selects and sign changes count
none.  A fused multiply-add counts two, as the peak rate counts it.

Bytes are what the kernel must move through device memory for one
element at the configuration's dtype: the matrix's independent entries
and the readout time in, its results out.

Kinds:
- ``herm_fid``: complex Hermitian matrix, 2 carried complex rows, the
  fidelity out (characterisation);
- ``sym_amp``: real symmetric, 2 carried rows, the amplitude's two parts
  out (the RL environment);
- ``sym_grad``: real symmetric, all n rows carried, the infidelity and
  its gradient over the n biases and the time out (optimizer training).
"""

from __future__ import annotations

KINDS = ("herm_fid", "sym_amp", "sym_grad")


def rotation_flops(kind: str, n: int) -> int:
    """Operations of one rotation at pivot (p, q)."""
    if kind == "herm_fid":
        # r = |a_pq| (4), activity test eps (|a_pp| + |a_qq| + r) (3),
        # phase a_pq / r (2), tau = (a_qq - a_pp) / 2r (3),
        # t = sign(tau) / (|tau| + sqrt(1 + tau^2)) (5),
        # c = 1 / sqrt(1 + t^2) (4), s = t c (1), shift t r (1)
        angle = 23
        # one complex row pair (x, y) -> (c x - s conj(ph) y,
        # s ph x + c y): two unit-phase products (6 each), then two
        # complex combinations (6 each)
        pair = 24
        rows = 2
    elif kind in ("sym_amp", "sym_grad"):
        # activity test (3), tau (3), t (5), c (4), s (1), shift (1)
        angle = 17
        pair = 6          # (c x - s y, s x + c y)
        rows = 2 if kind == "sym_amp" else n
    else:
        raise ValueError(f"unknown kernel kind {kind!r}; known {KINDS}")
    # the n - 2 other entries of the pivot columns (their rows follow by
    # symmetry), the two pivot diagonal entries, the carried rows
    return angle + pair * (n - 2) + 2 + pair * rows


def readout_flops(kind: str, n: int) -> int:
    """Operations after the last sweep."""
    if kind == "herm_fid":
        # per eigenvalue: g = v_out conj(v_in) (6), angle (1), cos and sin
        # (2), g e^{-i t lam} (6); n - 1 complex accumulations (2 each);
        # |amp|^2 (3)
        return 15 * n + 2 * (n - 1) + 3
    if kind == "sym_amp":
        # per eigenvalue: w = v_out v_in (1), angle (1), cos and sin (2),
        # w cos and w sin (2); n - 1 accumulations (2 each)
        return 6 * n + 2 * (n - 1)
    if kind == "sym_grad":
        pairs = n * (n + 1) // 2
        # per eigenvalue: the two phase parts (4) and w (1); amplitude and
        # H U parts: 4 to start, 10 per further eigenvalue; infidelity (4)
        amp = 5 * n + 4 + 10 * (n - 1) + 4
        # per unordered pair j <= k: half-gap (3), mean phase (3), the two
        # Daleckii-Krein parts (6), the weighted parts (2); off the
        # diagonal also sinc (2) and the pair weight (3); then for each of
        # the n biases V[l,j] V[l,k] (1) and two multiply-adds (4), less
        # the additions of the first pair (2 per bias)
        grad = 14 * n + 19 * (n * (n - 1) // 2) + 5 * n * pairs - 2 * n
        # per bias: -2 (dr phr + di phi) (4); the time derivative (4)
        return amp + grad + 4 * n + 4
    raise ValueError(f"unknown kernel kind {kind!r}; known {KINDS}")


def flops_per_element(kind: str, n: int, sweeps: int) -> int:
    rotations = sweeps * n * (n - 1) // 2
    return rotations * rotation_flops(kind, n) + readout_flops(kind, n)


def bytes_per_element(kind: str, n: int, itemsize: int = 4) -> int:
    """Device-memory bytes of one element: inputs read and outputs
    written once."""
    if kind == "herm_fid":
        # n real diagonal entries, n(n-1)/2 complex off-diagonal ones,
        # the time; the fidelity
        return itemsize * (n * n + 1 + 1)
    if kind in ("sym_amp", "sym_grad"):
        upper = n * (n + 1) // 2 + 1      # triangle and the time
        out = 2 if kind == "sym_amp" else 1 + (n + 1)
        return itemsize * (upper + out)
    raise ValueError(f"unknown kernel kind {kind!r}; known {KINDS}")


def least_seconds(kind: str, n: int, sweeps: int, elements: float,
                  peaks: dict, itemsize: int = 4):
    """(seconds, bound) the chip needs at least for ``elements`` elements:
    the larger of operations over the peak rate and bytes over the peak
    bandwidth, and which of the two it is."""
    t_flop = elements * flops_per_element(kind, n, sweeps) / \
        peaks["fp32_flops_per_s"]
    t_mem = elements * bytes_per_element(kind, n, itemsize) / \
        peaks["hbm_bytes_per_s"]
    return (t_flop, "compute") if t_flop >= t_mem else (t_mem, "memory")
