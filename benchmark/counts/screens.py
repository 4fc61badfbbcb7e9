"""Operation and byte counts of the two screen kernels, and the least
time the card could take for them.

Frozen copies of ``chip_smoke.py`` at commit d674a25 (lines 189-190 and
340-372: ``PEAK_F32_FLOPS``, ``PEAK_BYTES``, ``bound_ms``,
``screen_bytes``, ``quadratic_flops``, ``cahbn_flops``), unchanged, so
that a later change to the program cannot move the yardstick. Peaks: one
NVIDIA H100 SXM, float32 outside the tensor cores and HBM3 bandwidth,
NVIDIA's data sheet, at the full 700 W power limit.
"""

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


def bound_ms(flops, nbytes):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def screen_bytes(args, N, G):
    """Each input read once and each output (N bools, G floats) written once."""
    return sum(a.numel() * a.element_size() for a in args if a is not None) + N + 4 * G


def quadratic_flops(N, r, k, substeps):
    """Float32 operations of one kernel A launch, counted from
    csrc/quadratic_screen.cu: per right-hand side r(r+1)/2 products and
    r (r + r(r+1)/2) multiply-adds; per RK4 step four of them and 13 r
    for the stage combinations. Data-independent."""
    P = r * (r + 1) // 2
    rhs = P + 2 * r * (r + P)
    return N * (k - 1) * substeps * (4 * rhs + 13 * r)


def cahbn_flops(N, r, nu, k, substeps, newton_iters):
    """Float32 operations of one kernel B launch, counted from
    csrc/cahbn_screen.cu (a multiply-add is two, a division one).
    Data-independent: the Newton count is fixed."""
    P = r * (r + 1) // 2
    rhs = P + nu * r + 2 * r * (r + P + nu + nu * r)
    newton_matrix = r * r * (2 * (r + 1) + 2 * nu + 2)
    eliminate = sum(1 + (r - 1 - p) * (1 + 2 * (r - 1 - p) + 2) for p in range(r))
    eliminate += sum(2 * (r - 1 - i) + 1 for i in range(r))
    newton = rhs + newton_matrix + eliminate + 4 * r
    substep = rhs + 2 * newton_iters * newton + 2 * r + 5 * r
    return N * (k - 1) * substeps * substep
