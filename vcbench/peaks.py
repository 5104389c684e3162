"""The H100's peaks and the roofline rule, frozen from the repository's
chip smoke test (NVIDIA's data sheet, SXM part, dense rates, 700 W).

The f32 attention kernels do each f32 product as three TF32 ones (3xTF32),
so their bound is three times the f32 operations at the TF32 peak.
"""

PEAK_BF16 = 989e12
PEAK_TF32 = 495e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
K2_FLOPS = 98  # K2's operations per output element (24 FIR FMAs, two sin^2, ...)


def bound(ops: float, peak_ops: float, nbytes: float) -> float:
    """Least seconds for ``ops`` operations at ``peak_ops`` and ``nbytes``
    moved at the memory peak: the larger of the two."""
    return max(ops / peak_ops, nbytes / PEAK_BYTES)


def bound_3xtf32(ops: float, nbytes: float) -> float:
    return bound(3 * ops, PEAK_TF32, nbytes)


def k1_bf16(B: int, H: int, Tq: int, Tk: int, n_valid_sum: int, d: int = 64) -> float:
    """K1 (bf16, RoPE fused) over valid keys: 4 d Tq H n_valid per batch row;
    q, k, v read and out written once, plus the two (Tk, d) f32 tables and lens."""
    ops = 4.0 * d * Tq * H * n_valid_sum
    nbytes = 2 * (Tq + Tk) * B * H * d * 2 + 2 * Tk * d * 4 + B * 4
    return bound(ops, PEAK_BF16, nbytes)


def k1_f32(B: int, H: int, T: int, n_valid_sum: int, d: int = 64) -> float:
    """K1 f32 at the 3xTF32 bound (the forward with its row statistics)."""
    ops = 4.0 * d * T * H * n_valid_sum
    nbytes = 2 * (T + T) * B * H * d * 4 + 2 * T * d * 4 + B * 4 + B * H * T * 4
    return bound_3xtf32(ops, nbytes)


def k1b_f32(B: int, H: int, T: int, d: int = 64) -> float:
    """K1ᵇ f32: 10 B H T^2 d operations at 3xTF32; q, k, v, o, dO in and
    dq, dk, dv out, the tables and the row statistics."""
    ops = 10.0 * B * H * T * T * d
    nbytes = 8 * B * H * T * d * 4 + 2 * T * d * 4 + B * H * T * 4
    return bound_3xtf32(ops, nbytes)


def k2(B: int, C: int, T: int) -> float:
    n = B * C * T
    return bound(K2_FLOPS * n, PEAK_F32, 8 * n + 8 * C)
