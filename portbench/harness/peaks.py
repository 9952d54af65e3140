"""Peaks of one NVIDIA H100 SXM (80 GB HBM3) and the kernels' bounds.

The fp32 instruction rate outside the tensor cores is 132 SMs x 128 lanes
x 1980 MHz (the top SM clock); the memory rate is the data sheet's 3.35
TB/s. Both assume the full 700 W power limit, which each traced run prints
beside its numbers.
"""

SMS = 132
LANES_PER_SM = 128
SM_CLOCK_HZ = 1.98e9
FP32_INSTR_PER_S = SMS * LANES_PER_SM * SM_CLOCK_HZ  # 33.45e12
HBM_BYTES_PER_S = 3.35e12


def k1_bound_s(S, R, d, k):
    """Least seconds of one bin-fold kNN: S queries against R refs of d
    float32 coordinates, 3d + 2 instructions a pair (d differences, d
    multiply-adds as a multiply and an add, a compare and a select), or
    the refs and queries read once and the (S, k) values and indices
    written once, whichever is longer."""
    compute = S * R * (3 * d + 2) / FP32_INSTR_PER_S
    memory = (4 * d * (R + S) + 8 * S * k) / HBM_BYTES_PER_S
    return max(compute, memory)
