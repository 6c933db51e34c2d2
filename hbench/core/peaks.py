"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, no
sparsity; at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12  # tensor cores
F32_FLOPS = 67e12  # outside the tensor cores
SMS = 132
MUFU_PER_CLOCK_PER_SM = 16  # ex2, lg2, rcp results a clock an SM
SM_CLOCK_HZ = 1.98e9  # the H100 SXM's boost clock


def least_seconds(nbytes: float, flops: float = 0.0, flops_per_s: float = F32_FLOPS,
                  mufu: float = 0.0) -> float:
    """The least time of a launch: bytes over HBM bandwidth, operations
    over their rate, MUFU results over 132 SMs × 16 a clock, the longest."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flops_per_s,
               mufu / (SMS * MUFU_PER_CLOCK_PER_SM * SM_CLOCK_HZ))
