"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at the full
700 W power limit; a card set lower runs slower, so every roofline share
is printed with the card's power limit beside it)."""

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = {
    "bf16": 989e12,     # tensor cores, bf16 / fp16 products
    "int8": 1979e12,    # tensor cores, int8
    "tf32": 495e12,
    "fp32": 67e12,      # outside the tensor cores
}


def least_seconds(work: dict) -> float:
    """The least time the work needs: the larger of its bytes at the HBM
    rate and its operations, each kind at its own peak."""
    t_ops = sum(n / OPS_PER_S[kind] for kind, n in work["ops"].items())
    return max(work["bytes"] / HBM_BYTES_PER_S, t_ops)
