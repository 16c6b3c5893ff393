"""Operations and bytes from shapes, and the card's published peaks."""

import importlib

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit.
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def flops(config: dict):
    """The FLOP counter a configuration names (``"flops"``: a module of this
    package with ``forward_flops(config, size, ...)``)."""
    return importlib.import_module(f"bench_h100.work.{config['flops']}")
