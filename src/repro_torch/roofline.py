"""Published peak rates of one NVIDIA H100 SXM (80 GB HBM3), the card the
port targets.  Source: NVIDIA H100 Tensor Core GPU data sheet (dense rates,
no sparsity), as tabulated in the Hopper architecture white paper.  They
assume the card's full 700 W power limit; a card set lower runs slower, so
every measurement states the limit it ran under.

The JAX package's ``repro.roofline`` holds TPU v5e constants and is not
used by the port."""

HBM_BW = 3.35e12            # bytes/s, device memory
PEAK_BF16 = 989e12          # FLOP/s, bf16 tensor cores (dense)


def bound_seconds(nbytes: float, flops: float = 0.0,
                  peak: float = PEAK_BF16) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the memory
    rate and operations over ``peak``.  Returns (seconds, "bytes" or
    "operations")."""
    mem, ops = nbytes / HBM_BW, flops / peak
    return (mem, "bytes") if mem >= ops else (ops, "operations")
