"""What several per-layer readers share."""

from __future__ import annotations

import re
from typing import Optional

# kernels that compute a matrix product: cuBLAS, cuBLASLt and CUTLASS names
# (sm90 "nvjet", "xmma" and "gemm" kernels, split-K reductions) and the
# port's own wgmma kernels
GEMM = re.compile(r"gemm|xmma|nvjet|cutlass|cublas|splitKreduce|wgmma",
                  re.IGNORECASE)


def idle_pct(trace) -> Optional[float]:
    """The share of the window in which no device operation ran."""
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def per_thousand(x: float, n: int) -> Optional[float]:
    return x / (n / 1000.0) if n else None
