"""The arithmetic of the end-to-end metrics, over all of a window's samples."""

from __future__ import annotations

from typing import Sequence

import numpy as np


def mean_ms(window_s: float, n: int) -> float:
    """The window's time over its operations, in milliseconds."""
    if n <= 0:
        raise ValueError("no operation completed in the window")
    return 1e3 * window_s / n


def p95_ms(seconds: Sequence[float]) -> float:
    """The 95th percentile of every sample, in milliseconds (numpy's linear
    interpolation between closest ranks)."""
    if len(seconds) == 0:
        raise ValueError("no sample")
    return 1e3 * float(np.percentile(np.asarray(seconds, dtype=float), 95))


def rate(count: int, window_s: float) -> float:
    """Completed work over the window's seconds."""
    if window_s <= 0:
        raise ValueError("empty window")
    return count / window_s
