"""Root-raised-cosine filter tap generation (counterpart of `vitiq/dsp/taps.py`).

Contract (ref: test_dsp_functions.py:70-72): `rrc_filter(alpha=0.35, span=8,
sps)` returns FIR taps used via `np.convolve(x, rrc, mode='same')` for pulse
shaping, and the matched filter is the same taps applied again at the
receiver. Taps are unit-energy normalized so that shaping+matched filtering
has unity gain at the symbol instants (raised-cosine Nyquist property).
"""

from __future__ import annotations

import numpy as np


def rrc_filter(alpha: float = 0.35, span: int = 8, sps: int = 2) -> np.ndarray:
    """Root-raised-cosine taps.

    Args:
      alpha: roll-off factor in (0, 1].
      span: filter span in symbols (total length = span * sps + 1).
      sps: samples per symbol.

    Returns:
      float64 taps of length span * sps + 1, unit energy.
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    if sps < 1:
        raise ValueError(f"sps must be >= 1, got {sps}")
    n = span * sps + 1
    # time axis in symbol periods, centered
    t = (np.arange(n) - (n - 1) / 2.0) / sps

    h = np.empty(n, dtype=np.float64)
    # generic formula h(t) = [sin(pi t (1-a)) + 4 a t cos(pi t (1+a))]
    #                        / [pi t (1 - (4 a t)^2)]
    with np.errstate(divide="ignore", invalid="ignore"):
        num = np.sin(np.pi * t * (1 - alpha)) + 4 * alpha * t * np.cos(np.pi * t * (1 + alpha))
        den = np.pi * t * (1 - (4 * alpha * t) ** 2)
        h = num / den

    # singularity at t = 0
    h = np.where(t == 0.0, 1.0 - alpha + 4 * alpha / np.pi, h)
    # singularity at |t| = 1 / (4 alpha)
    sing = np.isclose(np.abs(t), 1.0 / (4 * alpha))
    h_sing = (alpha / np.sqrt(2.0)) * (
        (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
        + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha))
    )
    h = np.where(sing, h_sing, h)

    return h / np.sqrt(np.sum(h * h))
