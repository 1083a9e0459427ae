"""Window functions as host-side float64 constants.

Copy of speech_recognition_tools_tpu/ops/windows.py (held bit-exact by the
tests). Windows are data-independent constants computed once in numpy
float64; callers cast them to the compute dtype and device.
"""

import numpy as np


def hamming(n: int) -> np.ndarray:
    """numpy.hamming (bit-exact: delegate to numpy)."""
    return np.hamming(n)


def hanning(n: int) -> np.ndarray:
    """numpy.hanning (bit-exact: delegate to numpy)."""
    return np.hanning(n)


def square_window(n: int) -> np.ndarray:
    """All-ones window (reference: computeModulationSpectrum.py sq_wind)."""
    return np.ones(n)


WINDOWS = {
    "hamming": hamming,
    "hanning": hanning,
    "square": square_window,
}
