"""Host copy (numpy / scipy, no torch) of
speech_recognition_tools_tpu/enhance/masks.py, kept in the port so that it
imports nothing of the JAX package.

Time-frequency mask estimation.

Functional parity targets in nn-gev/fgnt/mask_estimation.py: quantile
(Lorenz) masks (:115-131), simple ideal soft masks (:46-112), ideal binary
masks with the voiced/unvoiced frequency characteristic (:4-43, :133-185).
Values are golden-tested bit-for-bit against the reference
(tests/test_decode_eval_enhance.py); the construction here is independent —
the frequency characteristic is assembled declaratively from its curve
segments instead of the reference's sequence of in-place overwrites, and
the band limits enter the IBM as boolean band predicates rather than
post-hoc slice assignments.
"""

import numpy as np

# Voiced/unvoiced characteristic geometry (fgnt/mask_estimation.py:4-10):
# bins below LOW_BIN / above HIGH_BIN carry no decision weight; the
# voiced->unvoiced handover is a half-cosine of TRANSITION_WIDTH bins
# centred at SPLIT_BIN; band edges ramp over FAST_TRANSITION_WIDTH bins.
SPLIT_BIN = 200
TRANSITION_WIDTH = 99
FAST_TRANSITION_WIDTH = 5
LOW_BIN = 4
HIGH_BIN = 500


def _half_cosine(n):
    """Raised-cosine ramp 1 -> 0 over n points."""
    return 0.5 * (1.0 + np.cos(np.linspace(0.0, np.pi, n)))


def _place(curve, start, values):
    """Write `values` into `curve` at `start`, clipped to the array."""
    lo = max(start, 0)
    hi = min(start + len(values), len(curve))
    if hi > lo:
        curve[lo:hi] = values[lo - start : hi - start]


def voiced_unvoiced_split(nbins: int):
    """Voiced/unvoiced frequency weighting curves.

    Piecewise shape (0-based bins, defaults):
      voiced:   0 | rise over [LOW_BIN-1, +5) | 1 | fall over
                [split_start, +99) | 0
      unvoiced: 0 | rise over [split_start, +99) | 1 | fall over
                [HIGH_BIN-1, +5) | 0
    where split_start = int(SPLIT_BIN - TRANSITION_WIDTH / 2) - 1.
    """
    fall_fast = _half_cosine(FAST_TRANSITION_WIDTH)
    fall_slow = _half_cosine(TRANSITION_WIDTH)
    split_start = int(SPLIT_BIN - TRANSITION_WIDTH / 2) - 1

    voiced = np.zeros(nbins)
    _place(voiced, LOW_BIN - 1, 1.0 - fall_fast)
    voiced[
        min(LOW_BIN - 1 + FAST_TRANSITION_WIDTH, nbins) : min(
            split_start, nbins
        )
    ] = 1.0
    _place(voiced, split_start, fall_slow)

    unvoiced = np.zeros(nbins)
    _place(unvoiced, split_start, 1.0 - fall_slow)
    unvoiced[
        min(split_start + TRANSITION_WIDTH, nbins) : min(HIGH_BIN - 1, nbins)
    ] = 1.0
    _place(unvoiced, HIGH_BIN - 1, fall_fast)
    return voiced, unvoiced


def quantile_mask(observations, quantile_fraction=0.98, quantile_weight=0.999):
    """Lorenz-curve quantile mask: keep the T-F cells holding the top
    `quantile_fraction` share of total power, soft-weighted."""
    power = np.abs(observations) ** 2
    flat = np.sort(power, axis=None)[::-1]
    lorenz = np.cumsum(flat) / flat.sum()
    # head set = cells with lorenz < fraction; threshold at its weakest cell
    k = int(np.searchsorted(lorenz, quantile_fraction, side="left"))
    threshold = flat[max(k - 1, 0)]
    mask = power > threshold
    return 0.5 + quantile_weight * (mask - 0.5)


def simple_ideal_soft_mask(*inputs, feature_dim=-2, source_dim=-1):
    """Power-ratio soft mask: per-source share of the power summed over
    the feature (sensor) dimension. Pass one stacked array or several
    same-shape source arrays (stacked here along source_dim)."""
    if len(inputs) == 1:
        x = inputs[0]
    else:
        assert all(i.shape == inputs[0].shape for i in inputs)
        x = np.stack(inputs, axis=source_dim)
    power = np.sum(np.abs(x) ** 2, axis=feature_dim, keepdims=True)
    mask = power / np.sum(power, axis=source_dim, keepdims=True)
    return np.squeeze(np.real(mask), axis=feature_dim)


def estimate_ibm(
    X,
    N,
    threshold_unvoiced_speech=5,
    threshold_voiced_speech=0,
    threshold_unvoiced_noise=-10,
    threshold_voiced_noise=-10,
    low_cut=5,
    high_cut=500,
):
    """Ideal binary speech/noise masks from parallel speech/noise STFTs.

    X, N: (frames, bins). The speech test boosts |X|^2 by a frequency-
    dependent threshold (different margins in the voiced and unvoiced
    regions) before comparing against |N|^2; bins outside
    [low_cut-1, high_cut) are forced to non-speech / noise.
    Returns (speech_mask, noise_mask) boolean arrays.
    """
    nbins = X.shape[-1]
    voiced, unvoiced = voiced_unvoiced_split(nbins)
    margin_speech = (
        threshold_voiced_speech * voiced + threshold_unvoiced_speech * unvoiced
    )
    margin_noise = (
        threshold_unvoiced_noise * voiced + threshold_voiced_noise * unvoiced
    )

    xpsd = np.abs(X) ** 2
    npsd = np.abs(N) ** 2
    xpsd_speech = xpsd / 10.0 ** (margin_speech / 10.0)
    xpsd_noise = xpsd / 10.0 ** (margin_noise / 10.0)

    bins_idx = np.arange(nbins)
    in_band = (bins_idx >= low_cut - 1) & (bins_idx < high_cut)
    speech_mask = in_band & (xpsd_speech > npsd) & (xpsd_speech > 0.005)
    noise_mask = ~in_band | (xpsd_noise < npsd) | (xpsd_noise < 0.005)
    return speech_mask, noise_mask
