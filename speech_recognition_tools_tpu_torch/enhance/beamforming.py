"""Host copy (numpy / scipy, no torch) of
speech_recognition_tools_tpu/enhance/beamforming.py, kept in the port so that it
imports nothing of the JAX package.

Mask-driven beamforming: PSD matrices, PCA steering, MVDR, GEV, BAN.

Functional parity target: nn-gev/fgnt/beamforming.py (:7-187, Heymann et
al.'s mask-based GEV pipeline), validated value-for-value by
tests/test_decode_eval_enhance.py against the reference implementation.
The implementation here is independent: every per-bin quantity is computed
*batched over frequency* — the GEV problem is solved for all bins at once
by Cholesky whitening + one batched Hermitian eigendecomposition instead
of a per-bin generalized-eig loop — and a cumulative inter-bin phase
alignment (absent in nn-gev) removes the GEV eigenvector's per-bin phase
ambiguity, which otherwise acts as a random all-pass filter on the output.

This is the host reference of the device chain (enhance/onchip.py),
which runs the same algebra in torch.linalg on the card.
"""

import numpy as np


def _hermitize(m):
    return 0.5 * (m + np.conj(m.swapaxes(-1, -2)))


def power_spectral_density_matrix(observation, mask=None):
    """Mask-weighted spatial PSD.

    observation: (bins, sensors, frames) complex; mask: (bins, frames)
    non-negative weights. Returns (bins, sensors, sensors):
    Phi_f = sum_t m[f,t] y[f,:,t] y[f,:,t]^H / sum_t m[f,t].
    """
    bins_, sensors, frames = observation.shape
    if mask is None:
        weighted = observation
        norm = float(frames)
    else:
        weighted = observation * mask[:, None, :]
        norm = np.maximum(mask.sum(axis=-1), 1e-6)[:, None, None]
    psd = weighted @ observation.conj().swapaxes(-1, -2)
    return psd / norm


def pca_vector(target_psd_matrix):
    """Principal eigenvector per bin — the PCA steering-vector estimate."""
    shape = target_psd_matrix.shape
    mat = target_psd_matrix.reshape((-1,) + shape[-2:])
    _, eigenvecs = np.linalg.eigh(mat)  # ascending: principal is last
    return eigenvecs[..., -1].reshape(shape[:-1])


def mvdr_vector(atf_vector, noise_psd_matrix):
    """MVDR weights w = Phi_NN^-1 d / (d^H Phi_NN^-1 d).

    atf_vector (..., sensors) broadcasts against
    noise_psd_matrix (..., sensors, sensors).
    """
    d = np.asarray(atf_vector)
    phi = _hermitize(np.asarray(noise_psd_matrix))
    phi = np.broadcast_to(phi, d.shape + d.shape[-1:])
    numerator = np.linalg.solve(phi, d[..., None])[..., 0]
    denominator = np.einsum("...d,...d->...", d.conj(), numerator)
    return numerator / denominator[..., None]


def gev_vector(target_psd_matrix, noise_psd_matrix, diag_load: float = 1e-10):
    """Max-SNR (GEV) beamforming weights, batched over bins.

    Solves Phi_XX w = lambda Phi_NN w for the principal pair via Cholesky
    whitening: with Phi_NN = L L^H, the whitened matrix
    M = L^-1 Phi_XX L^-H is Hermitian, its principal eigenvector v gives
    w = L^-H v — one batched eigh over all bins instead of nn-gev's
    per-bin scipy.eigh loop. Noise PSDs are diagonally loaded by
    diag_load * trace/sensors for Cholesky stability (the fallback role of
    the reference's try eigh / except eig).

    Normalization matches scipy.eigh(a, b): w^H Phi_NN w = 1.
    """
    # factorize in double precision, but size the diagonal loading by the
    # *input* dtype: a PSD accumulated in complex64 carries O(eps * trace)
    # negative eigenvalue noise that a float64-scaled load would not cover
    in_eps = np.finfo(np.asarray(noise_psd_matrix).real.dtype).eps
    load = max(diag_load, 64.0 * in_eps)
    phi_x = _hermitize(np.asarray(target_psd_matrix, np.complex128))
    phi_n = _hermitize(np.asarray(noise_psd_matrix, np.complex128))
    sensors = phi_n.shape[-1]
    tr = np.trace(phi_n, axis1=-2, axis2=-1).real[..., None, None]
    # relative loading with an absolute floor so bins holding digital
    # silence (exactly-zero PSD) still factorize
    phi_n = phi_n + (load * np.abs(tr) / sensors + 1e-15) * np.eye(sensors)
    L = np.linalg.cholesky(phi_n)
    # M = L^-1 Phi_XX L^-H, built from two batched triangular-ish solves
    A = np.linalg.solve(L, phi_x)
    M = _hermitize(
        np.linalg.solve(L, A.conj().swapaxes(-1, -2)).conj().swapaxes(-1, -2)
    )
    _, vecs = np.linalg.eigh(M)
    v = vecs[..., -1]
    w = np.linalg.solve(L.conj().swapaxes(-1, -2), v[..., None])[..., 0]
    return w


def phase_correction(vector):
    """Remove the GEV weights' per-bin phase ambiguity.

    Each bin's eigenvector carries an arbitrary phase e^{j phi(f)}; applied
    to the mixture that is a random all-pass filter which smears the
    waveform (audible as musical noise; it also tanks envelope metrics
    like STOI). Align every bin's weight to its lower neighbour:
    w'(f) = w(f) * exp(-j * angle(<w(f), w(f-1)>)), computed for all bins
    at once with a cumulative phase sum.

    vector: (bins, sensors). Returns the phase-aligned copy.
    """
    w = np.asarray(vector)
    corr = np.einsum("fd,fd->f", w[1:], w[:-1].conj())
    phases = np.concatenate([[0.0], np.angle(corr)])
    return w * np.exp(-1j * np.cumsum(phases))[:, None]


def blind_analytic_normalization(vector, noise_psd_matrix):
    """BAN post-gain reducing GEV speech distortion:
    g(f) = sqrt(|w^H Phi_NN^2 w|) / |w^H Phi_NN w| per bin."""
    phw = np.einsum("...ab,...b->...a", noise_psd_matrix, vector)
    nom = np.einsum("...a,...ab,...b->...", phw.conj(), noise_psd_matrix, vector)
    denom = np.einsum("...a,...a->...", vector.conj(), phw)
    return vector * (np.abs(np.sqrt(nom)) / np.abs(denom))[..., None]


def apply_beamforming_vector(vector, mix):
    """(bins, sensors) weights applied to (bins, sensors, frames)."""
    return np.einsum("...a,...at->...t", vector.conj(), mix)


def gev_beamform(mix_stft, speech_mask, noise_mask, ban=True,
                 phase_correct=True):
    """Full GEV pipeline: PSDs from masks -> batched GEV weights
    (+ inter-bin phase alignment, + BAN) -> beamformed output.

    mix_stft: (bins, sensors, frames); masks: (bins, frames).
    Returns (bins, frames) beamformed STFT.
    """
    phi_xx = power_spectral_density_matrix(mix_stft, speech_mask)
    phi_nn = power_spectral_density_matrix(mix_stft, noise_mask)
    w = gev_vector(phi_xx, phi_nn)
    if phase_correct:
        w = phase_correction(w)
    if ban:
        w = blind_analytic_normalization(w, phi_nn)
    return apply_beamforming_vector(w, mix_stft)


def mvdr_beamform(mix_stft, speech_mask, noise_mask):
    """MVDR pipeline with PCA steering vector from the speech PSD."""
    phi_xx = power_spectral_density_matrix(mix_stft, speech_mask)
    phi_nn = power_spectral_density_matrix(mix_stft, noise_mask)
    atf = pca_vector(phi_xx)
    w = mvdr_vector(atf, phi_nn)
    return apply_beamforming_vector(w, mix_stft)
