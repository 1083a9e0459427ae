"""The device enhancement chain: masks -> GEV / MVDR -> iSTFT, and WPE.

Port of speech_recognition_tools_tpu/enhance/onchip.py. The host modules
enhance/beamforming.py and enhance/wpe.py are the numeric references; this
module computes the same pipelines on tensors, on whatever device they lie
on (the card by default, through `gev_enhance_chain`'s `device`).

Linear algebra: the JAX package carries every complex Cholesky, triangular
solve and eigh through ops/clinalg.py's real symmetric embedding, because
complex decompositions do not lower to a TPU. Here they are
torch.linalg's complex64 / complex128 calls (cholesky_ex,
solve_triangular, cholesky_solve, eigh). A Cholesky that fails (a matrix
not positive definite even after loading) gives NaN in its bin, as XLA's
does, without a host sync.

Numerics: every function keeps its input's precision (complex64 or
complex128). An eigenvector's phase is arbitrary per bin, on any device
and in either package; `phase_correction_onchip` reduces the GEV weights'
to one global phase (the phase of bin 0), so two implementations agree up
to that phase. MVDR's PCA steering keeps a phase per bin.

Diagonal loading is the JAX package's: `_load_diag` adds
max(diag_load, 64 eps(dtype)) |tr| / d + 1e-15 to the noise PSD, WPE adds
eps tr / K to its correlation matrix.
"""

import torch

from speech_recognition_tools_tpu_torch.enhance.stft import as_tensor, istft, stft


def _hermitize(m):
    return 0.5 * (m + m.conj().transpose(-1, -2))


def _trace(m):
    return torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)


def _eye(d, like):
    return torch.eye(d, dtype=like.dtype, device=like.device)


def _load_diag(phi, diag_load):
    """Relative diagonal loading with an absolute floor (the host
    gev_vector's: covers complex64 PSD accumulation noise and exactly-zero
    silence bins)."""
    d = phi.shape[-1]
    load = max(diag_load, 64.0 * torch.finfo(phi.real.dtype).eps)
    tr = _trace(phi).real.abs()[..., None, None]
    return phi + (load * tr / d + 1e-15) * _eye(d, phi)


def _cholesky(a):
    """Lower Cholesky factor; NaN in the batch entries that are not
    positive definite (jnp.linalg.cholesky's result there)."""
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")), L)


def _eigh(m):
    """torch.linalg.eigh, with NaN eigenvectors where a batch entry holds a
    non-finite value (LAPACK refuses such a matrix; jnp.linalg.eigh returns
    NaN there)."""
    bad = ~torch.isfinite(torch.view_as_real(m) if m.is_complex() else m)
    bad = bad.reshape(m.shape[:-2] + (-1,)).any(-1)[..., None, None]
    vals, vecs = torch.linalg.eigh(torch.where(bad, _eye(m.shape[-1], m), m))
    return vals, torch.where(bad, torch.full_like(vecs, float("nan")), vecs)


def median(x, dim):
    """np.median / jnp.median along `dim`: the mean of the two middle values
    for an even count (torch.median returns the lower one)."""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    hi = s.narrow(dim, n // 2, 1)
    if n % 2:
        return hi.squeeze(dim)
    return (0.5 * (s.narrow(dim, n // 2 - 1, 1) + hi)).squeeze(dim)


def quantile_mask_onchip(observations, quantile_fraction=0.98, quantile_weight=0.999):
    """Lorenz-curve quantile mask (enhance/masks.py::quantile_mask): keep
    the T-F cells holding the top `quantile_fraction` of the total power."""
    power = observations.abs() ** 2
    flat = torch.sort(power.reshape(-1), descending=True).values
    lorenz = torch.cumsum(flat, 0) / flat.sum()
    frac = torch.tensor([quantile_fraction], dtype=lorenz.dtype, device=lorenz.device)
    k = torch.searchsorted(lorenz, frac, side="left")
    threshold = flat[torch.clamp(k - 1, min=0)]
    mask = (power > threshold).to(power.dtype)
    return 0.5 + quantile_weight * (mask - 0.5)


def power_spectral_density_onchip(observation, mask=None):
    """Mask-weighted spatial PSD: (bins, sensors, frames) -> (bins, s, s)."""
    if mask is None:
        weighted = observation
        norm = float(observation.shape[-1])
    else:
        mask = mask.to(observation.real.dtype)
        weighted = observation * mask[:, None, :]
        norm = torch.clamp(mask.sum(-1), min=1e-6)[:, None, None]
    return (weighted @ observation.conj().transpose(-1, -2)) / norm


def gev_vector_onchip(target_psd_matrix, noise_psd_matrix, diag_load: float = 1e-10):
    """Max-SNR (GEV) weights, batched over bins: Phi_NN = L L^H, v the
    principal eigenvector of M = L^-1 Phi_XX L^-H, w = L^-H v. The
    normalisation is scipy.eigh(a, b)'s: w^H Phi_NN w = 1."""
    phi_x = _hermitize(target_psd_matrix)
    L = _cholesky(_load_diag(_hermitize(noise_psd_matrix), diag_load))
    a = torch.linalg.solve_triangular(L, phi_x, upper=False)
    m = _hermitize(torch.linalg.solve_triangular(L, a.conj().transpose(-1, -2), upper=False))
    v = _eigh(m)[1][..., -1:]
    return torch.linalg.solve_triangular(L.conj().transpose(-1, -2), v, upper=True)[..., 0]


def principal_eigvec(psd):
    """The principal eigenvector per bin (host pca_vector), phase arbitrary."""
    return _eigh(psd)[1][..., -1]


def mvdr_vector_onchip(atf_vector, noise_psd_matrix, diag_load: float = 1e-10):
    """MVDR weights w = Phi_NN^-1 d / (d^H Phi_NN^-1 d), by a Cholesky
    solve of the loaded noise PSD (the GEV path's loading policy)."""
    d = atf_vector
    phi = _load_diag(_hermitize(noise_psd_matrix), diag_load)
    phi = torch.broadcast_to(phi, d.shape + d.shape[-1:])
    num = torch.cholesky_solve(d[..., None], _cholesky(phi))[..., 0]
    den = (d.conj() * num).sum(-1)
    return num / den[..., None]


def phase_correction_onchip(vector):
    """Inter-bin phase alignment (host phase_correction), cumulative-sum
    form: w'(f) = w(f) exp(-j sum_{g<=f} angle(<w(g), w(g-1)>))."""
    corr = (vector[1:] * vector[:-1].conj()).sum(-1)
    phases = torch.cat([corr.real.new_zeros(1), torch.angle(corr)])
    rot = torch.polar(torch.ones_like(phases), -torch.cumsum(phases, 0))
    return vector * rot[:, None]


def blind_analytic_normalization_onchip(vector, noise_psd_matrix):
    """BAN post-gain g(f) = sqrt(|w^H Phi^2 w|) / |w^H Phi w| per bin."""
    phw = (noise_psd_matrix @ vector[..., None])[..., 0]
    nom = (phw.conj() * phw).sum(-1)  # w^H Phi^H Phi w
    den = (vector.conj() * phw).sum(-1)
    return vector * (torch.sqrt(nom.abs()) / den.abs())[..., None]


def apply_beamforming_vector_onchip(vector, mix):
    """(bins, sensors) weights applied to (bins, sensors, frames)."""
    return (vector.conj()[..., None, :] @ mix)[..., 0, :]


def gev_beamform_onchip(mix_stft, speech_mask, noise_mask, ban=True, phase_correct=True):
    """The GEV pipeline (host gev_beamform): mix_stft (bins, sensors,
    frames), masks (bins, frames) -> (bins, frames), global phase
    arbitrary."""
    phi_xx = power_spectral_density_onchip(mix_stft, speech_mask)
    phi_nn = power_spectral_density_onchip(mix_stft, noise_mask)
    w = gev_vector_onchip(phi_xx, phi_nn)
    if phase_correct:
        w = phase_correction_onchip(w)
    if ban:
        w = blind_analytic_normalization_onchip(w, phi_nn)
    return apply_beamforming_vector_onchip(w, mix_stft)


def mvdr_beamform_onchip(mix_stft, speech_mask, noise_mask):
    """The MVDR pipeline with PCA steering from the speech PSD."""
    phi_xx = power_spectral_density_onchip(mix_stft, speech_mask)
    phi_nn = power_spectral_density_onchip(mix_stft, noise_mask)
    w = mvdr_vector_onchip(principal_eigvec(_hermitize(phi_xx)), phi_nn)
    return apply_beamforming_vector_onchip(w, mix_stft)


def wpe_onchip(Y, taps: int = 10, delay: int = 3, iterations: int = 5, eps: float = 1e-10):
    """Iterative MIMO-WPE (host enhance/wpe.py::wpe). Y: (F, D, T) complex
    STFT. Each iteration solves R G = P, R Hermitian positive definite
    after the eps tr / K loading, by Cholesky."""
    F, D, T = Y.shape
    K = taps * D
    blocks = []
    for k in range(taps):
        shift = delay + k
        if shift < T:
            blocks.append(torch.nn.functional.pad(Y[:, :, : T - shift], (shift, 0)))
        else:
            blocks.append(torch.zeros_like(Y))
    Yt = torch.cat(blocks, dim=1)  # (F, K, T)
    YtH = Yt.conj().transpose(-1, -2)
    YH = Y.conj().transpose(-1, -2)
    X = Y
    for _ in range(iterations):
        power = torch.clamp((X.abs() ** 2).mean(1), min=eps)
        w = (1.0 / power).to(Y.real.dtype)
        Ytw = Yt * w[:, None, :]
        R = Ytw @ YtH
        P = Ytw @ YH
        tr = _trace(R).real[:, None, None]
        R = R + (eps * tr / K) * _eye(K, R)
        G = torch.cholesky_solve(P, _cholesky(R))
        X = Y - G.conj().transpose(-1, -2) @ Yt
    return X


def gev_enhance_chain(signals, size: int = 1024, shift: int = 256, ban=True,
                      phase_correct=True, return_stft=False, device=None):
    """Multichannel waveform (sensors, samples) -> enhanced (samples,):
    STFT -> quantile speech / noise masks (median over channels) -> GEV
    (+ phase alignment, + BAN) -> iSTFT. return_stft=True returns the
    beamformed (bins, frames) STFT before synthesis instead."""
    x = as_tensor(signals, device)
    n = x.shape[-1]
    X = stft(x, size=size, shift=shift)  # (ch, T, F)
    sp = quantile_mask_onchip(X)
    Xf = X.permute(2, 0, 1)  # (F, ch, T)
    spf = median(sp.permute(2, 0, 1), 1)  # (F, T)
    Yf = gev_beamform_onchip(Xf, spf, 1.0 - spf, ban=ban, phase_correct=phase_correct)
    if return_stft:
        return Yf
    return istft(Yf.transpose(0, 1), size=size, shift=shift)[..., :n]

