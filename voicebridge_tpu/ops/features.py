"""MFCC / delta / splice feature frontend as batched JAX (XLA) ops.

Numerics match the reference chain (``feat/feature-mfcc.cc:28-66``,
``feat/feature-window.cc:90-162``, ``feat/mel-computations.cc:46-120``,
``feat/feature-functions.cc:29-111``):

    frame -> [dither] -> [remove DC] -> raw log-energy -> preemphasis ->
    povey window -> zero-pad to power of two -> |rFFT|^2 -> mel filterbank
    (matmul) -> log -> DCT-II (matmul) -> liftering -> [c0 := log-energy]

plus delta/delta-delta (``DeltaFeatures``) and frame splicing
(``splice-feats``) with Kaldi's edge-clamping.

Batched layout: everything operates on padded batches ``[B, T, ...]`` with a
per-utterance valid-length vector; the heavy stages (mel filterbank, DCT) are
dense matmuls, and the whole chain is one fused XLA
computation (no per-frame host loop like the reference's
``MfccComputer::Compute``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import (DeltaOptions, FrameOptions, MfccOptions, PlpOptions,
                      SpliceOptions)

FLT_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Constant tables (host-side numpy; computed once per option set)
# ---------------------------------------------------------------------------


def feature_window(opts: FrameOptions) -> np.ndarray:
    """Window function (reference: ``FeatureWindowFunction``, feature-window.cc:90)."""
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    wt = opts.window_type
    if wt == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif wt == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif wt == "povey":  # like hanning but goes to zero at edges
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif wt == "rectangular":
        w = np.ones(n)
    elif wt == "blackman":
        bc = opts.blackman_coeff
        w = bc - 0.5 * np.cos(a * i) + (0.5 - bc) * np.cos(2 * a * i)
    else:
        raise ValueError(f"invalid window type {wt!r}")
    return w.astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def vtln_warp_freq(vtln_low: float, vtln_high: float, low_freq: float,
                   high_freq: float, warp: float, freq):
    """Kaldi's piecewise-linear VTLN warp (mel-computations.cc VtlnWarpFreq):
    slope 1/warp in the middle, linear interpolation to the edges."""
    freq = np.asarray(freq, np.float64)
    if warp == 1.0:
        return freq
    scale = 1.0 / warp
    f_low = vtln_low * max(1.0, warp)
    f_high = vtln_high * min(1.0, warp)
    scale_left = (scale * f_low - low_freq) / (f_low - low_freq)
    scale_right = (high_freq - scale * f_high) / (high_freq - f_high)
    out = np.where(
        freq < f_low, low_freq + scale_left * (freq - low_freq),
        np.where(freq <= f_high, scale * freq,
                 high_freq + scale_right * (freq - high_freq)))
    return np.where((freq < low_freq) | (freq > high_freq), freq, out)


def mel_bank_matrix(num_bins: int, frame_opts: FrameOptions, low_freq: float = 20.0,
                    high_freq: float = 0.0, vtln_warp: float = 1.0,
                    vtln_low: float = 100.0, vtln_high: float = -500.0) -> np.ndarray:
    """Triangular mel filterbank as a dense ``[num_bins, num_fft_bins]`` matrix
    (reference: ``MelBanks`` ctor, mel-computations.cc:46-120), with optional
    VTLN warping of the bin edges."""
    padded = frame_opts.padded_window_size
    num_fft_bins = padded // 2
    nyquist = 0.5 * frame_opts.samp_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not (0.0 <= low_freq < nyquist and low_freq < high_freq <= nyquist):
        raise ValueError(f"bad frequency range [{low_freq}, {high_freq}]")
    if vtln_high < 0.0:
        vtln_high += nyquist
    fft_bin_width = frame_opts.samp_freq / padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    def warp_mel(mel):
        if vtln_warp == 1.0:
            return mel
        f = inverse_mel_scale(mel)
        return mel_scale(vtln_warp_freq(vtln_low, vtln_high, low_freq,
                                        high_freq, vtln_warp, f))

    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    freqs = fft_bin_width * np.arange(num_fft_bins)
    mels = mel_scale(freqs)
    for b in range(num_bins):
        left = warp_mel(mel_low + b * mel_delta)
        center = warp_mel(mel_low + (b + 1) * mel_delta)
        right = warp_mel(mel_low + (b + 2) * mel_delta)
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        w = np.where(mels <= center, up, down)
        bins[b] = np.where((mels > left) & (mels < right), w, 0.0)
    return bins.astype(np.float32)


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthonormal DCT-II matrix rows 0..num_ceps-1
    (reference: ``ComputeDctMatrix``, matrix/matrix-functions.cc)."""
    m = np.zeros((num_ceps, num_bins), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        m[k, :] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (np.arange(num_bins) + 0.5) * k
        )
    return m.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Cepstral liftering coefficients (reference: ``ComputeLifterCoeffs``)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def delta_scales(order: int, window: int) -> list[np.ndarray]:
    """Kaldi delta filter taps per order (reference: DeltaFeatures ctor,
    feature-functions.cc:54-86)."""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(order):
        prev = scales[-1]
        prev_offset = (len(prev) - 1) // 2
        cur = np.zeros(len(prev) + 2 * window, dtype=np.float64)
        cur_offset = prev_offset + window
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        scales.append(cur / normalizer)
    return [s.astype(np.float32) for s in scales]


# ---------------------------------------------------------------------------
# Core MFCC computation (pure jnp; jit/vmap-able)
# ---------------------------------------------------------------------------


def frame_starts(num_samples: int, opts: FrameOptions) -> np.ndarray:
    return np.arange(opts.num_frames(num_samples)) * opts.window_shift


def extract_frames(wave: jnp.ndarray, num_frames: int, opts: FrameOptions) -> jnp.ndarray:
    """``[S] -> [num_frames, window_size]`` (snip-edges framing).

    ``num_frames`` is a static padded frame count; frames past the true end of
    the utterance read padded samples and are masked by callers.
    """
    shift, size = opts.window_shift, opts.window_size
    idx = jnp.arange(num_frames)[:, None] * shift + jnp.arange(size)[None, :]
    idx = jnp.minimum(idx, wave.shape[0] - 1)
    return wave[idx]


def _process_window(frames: jnp.ndarray, opts: MfccOptions, window: jnp.ndarray,
                    dither_key: Optional[jax.Array]) -> tuple[jnp.ndarray, jnp.ndarray]:
    """dither/DC-offset/raw-energy/preemphasis/window on ``[T, ws]`` frames
    (reference: ``ExtractWindow`` + ``ProcessWindow``, feature-window.cc:90-185)."""
    fo = opts.frame_opts
    if fo.dither != 0.0 and dither_key is not None:
        frames = frames + fo.dither * jax.random.normal(dither_key, frames.shape)
    if fo.remove_dc_offset:
        frames = frames - jnp.mean(frames, axis=-1, keepdims=True)
    # raw log energy: after dither/DC, before preemphasis/window
    raw_energy = jnp.log(jnp.maximum(jnp.sum(frames * frames, axis=-1), FLT_EPS))
    if fo.preemph_coeff != 0.0:
        shifted = jnp.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - fo.preemph_coeff * shifted
    frames = frames * window[None, :]
    if not opts.raw_energy:
        raw_energy = jnp.log(jnp.maximum(jnp.sum(frames * frames, axis=-1), FLT_EPS))
    return frames, raw_energy


def mfcc_from_frames(frames: jnp.ndarray, opts: MfccOptions, window: jnp.ndarray,
                     mel_mat: jnp.ndarray, dct_mat: jnp.ndarray, lifter: jnp.ndarray,
                     dither_key: Optional[jax.Array] = None) -> jnp.ndarray:
    """``[T, window_size] -> [T, num_ceps]`` MFCCs (MfccComputer::Compute)."""
    fo = opts.frame_opts
    frames, log_energy = _process_window(frames, opts, window, dither_key)
    padded = fo.padded_window_size
    frames = jnp.pad(frames, ((0, 0), (0, padded - frames.shape[1])))
    spec = jnp.fft.rfft(frames, axis=-1)
    power = (spec.real**2 + spec.imag**2)[:, : padded // 2]  # bins 0..N/2-1
    # Full fp32 precision: an accelerator's default matmul precision may
    # be lower (TF32 on a GPU), which the log-mel/DCT stages cannot take.
    mel = jnp.dot(power, mel_mat.T, precision=jax.lax.Precision.HIGHEST)
    # htk_mode floors mel energies at 1.0 like HTK (MelBanks::Compute,
    # mel-computations.cc:238)
    logmel = jnp.log(jnp.maximum(mel, 1.0 if opts.mel_opts.htk_mode else FLT_EPS))
    ceps = jnp.dot(logmel, dct_mat.T, precision=jax.lax.Precision.HIGHEST)
    ceps = ceps * lifter[None, :]
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = jnp.maximum(log_energy, math.log(opts.energy_floor))
        ceps = ceps.at[:, 0].set(log_energy)
    if opts.htk_compat:
        # energy/C0 moves last; C0 regains the sqrt(2) DCT scale when it is a
        # true cepstral coefficient (feature-mfcc.cc:70-80)
        energy = ceps[:, 0] * (1.0 if opts.use_energy else math.sqrt(2.0))
        ceps = jnp.concatenate([ceps[:, 1:], energy[:, None]], axis=1)
    return ceps


class MfccExtractor:
    """Precomputes constant tables and exposes jitted single/batched MFCC."""

    def __init__(self, opts: MfccOptions = MfccOptions()):
        self.opts = opts
        self.window = jnp.asarray(feature_window(opts.frame_opts))
        self.mel_mat = jnp.asarray(
            mel_bank_matrix(opts.mel_opts.num_bins, opts.frame_opts,
                            opts.mel_opts.low_freq, opts.mel_opts.high_freq)
        )
        self.dct_mat = jnp.asarray(dct_matrix(opts.num_ceps, opts.mel_opts.num_bins))
        self.lifter = jnp.asarray(lifter_coeffs(opts.num_ceps, opts.cepstral_lifter))

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def __call__(self, wave: np.ndarray, dither_key: Optional[jax.Array] = None) -> np.ndarray:
        """Single utterance ``[S] -> [num_frames, num_ceps]``."""
        nf = self.opts.frame_opts.num_frames(len(wave))
        if nf == 0:
            return np.zeros((0, self.dim), dtype=np.float32)
        out = self._single(jnp.asarray(wave, jnp.float32), nf, dither_key)
        return np.asarray(out)

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def _single(self, wave, num_frames, dither_key):
        frames = extract_frames(wave, num_frames, self.opts.frame_opts)
        return mfcc_from_frames(frames, self.opts, self.window, self.mel_mat,
                                self.dct_mat, self.lifter, dither_key)

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def batched(self, waves: jnp.ndarray, num_samples: jnp.ndarray, max_frames: int,
                dither_keys: Optional[jax.Array] = None):
        """``[B, S], [B] -> ([B, max_frames, num_ceps], [B] frame counts)``.

        Frames beyond an utterance's frame count contain garbage from padding;
        callers mask by the returned counts.
        """
        fo = self.opts.frame_opts

        def one(wave, key):
            frames = extract_frames(wave, max_frames, fo)
            return mfcc_from_frames(frames, self.opts, self.window, self.mel_mat,
                                    self.dct_mat, self.lifter, key)

        if dither_keys is None:
            feats = jax.vmap(lambda w: one(w, None))(waves)
        else:
            feats = jax.vmap(one)(waves, dither_keys)
        counts = jnp.where(
            num_samples >= fo.window_size,
            1 + (num_samples - fo.window_size) // fo.window_shift,
            0,
        )
        return feats, counts


class FbankExtractor:
    """Log-mel filterbank features (reference: ``FbankComputer``,
    feat/feature-fbank.h — same chain as MFCC minus DCT/lifter)."""

    def __init__(self, opts: MfccOptions = MfccOptions(), use_energy: bool = False):
        self.opts = opts
        self.use_energy = use_energy
        self.window = jnp.asarray(feature_window(opts.frame_opts))
        self.mel_mat = jnp.asarray(
            mel_bank_matrix(opts.mel_opts.num_bins, opts.frame_opts,
                            opts.mel_opts.low_freq, opts.mel_opts.high_freq))

    @property
    def dim(self) -> int:
        return self.opts.mel_opts.num_bins + (1 if self.use_energy else 0)

    def __call__(self, wave: np.ndarray) -> np.ndarray:
        fo = self.opts.frame_opts
        nf = fo.num_frames(len(wave))
        if nf == 0:
            return np.zeros((0, self.dim), np.float32)
        frames = extract_frames(jnp.asarray(wave, jnp.float32), nf, fo)
        frames, log_energy = _process_window(frames, self.opts, self.window, None)
        padded = fo.padded_window_size
        frames = jnp.pad(frames, ((0, 0), (0, padded - frames.shape[1])))
        spec = jnp.fft.rfft(frames, axis=-1)
        power = (spec.real**2 + spec.imag**2)[:, : padded // 2]
        mel = jnp.dot(power, self.mel_mat.T, precision=jax.lax.Precision.HIGHEST)
        floor = 1.0 if self.opts.mel_opts.htk_mode else FLT_EPS
        logmel = jnp.log(jnp.maximum(mel, floor))
        if self.use_energy:
            logmel = jnp.concatenate([log_energy[:, None], logmel], axis=1)
        return np.asarray(logmel)


class SpectrogramExtractor:
    """Log power-spectrogram features (feat/feature-spectrogram.h)."""

    def __init__(self, opts: MfccOptions = MfccOptions()):
        self.opts = opts
        self.window = jnp.asarray(feature_window(opts.frame_opts))

    def __call__(self, wave: np.ndarray) -> np.ndarray:
        fo = self.opts.frame_opts
        nf = fo.num_frames(len(wave))
        if nf == 0:
            return np.zeros((0, fo.padded_window_size // 2 + 1), np.float32)
        frames = extract_frames(jnp.asarray(wave, jnp.float32), nf, fo)
        frames, _e = _process_window(frames, self.opts, self.window, None)
        padded = fo.padded_window_size
        frames = jnp.pad(frames, ((0, 0), (0, padded - frames.shape[1])))
        spec = jnp.fft.rfft(frames, axis=-1)
        power = spec.real**2 + spec.imag**2
        return np.asarray(jnp.log(jnp.maximum(power, FLT_EPS)))


# ---------------------------------------------------------------------------
# PLP (perceptual linear prediction)
# ---------------------------------------------------------------------------


def mel_center_freqs(num_bins: int, frame_opts: FrameOptions,
                     low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Center frequency (Hz) of each mel bin (reference: MelBanks ctor
    center_freqs_, mel-computations.cc:89-104)."""
    nyquist = 0.5 * frame_opts.samp_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    centers = inverse_mel_scale(mel_low + (np.arange(num_bins) + 1) * mel_delta)
    return centers.astype(np.float64)


def equal_loudness_vector(center_freqs: np.ndarray) -> np.ndarray:
    """Equal-loudness preemphasis curve per mel bin
    (reference: ``GetEqualLoudnessVector``, mel-computations.cc:313-324)."""
    fsq = center_freqs * center_freqs
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)


def idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """Inverse-DFT basis matrix ``[n_bases, dimension]`` mapping the
    (end-duplicated) compressed mel spectrum to autocorrelations
    (reference: ``InitIdftBases``, feat/feature-functions.cc:188-203)."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return m.astype(np.float32)


def durbin_lpc(autocorr: jnp.ndarray, order: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Levinson-Durbin recursion, vectorized over frames.

    ``autocorr [T, order+1] -> (lpc [T, order], residual energy E [T])``
    (reference: ``Durbin``, mel-computations.cc:269-299). The recursion depth
    is the static ``order`` (typically 12), so it is unrolled at trace time;
    each step is vectorized over all frames (elementwise work, negligible
    next to the mel/FFT matmuls).
    """
    t = autocorr.shape[0]
    e = autocorr[:, 0]
    lp = jnp.zeros((t, order), autocorr.dtype)
    for i in range(order):
        ki = autocorr[:, i + 1]
        for j in range(i):
            ki = ki + lp[:, j] * autocorr[:, i - j]
        ki = ki / e
        c = jnp.maximum(1.0 - ki * ki, 1.0e-5)
        e = e * c
        new_cols = [lp[:, j] - ki * lp[:, i - j - 1] for j in range(i)]
        new_cols.append(-ki)
        upd = jnp.stack(new_cols, axis=1)
        lp = jnp.concatenate([upd, lp[:, i + 1:]], axis=1)
    return lp, e


def lpc_to_cepstrum(lpc: jnp.ndarray, order: int) -> jnp.ndarray:
    """LPC -> cepstrum recursion, vectorized over frames
    (reference: ``Lpc2Cepstrum``, mel-computations.cc:302-311)."""
    ceps = []
    for i in range(order):
        s = jnp.zeros(lpc.shape[0], lpc.dtype)
        for j in range(i):
            s = s + float(i - j) * lpc[:, j] * ceps[i - j - 1]
        ceps.append(-lpc[:, i] - s / float(i + 1))
    return jnp.stack(ceps, axis=1)


def plp_from_frames(frames: jnp.ndarray, opts: PlpOptions, window: jnp.ndarray,
                    mel_mat: jnp.ndarray, eql: jnp.ndarray, idft: jnp.ndarray,
                    lifter: jnp.ndarray,
                    dither_key: Optional[jax.Array] = None) -> jnp.ndarray:
    """``[T, window_size] -> [T, num_ceps]`` PLP features
    (reference: ``PlpComputer::Compute``, feat/feature-plp.cc:112-188)."""
    fo = opts.frame_opts
    mo = MfccOptions(frame_opts=fo, use_energy=opts.use_energy,
                     energy_floor=opts.energy_floor, raw_energy=opts.raw_energy)
    frames, log_energy = _process_window(frames, mo, window, dither_key)
    padded = fo.padded_window_size
    frames = jnp.pad(frames, ((0, 0), (0, padded - frames.shape[1])))
    spec = jnp.fft.rfft(frames, axis=-1)
    power = (spec.real**2 + spec.imag**2)[:, : padded // 2]
    mel = jnp.dot(power, mel_mat.T, precision=jax.lax.Precision.HIGHEST)
    if opts.mel_opts.htk_mode:
        mel = jnp.maximum(mel, 1.0)  # HTK energy floor (mel-computations.cc:238)
    mel = mel * eql[None, :]
    mel = jnp.power(jnp.maximum(mel, FLT_EPS), opts.compress_factor)
    # duplicate first/last bins (feature-plp.cc:152-154)
    dup = jnp.concatenate([mel[:, :1], mel, mel[:, -1:]], axis=1)
    autocorr = jnp.dot(dup, idft.T, precision=jax.lax.Precision.HIGHEST)
    lpc, resid_e = durbin_lpc(autocorr, opts.lpc_order)
    # residual_log_energy = log(E), floored like the reference (flt-min clamp)
    resid_log_e = jnp.log(jnp.maximum(resid_e, np.finfo(np.float32).tiny))
    resid_log_e = jnp.maximum(resid_log_e, np.finfo(np.float32).tiny)
    raw_ceps = lpc_to_cepstrum(lpc, opts.lpc_order)
    feat = jnp.concatenate([resid_log_e[:, None],
                            raw_ceps[:, : opts.num_ceps - 1]], axis=1)
    feat = feat * lifter[None, :]
    if opts.cepstral_scale != 1.0:
        feat = feat * opts.cepstral_scale
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = jnp.maximum(log_energy, math.log(opts.energy_floor))
        feat = feat.at[:, 0].set(log_energy)
    if opts.htk_compat:
        # reorder only: energy/C0 last (feature-plp.cc:182-187)
        feat = jnp.concatenate([feat[:, 1:], feat[:, :1]], axis=1)
    return feat


class PlpExtractor:
    """PLP features (reference: ``PlpComputer``/``Plp``, feat/feature-plp.h:99-167):
    mel spectrum -> equal-loudness -> cube-root compression -> IDFT to
    autocorrelation -> Levinson-Durbin LPC -> cepstrum."""

    def __init__(self, opts: PlpOptions = PlpOptions()):
        if opts.num_ceps > opts.lpc_order + 1:
            raise ValueError("num_ceps must be <= lpc_order + 1")
        self.opts = opts
        self.window = jnp.asarray(feature_window(opts.frame_opts))
        self.mel_mat = jnp.asarray(
            mel_bank_matrix(opts.mel_opts.num_bins, opts.frame_opts,
                            opts.mel_opts.low_freq, opts.mel_opts.high_freq))
        centers = mel_center_freqs(opts.mel_opts.num_bins, opts.frame_opts,
                                   opts.mel_opts.low_freq, opts.mel_opts.high_freq)
        self.eql = jnp.asarray(equal_loudness_vector(centers))
        self.idft = jnp.asarray(
            idft_bases(opts.lpc_order + 1, opts.mel_opts.num_bins + 2))
        self.lifter = jnp.asarray(
            lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)
            if opts.cepstral_lifter != 0.0
            else np.ones(opts.num_ceps, np.float32))

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def __call__(self, wave: np.ndarray, dither_key: Optional[jax.Array] = None) -> np.ndarray:
        nf = self.opts.frame_opts.num_frames(len(wave))
        if nf == 0:
            return np.zeros((0, self.dim), np.float32)
        out = self._single(jnp.asarray(wave, jnp.float32), nf, dither_key)
        return np.asarray(out)

    @functools.partial(jax.jit, static_argnums=(0, 2))
    def _single(self, wave, num_frames, dither_key):
        frames = extract_frames(wave, num_frames, self.opts.frame_opts)
        return plp_from_frames(frames, self.opts, self.window, self.mel_mat,
                               self.eql, self.idft, self.lifter, dither_key)

    @functools.partial(jax.jit, static_argnums=(0, 3))
    def batched(self, waves: jnp.ndarray, num_samples: jnp.ndarray, max_frames: int,
                dither_keys: Optional[jax.Array] = None):
        """``[B, S], [B] -> ([B, max_frames, num_ceps], [B] frame counts)``."""
        fo = self.opts.frame_opts

        def one(wave, key):
            frames = extract_frames(wave, max_frames, fo)
            return plp_from_frames(frames, self.opts, self.window, self.mel_mat,
                                   self.eql, self.idft, self.lifter, key)

        if dither_keys is None:
            feats = jax.vmap(lambda w: one(w, None))(waves)
        else:
            feats = jax.vmap(one)(waves, dither_keys)
        counts = jnp.where(
            num_samples >= fo.window_size,
            1 + (num_samples - fo.window_size) // fo.window_shift,
            0,
        )
        return feats, counts


# ---------------------------------------------------------------------------
# Deltas and splicing (batched, length-aware edge clamping)
# ---------------------------------------------------------------------------


def _clamped_gather(feats: jnp.ndarray, offsets: np.ndarray, num_frames) -> jnp.ndarray:
    """Stack shifted copies of ``feats [T, D]`` for each offset, clamping frame
    indices to ``[0, num_frames-1]`` like the reference does at utterance edges."""
    t = feats.shape[0]
    idx = jnp.arange(t)[None, :] + jnp.asarray(offsets)[:, None]  # [K, T]
    idx = jnp.clip(idx, 0, jnp.maximum(num_frames - 1, 0))
    return feats[idx]  # [K, T, D]


def add_deltas(feats: jnp.ndarray, num_frames, opts: DeltaOptions = DeltaOptions()) -> jnp.ndarray:
    """``[T, D] -> [T, D*(order+1)]`` (reference: add-deltas / DeltaFeatures)."""
    scales = delta_scales(opts.order, opts.window)
    outs = []
    for s in scales:
        off = (len(s) - 1) // 2
        offsets = np.arange(-off, off + 1)
        shifted = _clamped_gather(feats, offsets, num_frames)  # [K, T, D]
        outs.append(jnp.einsum("k,ktd->td", jnp.asarray(s), shifted,
                               precision=jax.lax.Precision.HIGHEST))
    return jnp.concatenate(outs, axis=-1)


def add_deltas_batch(feats: jnp.ndarray, num_frames: jnp.ndarray,
                     opts: DeltaOptions = DeltaOptions()) -> jnp.ndarray:
    """``[B, T, D] -> [B, T, D*(order+1)]``."""
    return jax.vmap(lambda f, n: add_deltas(f, n, opts))(feats, num_frames)


def splice_frames(feats: jnp.ndarray, num_frames, opts: SpliceOptions = SpliceOptions()) -> jnp.ndarray:
    """``[T, D] -> [T, D*(left+right+1)]`` (reference: splice-feats)."""
    offsets = np.arange(-opts.left_context, opts.right_context + 1)
    shifted = _clamped_gather(feats, offsets, num_frames)  # [K, T, D]
    k, t, d = shifted.shape
    return jnp.transpose(shifted, (1, 0, 2)).reshape(t, k * d)


def splice_frames_batch(feats: jnp.ndarray, num_frames: jnp.ndarray,
                        opts: SpliceOptions = SpliceOptions()) -> jnp.ndarray:
    return jax.vmap(lambda f, n: splice_frames(f, n, opts))(feats, num_frames)
