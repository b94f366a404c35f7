"""MfccExtractor under the option combinations the removed fused kernel was
checked at: energy / HTK ordering, the 16 kHz 400-sample window padded to
512, and dither determinism.  The reference is the straight-line numpy MFCC
of tests/test_features.py."""

import math

import jax
import numpy as np
import pytest

from voicebridge_tpu.config import FrameOptions, MelOptions, MfccOptions
from voicebridge_tpu.ops.features import MfccExtractor

from test_features import ref_mfcc


def _wave(n=8000, sr=8000, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (3000 * np.sin(2 * np.pi * 313 * t)
            + 1200 * np.sin(2 * np.pi * 1170 * t + 0.3)
            + 80 * rng.standard_normal(n)).astype(np.float32)


def _opts(**kw):
    return MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0, dither=0.0),
                       **kw)


def _ref_htk(wave, opts):
    """ref_mfcc with HTK ordering: energy (or sqrt(2)-scaled C0) last."""
    ceps = ref_mfcc(wave, opts).astype(np.float64)
    if opts.htk_compat:
        first = ceps[:, 0] * (1.0 if opts.use_energy else math.sqrt(2.0))
        ceps = np.concatenate([ceps[:, 1:], first[:, None]], axis=1)
    return ceps


@pytest.mark.parametrize("use_energy,htk_compat",
                         [(True, False), (False, True), (True, True)])
def test_energy_and_htk_order(use_energy, htk_compat):
    opts = _opts(use_energy=use_energy, htk_compat=htk_compat,
                 energy_floor=1e-10 if use_energy else 0.0)
    w = _wave(seed=2)
    np.testing.assert_allclose(MfccExtractor(opts)(w), _ref_htk(w, opts),
                               rtol=2e-4, atol=2e-3)


def test_16k_window_pads_to_512():
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=16000.0, dither=0.0),
                       mel_opts=MelOptions(num_bins=23, low_freq=20.0))
    assert opts.frame_opts.window_size == 400
    assert opts.frame_opts.padded_window_size == 512
    w = _wave(n=16000, sr=16000, seed=7)
    got = MfccExtractor(opts)(w)
    assert got.shape == (98, 13)
    np.testing.assert_allclose(got, ref_mfcc(w, opts), rtol=2e-4, atol=2e-3)


def test_dither_is_deterministic_per_key():
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0, dither=1.0))
    ext = MfccExtractor(opts)
    w = _wave(seed=6)
    k1, k2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    a, b = ext(w, dither_key=k1), ext(w, dither_key=k1)
    np.testing.assert_array_equal(a, b)
    assert np.abs(ext(w, dither_key=k2) - a).max() > 0
    # the batched path draws the same noise for the same per-utterance key
    n = opts.frame_opts.num_frames(len(w))
    feats, _ = ext.batched(w[None], np.array([len(w)]), n, k1[None])
    np.testing.assert_allclose(np.asarray(feats)[0], a, rtol=1e-5, atol=1e-4)
