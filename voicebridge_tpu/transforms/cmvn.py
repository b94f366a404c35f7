"""Cepstral mean/variance normalization (per speaker).

Reference behavior: ``compute-cmvn-stats`` accumulates per-speaker stats of
shape ``[2, D+1]`` (row 0 = [sum x, count], row 1 = [sum x^2, 0]); ``apply-cmvn``
normalizes each utterance by its speaker's stats
(``kaldi-master/src/transform/cmvn.{h,cc}``, ``featbin/compute-cmvn-stats.cpp``,
``scr/steps/compute_cmvn_stats.cpp``).

Batched design: stats for all speakers are accumulated in one
``jax.ops.segment_sum`` over a speaker-id vector (the reference's
``spk2utt``-driven sequential loop becomes a single batched reduction), and
application is a gather + fused elementwise op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def acc_cmvn_stats_batch(feats: jnp.ndarray, num_frames: jnp.ndarray,
                         spk_ids: jnp.ndarray, num_speakers: int) -> jnp.ndarray:
    """``[B, T, D]`` padded features + ``[B]`` frame counts + ``[B]`` speaker ids
    -> ``[num_speakers, 2, D+1]`` CMVN stats."""
    b, t, d = feats.shape
    mask = (jnp.arange(t)[None, :] < num_frames[:, None]).astype(feats.dtype)
    x = feats * mask[:, :, None]
    sum_x = jax.ops.segment_sum(jnp.sum(x, axis=1), spk_ids, num_speakers)
    sum_x2 = jax.ops.segment_sum(jnp.sum(x * x, axis=1), spk_ids, num_speakers)
    counts = jax.ops.segment_sum(num_frames.astype(feats.dtype), spk_ids, num_speakers)
    stats = jnp.zeros((num_speakers, 2, d + 1), feats.dtype)
    stats = stats.at[:, 0, :d].set(sum_x)
    stats = stats.at[:, 0, d].set(counts)
    stats = stats.at[:, 1, :d].set(sum_x2)
    return stats


def acc_cmvn_stats(feats: np.ndarray) -> np.ndarray:
    """Single-matrix stats ``[2, D+1]`` (host-side convenience)."""
    t, d = feats.shape
    stats = np.zeros((2, d + 1), dtype=np.float64)
    stats[0, :d] = feats.sum(axis=0)
    stats[0, d] = t
    stats[1, :d] = (feats.astype(np.float64) ** 2).sum(axis=0)
    return stats.astype(np.float32)


def fake_cmvn_stats(dim: int) -> np.ndarray:
    """'Fake' no-op stats (reference: compute-cmvn-stats --fake / kaldi_scr.h:87-94):
    count 1, zero mean, unit variance."""
    stats = np.zeros((2, dim + 1), dtype=np.float32)
    stats[0, dim] = 1.0
    stats[1, :dim] = 1.0
    return stats


def apply_cmvn(feats: jnp.ndarray, stats: jnp.ndarray, norm_vars: bool = False) -> jnp.ndarray:
    """Normalize ``[T, D]`` by one speaker's ``[2, D+1]`` stats
    (reference: ``ApplyCmvn``, transform/cmvn.cc)."""
    d = feats.shape[-1]
    count = stats[0, d]
    mean = stats[0, :d] / count
    out = feats - mean[None, :]
    if norm_vars:
        var = stats[1, :d] / count - mean * mean
        scale = 1.0 / jnp.sqrt(jnp.maximum(var, 1e-20))
        out = out * scale[None, :]
    return out


def apply_cmvn_batch(feats: jnp.ndarray, spk_stats: jnp.ndarray, spk_ids: jnp.ndarray,
                     norm_vars: bool = False) -> jnp.ndarray:
    """``[B, T, D]`` with per-speaker stats gathered by ``spk_ids``."""
    stats = spk_stats[spk_ids]  # [B, 2, D+1]
    d = feats.shape[-1]
    count = stats[:, 0, d]
    mean = stats[:, 0, :d] / count[:, None]
    out = feats - mean[:, None, :]
    if norm_vars:
        var = stats[:, 1, :d] / count[:, None] - mean * mean
        scale = 1.0 / jnp.sqrt(jnp.maximum(var, 1e-20))
        out = out * scale[:, None, :]
    return out

def acc_cmvn_stats_two_channel(feats_a: np.ndarray, feats_b: np.ndarray,
                               quieter_channel_weight: float = 0.01
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Two-sided telephone CMVN: at each frame the louder channel (by C0,
    i.e. energy) gets weight 1.0 and the quieter one a small weight
    (reference: ``AccCmvnStatsForPair``,
    featbin/compute-cmvn-stats-two-channel.cpp:79-106). Returns per-channel
    ``[2, D+1]`` stats. If the channels differ in length they are
    accumulated independently (reference :86-92)."""
    d = feats_a.shape[1]
    assert feats_b.shape[1] == d
    if feats_a.shape[0] != feats_b.shape[0]:
        return acc_cmvn_stats(feats_a), acc_cmvn_stats(feats_b)
    a_louder = feats_a[:, 0] > feats_b[:, 0]
    w_a = np.where(a_louder, 1.0, quieter_channel_weight)[:, None]
    w_b = np.where(a_louder, quieter_channel_weight, 1.0)[:, None]

    def weighted(feats, w):
        stats = np.zeros((2, d + 1), np.float64)
        stats[0, :d] = (w * feats).sum(axis=0)
        stats[0, d] = w.sum()
        stats[1, :d] = (w * feats.astype(np.float64) ** 2).sum(axis=0)
        return stats.astype(np.float32)

    return weighted(feats_a, w_a), weighted(feats_b, w_b)


def utterance_pairs(reco2file_and_channel: list[tuple[str, str, str]]
                    ) -> list[list[str]]:
    """Group utterances into A/B-side pairs by call id (reference:
    ``GetUtterancePairs``, compute-cmvn-stats-two-channel.cpp:33-71).
    Input rows are ``(utt_id, call_id, side)``; calls without exactly two
    sides fall back to singletons."""
    by_call: dict[str, list[str]] = {}
    for utt, call, _side in reco2file_and_channel:
        by_call.setdefault(call, []).append(utt)
    pairs = []
    for call in sorted(by_call):
        utts = by_call[call]
        if len(utts) == 2:
            pairs.append(utts)
        else:
            pairs.extend([u] for u in utts)
    return pairs


def modify_cmvn_stats(stats: np.ndarray, skip_dims: list[int] = (),
                      convert_to_mean_and_var: bool = False) -> np.ndarray:
    """``modify-cmvn-stats`` role (featbin/modify-cmvn-stats.cpp): fake out
    the listed dims (zero mean, unit variance — ``FakeStatsForSomeDims``,
    transform/cmvn.cc) and optionally convert sums to [mean; variance]."""
    stats = np.array(stats, np.float64)
    if stats.shape[0] != 2:
        raise ValueError("CMVN stats must have two rows")
    d = stats.shape[1] - 1
    count = stats[0, d]
    for i in skip_dims:
        stats[0, i] = 0.0
        stats[1, i] = count
    if not convert_to_mean_and_var:
        return stats.astype(np.float32)
    if count <= 0.0:
        raise ValueError("zero or negative count in CMVN stats")
    mean = stats[0, :d] / count
    var = stats[1, :d] / count - mean * mean
    return np.stack([mean, var]).astype(np.float32)
