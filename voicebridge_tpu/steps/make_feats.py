"""Feature pipeline step: batched MFCC + per-speaker CMVN (+ deltas/splice).

Counterpart of the reference's MakeMfcc + ComputeCmvnStats + per-step feature
chains (``scr/steps/make_mfcc.cpp``, ``compute_cmvn_stats.cpp``; chain trace
SURVEY.md §3.5).  The nj-thread fan-out becomes one padded device batch; all
utterances of a (bucketed) batch are framed/FFT'd/filterbanked together.
"""

from __future__ import annotations

import numpy as np

from ..config import DeltaOptions, MfccOptions, SpliceOptions
from ..ops.features import (MfccExtractor, add_deltas_batch,
                            splice_frames_batch)
from ..transforms.cmvn import (acc_cmvn_stats_batch, apply_cmvn_batch)
from ..utils.logging import get_logger

log = get_logger()


def _bucket(lengths: list[int], num_buckets: int = 4) -> list[int]:
    """Pad-length per utterance: quantile buckets to bound pad waste."""
    arr = np.sort(np.unique(lengths))
    qs = [arr[min(int(len(arr) * (i + 1) / num_buckets), len(arr) - 1)]
          for i in range(num_buckets)]
    out = []
    for l in lengths:
        out.append(int(next(q for q in qs if q >= l)))
    return out


def compute_mfcc(waves: dict[str, np.ndarray], opts: MfccOptions,
                 dither_seed: int | None = 0) -> dict[str, np.ndarray]:
    """utt -> samples  =>  utt -> [T, num_ceps] MFCC, batched by bucket."""
    import jax

    ext = MfccExtractor(opts)
    utts = sorted(waves)
    lengths = [len(waves[u]) for u in utts]
    buckets = _bucket(lengths)
    out: dict[str, np.ndarray] = {}
    by_bucket: dict[int, list[str]] = {}
    for u, b in zip(utts, buckets):
        by_bucket.setdefault(b, []).append(u)
    for pad_len, us in sorted(by_bucket.items()):
        bs = len(us)
        batch = np.zeros((bs, pad_len), np.float32)
        ns = np.zeros(bs, np.int64)
        for i, u in enumerate(us):
            w = waves[u]
            batch[i, : len(w)] = w
            ns[i] = len(w)
        max_frames = opts.frame_opts.num_frames(pad_len)
        keys = None
        if opts.frame_opts.dither != 0.0 and dither_seed is not None:
            keys = jax.random.split(
                jax.random.PRNGKey(dither_seed + pad_len), bs)
        feats, counts = ext.batched(batch, ns, max_frames, keys)
        feats, counts = np.asarray(feats), np.asarray(counts)
        for i, u in enumerate(us):
            out[u] = feats[i, : counts[i]].copy()
    return out


def compute_cmvn(feats: dict[str, np.ndarray], utt2spk: dict[str, str]) -> dict[str, np.ndarray]:
    """Per-speaker CMVN stats: spk -> [2, D+1]."""
    utts = sorted(feats)
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    t_max = max(feats[u].shape[0] for u in utts)
    d = feats[utts[0]].shape[1]
    batch = np.zeros((len(utts), t_max, d), np.float32)
    nf = np.zeros(len(utts), np.int32)
    sid = np.zeros(len(utts), np.int32)
    for i, u in enumerate(utts):
        f = feats[u]
        batch[i, : f.shape[0]] = f
        nf[i] = f.shape[0]
        sid[i] = spk_idx[utt2spk[u]]
    stats = np.asarray(acc_cmvn_stats_batch(batch, nf, sid, len(speakers)))
    return {s: stats[spk_idx[s]] for s in speakers}


def apply_feature_chain(feats: dict[str, np.ndarray], utt2spk: dict[str, str],
                        cmvn_stats: dict[str, np.ndarray],
                        deltas: DeltaOptions | None = DeltaOptions(),
                        splice: SpliceOptions | None = None,
                        norm_vars: bool = False) -> dict[str, np.ndarray]:
    """apply-cmvn [-> add-deltas | splice-feats] for every utterance, batched."""
    utts = sorted(feats)
    t_max = max(feats[u].shape[0] for u in utts)
    d = feats[utts[0]].shape[1]
    batch = np.zeros((len(utts), t_max, d), np.float32)
    nf = np.zeros(len(utts), np.int32)
    for i, u in enumerate(utts):
        f = feats[u]
        batch[i, : f.shape[0]] = f
        nf[i] = f.shape[0]
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    stats = np.stack([cmvn_stats[s] for s in speakers])
    sid = np.asarray([spk_idx[utt2spk[u]] for u in utts], np.int32)
    normed = apply_cmvn_batch(batch, stats, sid, norm_vars=norm_vars)
    if deltas is not None:
        out = add_deltas_batch(normed, nf, deltas)
    elif splice is not None:
        out = splice_frames_batch(normed, nf, splice)
    else:
        out = normed
    out = np.asarray(out)
    return {u: out[i, : nf[i]].copy() for i, u in enumerate(utts)}


def make_features(waves: dict[str, np.ndarray], utt2spk: dict[str, str],
                  mfcc_opts: MfccOptions,
                  deltas: DeltaOptions | None = DeltaOptions(),
                  splice: SpliceOptions | None = None,
                  dither_seed: int | None = 0,
                  pitch: bool = False) -> dict[str, np.ndarray]:
    """Full frontend: MFCC [+pitch] -> per-speaker CMVN -> deltas/splice.
    ``pitch=True`` pastes the 3-dim pitch features (MakeMfccPitch role)."""
    mfcc = compute_mfcc(waves, mfcc_opts, dither_seed)
    if pitch:
        from ..ops.pitch import PitchOptions, compute_pitch_feats, paste_feats

        popts = PitchOptions(samp_freq=mfcc_opts.frame_opts.samp_freq,
                             frame_shift_ms=mfcc_opts.frame_opts.frame_shift_ms,
                             frame_length_ms=mfcc_opts.frame_opts.frame_length_ms)
        mfcc = {u: paste_feats(f, compute_pitch_feats(waves[u], popts))
                for u, f in mfcc.items()}
    cmvn = compute_cmvn(mfcc, utt2spk)
    return apply_feature_chain(mfcc, utt2spk, cmvn, deltas, splice)
