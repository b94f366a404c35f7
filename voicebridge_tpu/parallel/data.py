"""Distributed (multi-host) input pipeline helpers.

Replaces the reference's ``SplitData``-over-shared-filesystem model
(SURVEY.md §2.6 P1 / §5.8): each host process loads only its shard of
utterances, builds process-local padded batches, and assembles them into
globally-sharded ``jax.Array``s over the data mesh axis — the interconnect
never sees raw audio, only the psum'd statistics.

Single-host (including the unit-test virtual mesh) degrades to the identity
sharding, so the same training code runs unchanged from 1 chip to a pod.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .mesh import DATA_AXIS


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Deterministic per-host utterance shard (round-robin over the sorted
    list so shards stay balanced across length distributions)."""
    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [x for i, x in enumerate(sorted(items)) if i % pc == pi]


def pad_to_multiple(batch_arrays: dict, multiple: int, pad_axis: int = 0) -> dict:
    """Pad the leading (utterance) axis to a multiple of the mesh's data size
    with zero rows (weights already mask padding)."""
    out = {}
    for k, v in batch_arrays.items():
        n = v.shape[pad_axis]
        target = -(-n // multiple) * multiple
        if target != n:
            pad = [(0, 0)] * v.ndim
            pad[pad_axis] = (0, target - n)
            v = np.pad(v, pad)
        out[k] = v
    return out


def global_batch(mesh: Mesh, local_arrays: dict) -> dict:
    """Assemble process-local arrays into data-axis-sharded global arrays
    (jax.make_array_from_process_local_data).  With one process this is just
    a device_put with the sharded layout."""
    sharding = NamedSharding(mesh, P(DATA_AXIS))
    out = {}
    for k, v in local_arrays.items():
        if jax.process_count() == 1:
            out[k] = jax.device_put(v, sharding)
        else:
            out[k] = jax.make_array_from_process_local_data(sharding, v)
    return out


# ---------------------------------------------------------------------------
# Length-bucketed batching + streaming loader (LibriSpeech-scale input)
# ---------------------------------------------------------------------------


def bucket_by_length(num_frames: dict, batch_size: int,
                     max_pad_ratio: float = 0.2, seed: int = 0) -> list:
    """Group utterances into fixed-size batches with bounded padding waste.

    The reference pads nothing (its nj threads stream one utterance at a
    time); here everything is padded to the batch max, so batch composition
    decides how much device work is padding.  Sort by length, cut greedily whenever adding
    the next utterance would push mean padding above ``max_pad_ratio`` or the
    batch is full, then shuffle the *batches* (not the members) so training
    order is randomized without re-introducing padding waste.

    Returns a list of (utt_list, t_pad) tuples.
    """
    order = sorted(num_frames, key=lambda u: (num_frames[u], u))
    batches = []
    cur: list = []
    for u in order:
        if cur:
            t_pad = num_frames[u]  # ascending order: candidate max
            waste = sum(t_pad - num_frames[x] for x in cur + [u])
            if len(cur) >= batch_size or \
                    waste > max_pad_ratio * t_pad * (len(cur) + 1):
                batches.append((cur, num_frames[cur[-1]]))
                cur = []
        cur.append(u)
    if cur:
        batches.append((cur, num_frames[cur[-1]]))
    rng = np.random.default_rng(seed)
    rng.shuffle(batches)
    return batches


def stream_batches(archive, num_frames: dict, batch_size: int,
                   max_pad_ratio: float = 0.2, seed: int = 0,
                   pad_multiple: int = 1):
    """Yield (utts, feats [B, T_pad, D], nf [B]) batches from an
    ``ArrayArchive`` without materializing the full dataset: the archive is
    memory-mapped, so each batch reads only its own rows (the streaming
    input pipeline of SURVEY §5.8; role of the nj-sharded ark readers).

    ``pad_multiple`` rounds the batch's utterance count up (zero-frame rows)
    so the leading axis divides the mesh's data-parallel size.
    """
    for utts, t_pad in bucket_by_length(num_frames, batch_size,
                                        max_pad_ratio, seed):
        b = -(-len(utts) // pad_multiple) * pad_multiple
        first = archive[utts[0]]
        feats = np.zeros((b, t_pad, *first.shape[1:]), first.dtype)
        nf = np.zeros(b, np.int32)
        for i, u in enumerate(utts):
            f = archive[u]
            feats[i, : f.shape[0]] = f
            nf[i] = f.shape[0]
        yield utts, feats, nf
