"""Banded Viterbi for training-graph alignment: gather-free.

The generic per-utterance alignment kernel (`ops/viterbi.py
viterbi_forward_batched`) relaxes arcs with per-element gathers
(``take_along_axis`` over ``[B, A]``).  Training
graphs — the output of `fst/hclg.py TrainingGraphCompiler` (the
``compile-train-graphs`` role, reference
``kaldi-master/src/bin/compile-train-graphs.cc``) — are nearly linear:
left-to-right word chains with optional silences and alternative
pronunciations, plus bounded cycles inside the silence HMM.  Under a BFS
state ordering every arc's index displacement ``dst - src`` lies in a small
band (measured ±11 on real compiled graphs), and all arcs entering a state
share that state's pdf (the reordered self-loop property of
``fst/hmm_graph.py add_self_loops``).

That structure makes the Viterbi recursion gather-free:

* relaxation = K static **shifts** of the ``alpha [B, S]`` slab (one per
  band offset) + add + max — pure elementwise traffic, no gathers;
* emissions = ONE batched one-hot **matmul** ``[B,T,P] x [B,P,S] -> [B,T,S]``
  (computed per time-chunk inside the scan to bound memory);
* backpointers = the winning band-slot index, ONE uint8 per state per frame
  (4x smaller than the generic kernel's int32 arc ids);
* backtrace runs on device (state walk via ``s - offset[k]``), one
  ``[T, B]`` host fetch.

`build_band_plan` returns None when a graph set does not fit the banded
form (band too wide, or pdfs not dst-pure); callers fall back to the
generic kernel.  Scores are max-plus and exactly match the generic kernel
(same arc set, same tie-free maxima).  Parallel arcs (same src/dst/pdf)
collapse to the single best-scoring one in the plan, and band-slot argmax
tie-breaking differs from the generic arc-tree reduce — equal-score ties can
yield a different (equally optimal) arc id than the generic kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .viterbi import NEG_INF, DenseGraph

__all__ = ["BandPlan", "build_band_plan", "viterbi_forward_banded",
           "backtrace_banded_device"]


class BandPlan(NamedTuple):
    """Host-built banded batch plan (states renumbered by per-graph BFS)."""

    W: np.ndarray  # [B, S, K] f32 graph score of the arc entering state s
    #                with displacement offsets[k] (NEG_INF where no arc)
    pdf: np.ndarray  # [B, S] int32 pdf shared by arcs entering s (0 default)
    arc_of: np.ndarray  # [B, S, K] int32 original arc id (-1 where no arc)
    offsets: tuple  # K sorted ints: arc displacement dst_pos - src_pos
    alpha0: np.ndarray  # [B, S] f32 initial scores (banded numbering)
    final: np.ndarray  # [B, S] f32 final scores (banded numbering)
    n2o: np.ndarray  # [B, S] int32 banded index -> original state (-1 pad)

    @property
    def num_padded_states(self) -> int:
        return self.W.shape[1]


def _bfs_order(g: DenseGraph) -> Optional[np.ndarray]:
    """BFS state order from the start states; None only if the graph has no
    start state.  States unreachable from the starts are parked at the END
    of the order: their alpha stays NEG_INF so arcs out of them can never
    win, but their arcs still receive band offsets and may widen the band
    (possibly past ``max_band``, in which case build_band_plan falls back)."""
    import collections

    adj: dict[int, list[int]] = collections.defaultdict(list)
    for s, d in zip(g.arc_src, g.arc_dst):
        adj[int(s)].append(int(d))
    starts = np.where(g.alpha0 > NEG_INF / 2)[0]
    if len(starts) == 0:
        return None
    seen = set(int(s) for s in starts)
    order = list(starts)
    dq = collections.deque(order)
    while dq:
        s = dq.popleft()
        for d in adj[s]:
            if d not in seen:
                seen.add(d)
                order.append(d)
                dq.append(d)
    if len(order) < g.num_states:
        rest = [s for s in range(g.num_states) if s not in seen]
        # unreachable states: park them at the end (their alpha stays
        # NEG_INF; arcs out of them can never win)
        order.extend(rest)
    return np.asarray(order, np.int64)


def build_band_plan(graphs: list[DenseGraph], pad_states: int | None = None,
                    max_band: int = 48,
                    reason: list | None = None) -> Optional[BandPlan]:
    """Build the banded batch plan, or None if the set isn't banded-friendly
    (band wider than ``max_band`` offsets, or a graph whose incoming arcs
    disagree on the destination pdf).  Pass a list as ``reason`` to receive
    a one-string diagnostic on failure (which constraint, which graph) —
    the fallback is all-or-nothing for the batch, so knowing WHICH graph
    broke it matters (round-5 flagship: one seed's triphone graph set fell
    back wholesale)."""
    b = len(graphs)
    s_pad = pad_states or max(g.num_states for g in graphs)
    orders, poss, offs_all = [], [], set()
    for gi, g in enumerate(graphs):
        order = _bfs_order(g)
        if order is None:
            if reason is not None:
                reason.append(f"graph {gi} has no start state")
            return None
        pos = np.empty(g.num_states, np.int64)
        pos[order] = np.arange(g.num_states)
        orders.append(order)
        poss.append(pos)
        if g.num_arcs:
            offs = pos[g.arc_dst] - pos[g.arc_src]
            offs_all.update(int(o) for o in np.unique(offs))
    offsets = tuple(sorted(offs_all))
    if len(offsets) == 0 or len(offsets) > max_band:
        if reason is not None:
            reason.append(f"band width {len(offsets)} exceeds max_band "
                          f"{max_band} (offset span "
                          f"[{min(offs_all, default=0)}, "
                          f"{max(offs_all, default=0)}])")
        return None
    koff = {o: k for k, o in enumerate(offsets)}
    k = len(offsets)

    W = np.full((b, s_pad, k), NEG_INF, np.float32)
    arc_of = np.full((b, s_pad, k), -1, np.int32)
    pdf = np.zeros((b, s_pad), np.int32)
    alpha0 = np.full((b, s_pad), NEG_INF, np.float32)
    final = np.full((b, s_pad), NEG_INF, np.float32)
    n2o = np.full((b, s_pad), -1, np.int32)
    for i, g in enumerate(graphs):
        pos, order = poss[i], orders[i]
        n2o[i, : g.num_states] = order
        alpha0[i, pos] = g.alpha0
        final[i, pos] = g.final_score
        dst_n = pos[g.arc_dst]
        src_n = pos[g.arc_src]
        # dst-purity check: all arcs entering a state must share its pdf
        seen_pdf = np.full(s_pad, -1, np.int64)
        for a in range(g.num_arcs):
            d = int(dst_n[a])
            p = int(g.arc_pdf[a])
            if seen_pdf[d] >= 0 and seen_pdf[d] != p:
                if reason is not None:
                    reason.append(
                        f"graph {i} not dst-pure: state {d} entered with "
                        f"pdfs {seen_pdf[d]} and {p}")
                return None
            seen_pdf[d] = p
            kk = koff[int(dst_n[a] - src_n[a])]
            # parallel arcs (same src/dst/pdf): keep the best-scoring one,
            # exactly what the max-plus recursion would pick
            if g.arc_score[a] > W[i, d, kk]:
                W[i, d, kk] = g.arc_score[a]
                arc_of[i, d, kk] = a
        pdf[i, seen_pdf >= 0] = seen_pdf[seen_pdf >= 0]
    return BandPlan(W=W, pdf=pdf, arc_of=arc_of, offsets=offsets,
                    alpha0=alpha0, final=final, n2o=n2o)


def _shift_src(a: jnp.ndarray, off: int) -> jnp.ndarray:
    """out[:, s] = a[:, s - off] (NEG_INF outside)."""
    if off == 0:
        return a
    if off > 0:
        return jnp.pad(a[:, :-off], ((0, 0), (off, 0)),
                       constant_values=NEG_INF)
    return jnp.pad(a[:, -off:], ((0, 0), (0, -off)),
                   constant_values=NEG_INF)


@functools.partial(jax.jit, static_argnames=("offsets", "t_chunk"))
def viterbi_forward_banded(W, pdf, alpha0, loglikes, num_frames,
                           acoustic_scale, offsets: tuple,
                           t_chunk: int = 128):
    """Banded forward pass.  W [B,S,K], pdf [B,S], alpha0 [B,S], loglikes
    [B,T,P] with T a multiple of ``t_chunk``.  Returns (alpha_end [B,S],
    bps [T,B,S] uint8 band-slot winners).

    Emissions are computed per time-chunk as a matmul: ``E = ll . onehot``
    with a one-hot [B,P,S] built once (HIGHEST precision keeps the products
    exact in f32 — each output sums exactly one nonzero term)."""
    b, t_total, p = loglikes.shape
    s = W.shape[1]
    onehot = (pdf[:, None, :] == jnp.arange(p, dtype=pdf.dtype)[None, :, None]
              ).astype(jnp.float32)  # [B, P, S]
    w_slabs = tuple(W[:, :, k] for k in range(len(offsets)))

    def frame_step(carry, e_t):
        alpha, alpha_at_end, t = carry
        cand = jnp.stack([_shift_src(alpha, off) + w_slabs[k]
                          for k, off in enumerate(offsets)])  # [K, B, S]
        bp = jnp.argmax(cand, axis=0).astype(jnp.uint8)
        new_alpha = jnp.max(cand, axis=0) + e_t
        active = (t < num_frames)[:, None]
        alpha = jnp.where(active, new_alpha, alpha)
        at_end = (t + 1 == num_frames)[:, None]
        alpha_at_end = jnp.where(at_end, alpha, alpha_at_end)
        return (alpha, alpha_at_end, t + 1), bp

    def chunk_step(carry, ll_c):  # ll_c [B, Tc, P]
        e = jax.lax.dot_general(
            ll_c, onehot, (((2,), (1,)), ((0,), (0,))),
            precision=jax.lax.Precision.HIGHEST) * acoustic_scale  # [B,Tc,S]
        carry, bps = jax.lax.scan(frame_step, carry,
                                  jnp.swapaxes(e, 0, 1))
        return carry, bps

    tn = t_total // t_chunk
    ll_chunks = jnp.swapaxes(
        loglikes.reshape(b, tn, t_chunk, p), 0, 1)  # [tn, B, Tc, P]
    zero_end = jnp.where((num_frames == 0)[:, None], alpha0,
                         jnp.full_like(alpha0, NEG_INF))
    (_, alpha_end, _), bps = jax.lax.scan(
        chunk_step, (alpha0, zero_end, jnp.int32(0)), ll_chunks)
    return alpha_end, bps.reshape(t_total, b, s)


@jax.jit
def backtrace_banded_device(alpha_end, final, bps, num_frames, offsets_arr,
                            arc_of):
    """Device backtrace over band-slot winners, resolving original arc ids
    on device (``arc_of [B,S,K]``) so ONE packed host fetch suffices.

    Returns (packed [T+2, B] int32, score [B] f32): rows 0..T-1 are original
    arc ids per frame (-1 inactive), row T the banded end state, row T+1 the
    ok flag (a finite-score path can never cross an empty band slot; if it
    ever did, arc id -1 at an active frame clears ok)."""
    b = alpha_end.shape[0]
    t_total = bps.shape[0]
    total = alpha_end + final
    score = jnp.max(total, axis=1)
    end_state = jnp.argmax(total, axis=1).astype(jnp.int32)
    ok = score > NEG_INF / 2
    bidx = jnp.arange(b)

    def step(carry, bp_t):
        st, ok, t = carry
        active = t < num_frames
        k = bp_t[bidx, st].astype(jnp.int32)
        a = arc_of[bidx, st, k]
        ok = jnp.where(active, ok & (a >= 0), ok)
        prev = st - offsets_arr[k]
        # guard on arc validity (like the generic backtrace's active&valid
        # mask): after an empty band slot ok is already False, but keep the
        # walk inside [0, S) instead of relying on index clamping
        st = jnp.where(active & (a >= 0), prev, st)
        return (st, ok, t - 1), jnp.where(active, a, -1)

    (_, ok, _), arcs_rev = jax.lax.scan(
        step, (end_state, ok, jnp.int32(t_total - 1)), bps[::-1])
    packed = jnp.concatenate(
        [arcs_rev[::-1], end_state[None, :], ok.astype(jnp.int32)[None, :]],
        axis=0)
    return packed, score
