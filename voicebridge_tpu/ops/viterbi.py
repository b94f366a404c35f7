"""Device-resident Viterbi over WFSTs: batched max-plus scans.

Replaces the reference's token-passing decoders (``FasterDecoder`` for
alignment, ``LatticeFasterDecoder`` for decoding,
``decoder/lattice-faster-decoder.cc:72-89``) with a batched device
formulation:

* Host side, offline: the graph's input-epsilon arcs are eliminated by
  epsilon-closure expansion (word outputs along closure paths preserved as
  "output sequence" ids), so every surviving arc consumes exactly one frame.
* Device side: Viterbi is a ``lax.scan`` over frames; each step is an
  arc-parallel relaxation — gather source scores, add graph weight and the
  frame's acoustic score for the arc's pdf, then reduce into destination
  states.  All utterances in a batch advance in lockstep ([B, S] state scores),
  instead of a pointer-chasing token list.
* The per-destination max is NOT a scatter (``segment_max`` lowers to a
  scatter): arcs are pre-sorted by destination on the host into a
  fixed-depth *gather reduction tree* (``ReductionPlan``): each level gathers
  K candidates per row and max-reduces, so every frame step is pure gathers
  + dense maxes.
* Backtraces are recovered from per-frame argmax arcs host-side (cheap).

Scores are in the max-plus (= negated tropical) domain: higher is better.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..fst.core import EPS, Fst, ZERO

NEG_INF = -1.0e30


class DenseGraph(NamedTuple):
    """Epsilon-free flat graph for the device decoder.  numpy/host fields
    ``oseqs`` hold word-output sequences referenced by arc/final/start ids."""

    num_states: int
    arc_src: np.ndarray  # [A] int32
    arc_dst: np.ndarray  # [A] int32
    arc_tid: np.ndarray  # [A] int32 (transition-id = graph input label)
    arc_pdf: np.ndarray  # [A] int32
    arc_score: np.ndarray  # [A] f32 (= -graph cost)
    arc_oseq: np.ndarray  # [A] int32 index into oseqs
    alpha0: np.ndarray  # [S] f32 initial scores (= -closure cost from start)
    start_oseq: np.ndarray  # [S] int32
    final_score: np.ndarray  # [S] f32 (= -final cost, NEG_INF if not final)
    final_oseq: np.ndarray  # [S] int32
    oseqs: list  # list[tuple[int]] — oseqs[0] = ()

    @property
    def num_arcs(self) -> int:
        return len(self.arc_src)


def _eps_closure_with_outputs(fst: Fst, state: int):
    """Best-cost closure over input-eps arcs from ``state``: returns
    {dest: (cost, olabels_tuple)} including (state, (0.0, ()))."""
    import heapq

    best: dict[int, tuple[float, tuple]] = {state: (0.0, ())}
    heap = [(0.0, state, ())]
    while heap:
        c, s, ostr = heapq.heappop(heap)
        if c > best[s][0] + 1e-12:
            continue
        for a in fst.arcs[s]:
            if a.ilabel != EPS:
                continue
            nc = c + a.weight
            no = ostr + ((a.olabel,) if a.olabel != EPS else ())
            cur = best.get(a.nextstate)
            if cur is None or nc < cur[0] - 1e-12:
                best[a.nextstate] = (nc, no)
                heapq.heappush(heap, (nc, a.nextstate, no))
    return best


def compile_dense_graph(fst: Fst, tid2pdf: np.ndarray) -> DenseGraph:
    """Flatten an HCLG-style FST (input = transition-ids, output = words) into
    an epsilon-free arc-parallel form."""
    n = fst.num_states
    oseq_ids: dict[tuple, int] = {(): 0}
    oseqs: list[tuple] = [()]

    def oseq_id(t: tuple) -> int:
        if t not in oseq_ids:
            oseq_ids[t] = len(oseqs)
            oseqs.append(t)
        return oseq_ids[t]

    closures = [_eps_closure_with_outputs(fst, s) for s in range(n)]

    src, dst, tid, wt, osq = [], [], [], [], []
    for s in range(n):
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                continue
            base_o = (a.olabel,) if a.olabel != EPS else ()
            for x, (c, ostr) in closures[a.nextstate].items():
                src.append(s)
                dst.append(x)
                tid.append(a.ilabel)
                wt.append(-(a.weight + c))
                osq.append(oseq_id(base_o + ostr))

    alpha0 = np.full(n, NEG_INF, dtype=np.float32)
    start_oseq = np.zeros(n, dtype=np.int32)
    if fst.start >= 0:
        for x, (c, ostr) in closures[fst.start].items():
            if -c > alpha0[x]:
                alpha0[x] = -c
                start_oseq[x] = oseq_id(ostr)

    final_score = np.full(n, NEG_INF, dtype=np.float32)
    final_oseq = np.zeros(n, dtype=np.int32)
    for s in range(n):
        for x, (c, ostr) in closures[s].items():
            if fst.finals[x] != ZERO:
                sc = -(c + fst.finals[x])
                if sc > final_score[s]:
                    final_score[s] = sc
                    final_oseq[s] = oseq_id(ostr)

    arc_tid = np.asarray(tid, dtype=np.int32)
    return DenseGraph(
        num_states=n,
        arc_src=np.asarray(src, dtype=np.int32),
        arc_dst=np.asarray(dst, dtype=np.int32),
        arc_tid=arc_tid,
        arc_pdf=tid2pdf[arc_tid].astype(np.int32),
        arc_score=np.asarray(wt, dtype=np.float32),
        arc_oseq=np.asarray(osq, dtype=np.int32),
        alpha0=alpha0,
        start_oseq=start_oseq,
        final_score=final_score,
        final_oseq=final_oseq,
        oseqs=oseqs,
    )


def pad_graphs(graphs: list[DenseGraph], pad_states: Optional[int] = None,
               pad_arcs: Optional[int] = None, plans: list | None = None,
               plan_depth: int | None = None,
               plan_rows: list[int] | None = None):
    """Stack per-utterance graphs into padded batch arrays (for training
    alignment, where every utterance has its own graph).  Padding arcs point
    from/to a dead padding state with NEG_INF score.  ``plans`` (+ optional
    ``plan_depth``/``plan_rows`` global targets from
    :func:`batched_plan_spec`) reuse precomputed reduction plans so chunked
    sub-batches share one padded shape."""
    s_max = pad_states or max(g.num_states for g in graphs)
    a_max = pad_arcs or max(g.num_arcs for g in graphs)
    s_pad = s_max + 1  # last state = dead state
    b = len(graphs)

    def pad_arc(field, fill, dtype):
        out = np.full((b, a_max), fill, dtype=dtype)
        for i, g in enumerate(graphs):
            out[i, : g.num_arcs] = getattr(g, field)
        return out

    arc_src = pad_arc("arc_src", s_max, np.int32)
    arc_dst = pad_arc("arc_dst", s_max, np.int32)
    arc_tid = pad_arc("arc_tid", 0, np.int32)
    arc_pdf = pad_arc("arc_pdf", 0, np.int32)
    arc_score = pad_arc("arc_score", NEG_INF, np.float32)
    arc_oseq = pad_arc("arc_oseq", 0, np.int32)

    def pad_state(field, fill, dtype):
        out = np.full((b, s_pad), fill, dtype=dtype)
        for i, g in enumerate(graphs):
            out[i, : g.num_states] = getattr(g, field)
        return out

    alpha0 = pad_state("alpha0", NEG_INF, np.float32)
    final_score = pad_state("final_score", NEG_INF, np.float32)
    levels = build_batched_plans([g.arc_dst for g in graphs],
                                 [g.num_arcs for g in graphs], s_pad,
                                 plans=plans, depth=plan_depth,
                                 rows_per_level=plan_rows)
    return dict(
        arc_src=arc_src, arc_dst=arc_dst, arc_tid=arc_tid, arc_pdf=arc_pdf,
        arc_score=arc_score, arc_oseq=arc_oseq, alpha0=alpha0,
        final_score=final_score, num_states=s_pad, levels=levels,
    )


# ---------------------------------------------------------------------------
# Gather reduction tree (replaces scatter-based segment_max)
# ---------------------------------------------------------------------------


class ReductionPlan(NamedTuple):
    """Host-built plan for per-destination max over arc scores.

    ``levels[0]`` indexes arcs; each subsequent level indexes the previous
    level's row outputs; the last level has exactly ``num_states`` rows (row s
    = state s).  Entries are -1 where padded.
    """

    levels: tuple  # tuple[np.ndarray [R_i, K] int32]
    num_states: int


def build_reduction_plan(arc_dst: np.ndarray, num_states: int, k: int = 16) -> ReductionPlan:
    order = np.argsort(arc_dst, kind="stable").astype(np.int32)
    groups = np.asarray(arc_dst, np.int32)[order]  # sorted dst per element
    elems = order  # element ids at current level = arc indices
    levels = []
    while True:
        n = len(elems)
        if n == 0:
            levels.append(np.full((num_states, k), -1, np.int32))
            return ReductionPlan(tuple(levels), num_states)
        # runs of equal group
        boundaries = np.flatnonzero(np.diff(groups)) + 1
        run_starts = np.concatenate([[0], boundaries]).astype(np.int64)
        run_ends = np.concatenate([boundaries, [n]]).astype(np.int64)
        run_lens = run_ends - run_starts
        chunks_per_run = -(-run_lens // k)
        r = int(chunks_per_run.sum())
        first_chunk = np.concatenate([[0], np.cumsum(chunks_per_run[:-1])])
        chunk_run = np.repeat(np.arange(len(run_starts)), chunks_per_run)
        chunk_rank = np.arange(r) - first_chunk[chunk_run]
        chunk_start = run_starts[chunk_run] + k * chunk_rank
        pos = chunk_start[:, None] + np.arange(k)[None, :]
        valid = pos < run_ends[chunk_run][:, None]
        idx = np.where(valid, elems[np.minimum(pos, n - 1)], -1).astype(np.int32)
        row_groups = groups[run_starts][chunk_run]
        if int(chunks_per_run.max()) <= 1:
            final = np.full((num_states, k), -1, np.int32)
            final[row_groups] = idx
            levels.append(final)
            return ReductionPlan(tuple(levels), num_states)
        levels.append(idx)
        elems = np.arange(r, dtype=np.int32)
        groups = row_groups.astype(np.int32)


def _tree_reduce_max(values: jnp.ndarray, levels: tuple):
    """values [A] -> (state_max [S], winner_arc [S]); levels are device arrays."""
    v = values
    widx = None  # winner arc per current row
    for idx in levels:
        safe = jnp.maximum(idx, 0)
        g = jnp.where(idx >= 0, v[safe], NEG_INF)  # [R, K]
        arg = jnp.argmax(g, axis=1)  # [R]
        v = jnp.take_along_axis(g, arg[:, None], axis=1)[:, 0]
        chosen = jnp.take_along_axis(idx, arg[:, None], axis=1)[:, 0]  # [R]
        if widx is None:
            widx = chosen  # arc ids
        else:
            widx = jnp.where(chosen >= 0, widx[jnp.maximum(chosen, 0)], -1)
        widx = jnp.where(v > NEG_INF / 2, widx, -1)
    return v, widx


def _relax_tree(scores: jnp.ndarray, levels: tuple):
    """scores [..., A] (leading batch dims vmapped) -> ([..., S], [..., S])."""
    if scores.ndim == 1:
        return _tree_reduce_max(scores, levels)
    return jax.vmap(lambda s: _tree_reduce_max(s, levels))(scores)



def _prune(new_alpha: jnp.ndarray, beam, max_active: int) -> jnp.ndarray:
    """Beam + max-active pruning of [B, S] scores (the role of Kaldi's
    GetCutoff/adaptive beam, lattice-faster-decoder.cc:618): keep states
    within ``beam`` of the best, and at most ``max_active`` states."""
    best = jnp.max(new_alpha, axis=1, keepdims=True)
    out = jnp.where(new_alpha >= best - beam, new_alpha, NEG_INF)
    if max_active and max_active < out.shape[1]:
        kth = jax.lax.top_k(out, max_active)[0][:, -1:]
        out = jnp.where(out >= kth, out, NEG_INF)
    return out


class FusedPlan(NamedTuple):
    """Level-0-fused reduction plan: the first level's rows carry
    pre-gathered (src, weight, pdf) so the per-frame step never materializes
    the [B, A] arc-score array — the candidate block [R0, K] is computed
    directly from alpha and the frame's loglikes."""

    l0_arc: np.ndarray  # [R0, K] arc id (-1 pad)
    l0_src: np.ndarray  # [R0, K] arc source state (0 pad)
    l0_w: np.ndarray  # [R0, K] arc score (-inf pad)
    l0_pdf: np.ndarray  # [R0, K] arc pdf (0 pad)
    upper: tuple  # remaining levels (level 1.. indexes level-0 rows)


def build_fused_plan(graph: "DenseGraph", k: int = 8) -> FusedPlan:
    plan = build_reduction_plan(graph.arc_dst, graph.num_states, k)
    l0 = plan.levels[0]
    valid = l0 >= 0
    safe = np.maximum(l0, 0)
    return FusedPlan(
        l0_arc=l0,
        l0_src=np.where(valid, graph.arc_src[safe], 0).astype(np.int32),
        l0_w=np.where(valid, graph.arc_score[safe], NEG_INF).astype(np.float32),
        l0_pdf=np.where(valid, graph.arc_pdf[safe], 0).astype(np.int32),
        upper=plan.levels[1:],
    )


def _fused_reduce_max(alpha: jnp.ndarray, ll_t: jnp.ndarray, plan: FusedPlan,
                      acoustic_scale):
    """alpha [S], ll_t [P] -> (new_alpha [S], winner arc [S])."""
    g = alpha[plan.l0_src] + plan.l0_w + ll_t[plan.l0_pdf] * acoustic_scale
    g = jnp.where(plan.l0_arc >= 0, g, NEG_INF)  # [R0, K]
    arg = jnp.argmax(g, axis=1)
    v = jnp.take_along_axis(g, arg[:, None], axis=1)[:, 0]
    widx = jnp.take_along_axis(plan.l0_arc, arg[:, None], axis=1)[:, 0]
    widx = jnp.where(v > NEG_INF / 2, widx, -1)
    for idx in plan.upper:
        safe = jnp.maximum(idx, 0)
        gg = jnp.where(idx >= 0, v[safe], NEG_INF)
        arg = jnp.argmax(gg, axis=1)
        v = jnp.take_along_axis(gg, arg[:, None], axis=1)[:, 0]
        chosen = jnp.take_along_axis(idx, arg[:, None], axis=1)[:, 0]
        widx = jnp.where(chosen >= 0, widx[jnp.maximum(chosen, 0)], -1)
        widx = jnp.where(v > NEG_INF / 2, widx, -1)
    return v, widx


@functools.partial(jax.jit, static_argnames=("num_states", "max_active"))
def viterbi_forward_shared_fused(plan: FusedPlan, alpha0, loglikes, num_frames,
                                 acoustic_scale, beam, num_states: int,
                                 max_active: int = 0):
    """Fused-level-0 variant of viterbi_forward_shared (same outputs)."""
    b = loglikes.shape[0]

    def step(carry, inp):
        alpha, alpha_at_end, t = carry
        ll_t = inp  # [B, P]
        new_alpha, bp = jax.vmap(
            lambda a, l: _fused_reduce_max(a, l, plan, acoustic_scale)
        )(alpha, ll_t)
        new_alpha = _prune(new_alpha, beam, max_active)
        active = (t < num_frames)[:, None]
        alpha = jnp.where(active, new_alpha, alpha)
        at_end = (t + 1 == num_frames)[:, None]
        alpha_at_end = jnp.where(at_end, alpha, alpha_at_end)
        return (alpha, alpha_at_end, t + 1), bp

    alpha_init = jnp.broadcast_to(alpha0[None, :], (b, num_states))
    zero_end = jnp.where((num_frames == 0)[:, None], alpha_init,
                         jnp.full((b, num_states), NEG_INF))
    (_, alpha_end, _), bps = jax.lax.scan(
        step, (alpha_init, zero_end, jnp.int32(0)),
        jnp.swapaxes(loglikes, 0, 1))
    return alpha_end, bps


@functools.partial(jax.jit, static_argnames=("num_states", "max_active"))
def viterbi_forward_shared(arc_src, levels, arc_pdf, arc_score, alpha0,
                           loglikes, num_frames, acoustic_scale, beam,
                           num_states: int, max_active: int = 0):
    """Shared decode graph, batched utterances.

    arc_src/arc_pdf/arc_score: [A]; ``levels``: reduction-plan index arrays;
    alpha0 [S]; loglikes [B, T, P]; num_frames [B].
    Returns (alpha_final [B, S] at each utterance's own end, bp [T, B, S]).
    """
    b = loglikes.shape[0]

    def step(carry, inp):
        alpha, alpha_at_end, t = carry
        ll_t = inp  # [B, P]
        am = ll_t[:, arc_pdf] * acoustic_scale  # [B, A]
        score = alpha[:, arc_src] + arc_score[None, :] + am  # [B, A]
        new_alpha, bp = _relax_tree(score, levels)
        new_alpha = _prune(new_alpha, beam, max_active)
        active = (t < num_frames)[:, None]  # [B, 1]
        alpha = jnp.where(active, new_alpha, alpha)
        # snapshot alpha at the utterance's last frame
        at_end = (t + 1 == num_frames)[:, None]
        alpha_at_end = jnp.where(at_end, alpha, alpha_at_end)
        return (alpha, alpha_at_end, t + 1), bp

    alpha_init = jnp.broadcast_to(alpha0[None, :], (b, num_states))
    zero_end = jnp.where(
        (num_frames == 0)[:, None], alpha_init, jnp.full((b, num_states), NEG_INF))
    (_, alpha_end, _), bps = jax.lax.scan(
        step, (alpha_init, zero_end, jnp.int32(0)),
        jnp.swapaxes(loglikes, 0, 1))
    return alpha_end, bps


def _aligned_levels(plan_levels: tuple, num_arcs: int, depth: int, k: int):
    """Pad a per-graph plan to ``depth`` levels by inserting identity
    passthrough levels before the final state-level."""
    levels = list(plan_levels)
    while len(levels) < depth:
        dom = levels[-2].shape[0] if len(levels) >= 2 else num_arcs
        ident = np.full((dom, k), -1, np.int32)
        ident[:, 0] = np.arange(dom, dtype=np.int32)
        levels.insert(len(levels) - 1, ident)
    return levels


def batched_plan_spec(plans: list, num_arcs_each: list[int], k: int = 16):
    """Global (depth, rows-per-level) targets over a set of per-graph plans,
    so that any subset stacked with these targets shares ONE padded shape
    (keeps the jit cache warm across sub-batches)."""
    depth = max(len(p.levels) for p in plans)
    rows = [0] * depth
    for p, na in zip(plans, num_arcs_each):
        lv = _aligned_levels(p.levels, na, depth, k)
        for d in range(depth):
            rows[d] = max(rows[d], lv[d].shape[0])
    return depth, rows


def build_batched_plans(graphs_arc_dst: list[np.ndarray], num_arcs_each: list[int],
                        num_states: int, k: int = 16, plans: list | None = None,
                        depth: int | None = None,
                        rows_per_level: list[int] | None = None) -> tuple:
    """Per-graph reduction plans padded to a common (depth, rows) shape and
    stacked on the batch axis: tuple of [B, R_i, K] int32 arrays.

    Depth alignment: graphs with shallower trees get identity passthrough
    levels inserted before their final state-level so every graph has the
    same number of levels.  ``plans``/``depth``/``rows_per_level`` allow
    reusing precomputed per-graph plans and padding every stacked subset to
    one global shape (see :func:`batched_plan_spec`).
    """
    if plans is None:
        plans = [build_reduction_plan(np.asarray(dst[:na]), num_states, k)
                 for dst, na in zip(graphs_arc_dst, num_arcs_each)]
    depth = depth or max(len(p.levels) for p in plans)
    fixed = [_aligned_levels(p.levels, na, depth, k)
             for p, na in zip(plans, num_arcs_each)]
    out = []
    for d in range(depth):
        r_max = max(f[d].shape[0] for f in fixed)
        if rows_per_level is not None:
            r_max = max(r_max, rows_per_level[d])
        stack = np.full((len(fixed), r_max, k), -1, np.int32)
        for i, f in enumerate(fixed):
            stack[i, : f[d].shape[0]] = f[d]
        out.append(stack)
    return tuple(out)


@functools.partial(jax.jit, static_argnames=("num_states", "max_active"))
def viterbi_forward_batched(arc_src, levels, arc_pdf, arc_score, alpha0,
                            loglikes, num_frames, acoustic_scale, beam,
                            num_states: int, max_active: int = 0):
    """Per-utterance graphs (training alignment): arc_* [B, A], alpha0 [B, S],
    loglikes [B, T, P]; ``levels`` = per-graph reduction plans stacked on the
    batch axis (from :func:`build_batched_plans`).  Returns
    (alpha_end [B, S], bp [T, B, S] with per-utterance arc ids)."""
    b, a = arc_src.shape
    s = num_states

    def step(carry, inp):
        alpha, alpha_at_end, t = carry  # alpha [B, S]
        ll_t = inp  # [B, P]
        am = jnp.take_along_axis(ll_t, arc_pdf, axis=1) * acoustic_scale  # [B, A]
        src_sc = jnp.take_along_axis(alpha, arc_src, axis=1)  # [B, A]
        score = src_sc + arc_score + am  # [B, A]
        new_alpha, bp = jax.vmap(_tree_reduce_max)(score, levels)
        new_alpha = _prune(new_alpha, beam, max_active)
        active = (t < num_frames)[:, None]
        alpha = jnp.where(active, new_alpha, alpha)
        at_end = (t + 1 == num_frames)[:, None]
        alpha_at_end = jnp.where(at_end, alpha, alpha_at_end)
        return (alpha, alpha_at_end, t + 1), bp

    zero_end = jnp.where((num_frames == 0)[:, None], alpha0,
                         jnp.full_like(alpha0, NEG_INF))
    (_, alpha_end, _), bps = jax.lax.scan(
        step, (alpha0, zero_end, jnp.int32(0)), jnp.swapaxes(loglikes, 0, 1))
    return alpha_end, bps


# ---------------------------------------------------------------------------
# N-best Viterbi (per-state K-hypothesis lists)
# ---------------------------------------------------------------------------


def _nbest_reduce(cand: jnp.ndarray, prov_arc: jnp.ndarray, prov_slot: jnp.ndarray,
                  levels: tuple, nbest: int):
    """cand [A, K] candidate scores (per arc, per source slot) with provenance
    -> per-state top-K: (scores [S, K], arc [S, K], slot [S, K]).

    Reuses the destination-grouped reduction tree: each level gathers child
    rows' K-lists, flattens, and takes the top K.
    """
    v = cand  # [R, K]
    pa, ps = prov_arc, prov_slot
    for idx in levels:
        safe = jnp.maximum(idx, 0)
        g = jnp.where(idx[..., None] >= 0, v[safe], NEG_INF)  # [R, Kin, K]
        ga = jnp.where(idx[..., None] >= 0, pa[safe], -1)
        gs = jnp.where(idx[..., None] >= 0, ps[safe], 0)
        r, kin, k = g.shape
        flat = g.reshape(r, kin * k)
        vals, top = jax.lax.top_k(flat, nbest)  # [R, nbest]
        v = vals
        pa = jnp.take_along_axis(ga.reshape(r, kin * k), top, axis=1)
        ps = jnp.take_along_axis(gs.reshape(r, kin * k), top, axis=1)
    return v, pa, ps


@functools.partial(jax.jit, static_argnames=("num_states", "nbest"))
def viterbi_nbest_forward(arc_src, levels, arc_pdf, arc_score, alpha0,
                          loglikes, num_frames, acoustic_scale, beam,
                          num_states: int, nbest: int):
    """Exact N-best Viterbi over a shared graph: every state carries its K
    best partial-path scores (the role of lattice N-best,
    ``lattice-nbest``/``nshortest``).

    loglikes [B, T, P].  Returns (alpha_end [B, S, K],
    bp_arc [T, B, S, K] int32, bp_slot [T, B, S, K] int8) — full backpointer
    storage; use moderate sizes (N-best is a rescoring-scale operation).
    """
    b = loglikes.shape[0]
    a = arc_src.shape[0]

    def one_step(alpha, ll_t):
        # candidates per arc per slot
        am = ll_t[arc_pdf] * acoustic_scale  # [A]
        cand = alpha[arc_src] + (arc_score + am)[:, None]  # [A, K]
        prov_arc = jnp.broadcast_to(
            jnp.arange(a, dtype=jnp.int32)[:, None], (a, nbest))
        prov_slot = jnp.broadcast_to(
            jnp.arange(nbest, dtype=jnp.int8)[None, :], (a, nbest))
        scores, pa, ps = _nbest_reduce(cand, prov_arc, prov_slot, levels, nbest)
        best = jnp.max(scores)
        scores = jnp.where(scores >= best - beam, scores, NEG_INF)
        return scores, pa, ps

    def step(carry, inp):
        alpha, alpha_at_end, t = carry  # [B, S, K]
        ll_t = inp  # [B, P]
        scores, pa, ps = jax.vmap(one_step)(alpha, ll_t)
        active = (t < num_frames)[:, None, None]
        alpha = jnp.where(active, scores, alpha)
        at_end = (t + 1 == num_frames)[:, None, None]
        alpha_at_end = jnp.where(at_end, alpha, alpha_at_end)
        return (alpha, alpha_at_end, t + 1), (pa, ps)

    alpha_init = jnp.full((b, num_states, nbest), NEG_INF)
    alpha_init = alpha_init.at[:, :, 0].set(
        jnp.broadcast_to(alpha0[None, :], (b, num_states)))
    zero_end = jnp.where((num_frames == 0)[:, None, None], alpha_init,
                         jnp.full_like(alpha_init, NEG_INF))
    (_, alpha_end, _), (bp_arc, bp_slot) = jax.lax.scan(
        step, (alpha_init, zero_end, jnp.int32(0)),
        jnp.swapaxes(loglikes, 0, 1))
    return alpha_end, bp_arc, bp_slot


def backtrace_nbest(graph: DenseGraph, alpha_end, bp_arc, bp_slot, num_frames,
                    nbest: int):
    """-> per utterance: list of up to ``nbest`` dicts (words, tids, score)."""
    alpha_end = np.asarray(alpha_end)
    bp_arc = np.asarray(bp_arc)
    bp_slot = np.asarray(bp_slot)
    b = alpha_end.shape[0]
    out = []
    for i in range(b):
        t_end = int(num_frames[i])
        total = alpha_end[i] + graph.final_score[:, None]  # [S, K]
        flat = total.reshape(-1)
        order = np.argsort(-flat)[: nbest * 4]
        hyps = []
        seen = set()
        for fidx in order:
            if flat[fidx] <= NEG_INF / 2 or len(hyps) >= nbest:
                break
            s, k = divmod(int(fidx), alpha_end.shape[2])
            score = float(flat[fidx])
            arcs = []
            si, ki = s, k
            ok = True
            for t in range(t_end - 1, -1, -1):
                a = int(bp_arc[t, i, si, ki])
                if a < 0:
                    ok = False
                    break
                ki = int(bp_slot[t, i, si, ki])
                arcs.append(a)
                si = int(graph.arc_src[a])
            if not ok:
                continue
            arcs.reverse()
            words = list(graph.oseqs[graph.start_oseq[si]])
            for a in arcs:
                words.extend(graph.oseqs[graph.arc_oseq[a]])
            words.extend(graph.oseqs[graph.final_oseq[s]])
            key = tuple(arcs)
            if key in seen:
                continue
            seen.add(key)
            hyps.append({"words": words, "score": score,
                         "tids": [int(graph.arc_tid[a]) for a in arcs],
                         "arcs": arcs})
        out.append(hyps)
    return out


# ---------------------------------------------------------------------------
# Host-side backtrace
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("num_states", "window", "max_active"))
def _window_forward_with_bp(arc_src, levels, arc_pdf, arc_score, alpha_start,
                            loglikes_win, num_frames, t0, acoustic_scale, beam,
                            num_states: int, window: int, max_active: int = 0):
    """Re-run ``window`` frames from a snapshot, recording backpointers.
    alpha_start [B, S]; loglikes_win [B, W, P]; returns bp [W, B, S]."""

    def step(carry, inp):
        alpha, t = carry
        ll_t = inp
        am = ll_t[:, arc_pdf] * acoustic_scale
        score = alpha[:, arc_src] + arc_score[None, :] + am
        new_alpha, bp = _relax_tree(score, levels)
        new_alpha = _prune(new_alpha, beam, max_active)
        active = (t < num_frames)[:, None]
        alpha = jnp.where(active, new_alpha, alpha)
        return (alpha, t + 1), bp

    (_, _), bps = jax.lax.scan(step, (alpha_start, t0),
                               jnp.swapaxes(loglikes_win, 0, 1))
    return bps


@functools.partial(jax.jit, static_argnames=())
def _window_backtrace(bps, arc_src, state, nf, t_hi0):
    """Device backtrace through one window's backpointers.

    bps [W, B, S]; state [B] (state at each utterance's current frontier);
    nf [B]; t_hi0 = frame index of bps[W-1] + 1 (= lo + W).
    Returns (arcs [W, B] in forward order, -1 where inactive; state [B] at
    window start)."""
    b = state.shape[0]
    bidx = jnp.arange(b)

    def step(carry, bp_t):
        s, t = carry
        active = t < nf  # frames >= nf are padding
        a = bp_t[bidx, s]
        a = jnp.where(active, a, -1)
        new_s = jnp.where(a >= 0, arc_src[jnp.maximum(a, 0)], s)
        return (new_s, t - 1), a

    (state_out, _), arcs_rev = jax.lax.scan(
        step, (state, t_hi0 - 1), bps[::-1])
    return arcs_rev[::-1], state_out


def viterbi_decode_windowed(graph: DenseGraph, levels, loglikes, num_frames,
                            acoustic_scale: float, beam: float,
                            window: int = 64, max_active: int = 0):
    """Memory-bounded exact Viterbi decode over a shared graph.

    Phase 1: forward scan storing an alpha snapshot at each window start
    (memory [NW, B, S] instead of backpointers [T, B, S]).
    Phase 2: per window (reverse order), re-run the window recording
    backpointers and backtrace through it on the host.

    Returns the same structure as ``backtrace_shared``.
    """
    b, t_total, _p = loglikes.shape
    s = graph.num_states
    nw = max(1, -(-t_total // window))
    t_pad = nw * window
    if t_pad != t_total:
        pad = jnp.zeros((b, t_pad - t_total, loglikes.shape[2]), loglikes.dtype)
        loglikes = jnp.concatenate([loglikes, pad], axis=1)

    arc_src = jnp.asarray(graph.arc_src)
    arc_pdf = jnp.asarray(graph.arc_pdf)
    arc_score = jnp.asarray(graph.arc_score)
    alpha0 = jnp.broadcast_to(jnp.asarray(graph.alpha0)[None, :], (b, s))
    nf = jnp.asarray(num_frames)
    acwt = jnp.float32(acoustic_scale)
    beam_ = jnp.float32(beam)

    @functools.partial(jax.jit, static_argnames=())
    def window_forward(alpha, at_end, ll_win, t0):
        """One window of forward Viterbi (no backpointers).  One modest
        compiled program invoked per window from Python, which bounds the
        backpointer memory to one window."""

        def frame(c, ll_t):
            al, ae, tt = c
            am = ll_t[:, arc_pdf] * acwt
            score = al[:, arc_src] + arc_score[None, :] + am
            na, _ = _relax_tree(score, levels)
            na = _prune(na, beam_, max_active)
            active = (tt < nf)[:, None]
            al = jnp.where(active, na, al)
            end = (tt + 1 == nf)[:, None]
            ae = jnp.where(end, al, ae)
            return (al, ae, tt + 1), None

        (al, ae, _), _ = jax.lax.scan(frame, (alpha, at_end, t0),
                                      jnp.swapaxes(ll_win, 0, 1))
        return al, ae

    # phase 1: forward pass, snapshot alpha at each window start (snapshots
    # stay DEVICE-RESIDENT as a list of [B, S] arrays)
    alpha = alpha0
    at_end = jnp.where((nf == 0)[:, None], alpha0,
                       jnp.full((b, s), NEG_INF))
    snaps = []
    for w in range(nw):
        snaps.append(alpha)
        ll_win = jax.lax.dynamic_slice_in_dim(loglikes, w * window, window,
                                              axis=1)
        alpha, at_end = window_forward(alpha, at_end, ll_win,
                                       jnp.int32(w * window))
    alpha_end = np.asarray(at_end)
    nf_np = np.asarray(num_frames)

    # choose end state per utterance
    end_state = np.zeros(b, np.int64)
    scores = np.zeros(b, np.float32)
    has_path = np.zeros(b, bool)
    use_final = np.zeros(b, bool)
    for i in range(b):
        total = alpha_end[i] + graph.final_score
        if np.max(total) > NEG_INF / 2:
            end_state[i] = int(np.argmax(total))
            scores[i] = float(total[end_state[i]])
            use_final[i] = True
            has_path[i] = True
        elif np.max(alpha_end[i]) > NEG_INF / 2:
            end_state[i] = int(np.argmax(alpha_end[i]))
            scores[i] = float(alpha_end[i][end_state[i]])
            has_path[i] = True

    # phase 2: reverse windows — forward-with-bp + backtrace run ON DEVICE
    # (the [W, B, S] backpointer tensor never leaves the chip; only [W, B]
    # arc ids per window come back)
    arc_window_chunks: list[np.ndarray] = []  # [W, B] per window, reverse order
    cur_state = jnp.asarray(end_state.astype(np.int32))
    arc_src_j = arc_src
    for w in range(nw - 1, -1, -1):
        lo = w * window
        # utterances whose last frame falls inside this window start their
        # backtrace here at their chosen end state
        enters = (nf_np > lo) & (nf_np <= lo + window) & has_path
        if enters.any():
            cur_state = jnp.where(jnp.asarray(enters),
                                  jnp.asarray(end_state.astype(np.int32)),
                                  cur_state)
        ll_win = jax.lax.dynamic_slice_in_dim(loglikes, lo, window, axis=1)
        bps = _window_forward_with_bp(
            arc_src, levels, arc_pdf, arc_score,
            snaps[w],
            ll_win, nf, jnp.int32(lo), acwt, beam_, s, window, max_active)
        arcs_w, cur_state = _window_backtrace(bps, arc_src_j, cur_state, nf,
                                              jnp.int32(lo + window))
        arc_window_chunks.append(arcs_w)  # device array; fetch once at the end
    # stitch windows (collected high-to-low) on device, then ONE host fetch —
    # a per-window np.asarray would synchronize the stream every iteration
    all_arcs = np.asarray(jnp.concatenate(arc_window_chunks[::-1], axis=0))

    out = []
    for i in range(b):
        n = int(nf_np[i])
        arcs = [int(a) for a in all_arcs[:n, i]]
        if not has_path[i] or any(a < 0 for a in arcs):
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        start_s = int(graph.arc_src[arcs[0]]) if arcs else int(end_state[i])
        words: list[int] = list(graph.oseqs[graph.start_oseq[start_s]])
        for a in arcs:
            words.extend(graph.oseqs[graph.arc_oseq[a]])
        if use_final[i]:
            words.extend(graph.oseqs[graph.final_oseq[end_state[i]]])
        out.append({
            "tids": [int(graph.arc_tid[a]) for a in arcs],
            "words": words,
            "score": float(scores[i]),
            "arcs": arcs,
        })
    return out


def backtrace_shared(graph: DenseGraph, alpha_end: np.ndarray, bps: np.ndarray,
                     num_frames: np.ndarray, require_final: bool = True):
    """Recover per-utterance best paths from a shared-graph forward pass.

    Returns list of dicts: {"tids": [T_b], "words": [...], "score": float,
    "arcs": [T_b]} (empty when no path)."""
    b = alpha_end.shape[0]
    out = []
    for i in range(b):
        t_end = int(num_frames[i])
        total = alpha_end[i] + graph.final_score
        if require_final and np.max(total) > NEG_INF / 2:
            s = int(np.argmax(total))
            score = float(total[s])
            final_words = graph.oseqs[graph.final_oseq[s]]
        else:
            s = int(np.argmax(alpha_end[i]))
            score = float(alpha_end[i][s])
            final_words = ()
        if alpha_end[i][s] <= NEG_INF / 2:
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        arcs = []
        ok = True
        for t in range(t_end - 1, -1, -1):
            a = int(bps[t, i, s])
            if a < 0:
                ok = False
                break
            arcs.append(a)
            s = int(graph.arc_src[a])
        if not ok:
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        arcs.reverse()
        words: list[int] = list(graph.oseqs[graph.start_oseq[s]])
        for a in arcs:
            words.extend(graph.oseqs[graph.arc_oseq[a]])
        words.extend(final_words)
        out.append({
            "tids": [int(graph.arc_tid[a]) for a in arcs],
            "words": words,
            "score": score,
            "arcs": arcs,
        })
    return out


@jax.jit
def backtrace_batched_device(arc_src, alpha_end, final_score, bps, num_frames):
    """Device-side backtrace for per-utterance padded graphs.

    The full ``bps [T, B, S]`` tensor exceeds 1 GB at real-corpus scale
    (~1.2k utts); this walks it ON DEVICE so only ``[T, B]`` arc ids come
    back to the host
    (same role as the reference decoder's in-memory backtrace,
    ``faster-decoder.h`` GetBestPath).

    arc_src [B, A]; alpha_end/final_score [B, S]; bps [T, B, S] arc ids.
    Returns (arcs [T, B] int32, -1 at inactive frames; ok [B] bool;
    end_state [B] int32; score [B] f32).
    """
    b = arc_src.shape[0]
    t_total = bps.shape[0]
    total = alpha_end + final_score
    score = jnp.max(total, axis=1)
    end_state = jnp.argmax(total, axis=1).astype(jnp.int32)
    ok0 = score > NEG_INF / 2
    bidx = jnp.arange(b)

    def step(carry, bp_t):
        s, ok, t = carry
        active = t < num_frames
        a = bp_t[bidx, s]
        valid = a >= 0
        ok = jnp.where(active, ok & valid, ok)
        src = arc_src[bidx, jnp.maximum(a, 0)]
        s = jnp.where(active & valid, src, s)
        return (s, ok, t - 1), jnp.where(active, a, -1)

    (_, ok, _), arcs_rev = jax.lax.scan(
        step, (end_state, ok0, jnp.int32(t_total - 1)), bps[::-1])
    return arcs_rev[::-1], ok, end_state, score


def assemble_batched_results(graphs: list[DenseGraph], arcs: np.ndarray,
                             ok: np.ndarray, end_state: np.ndarray,
                             score: np.ndarray, num_frames: np.ndarray):
    """Host assembly of per-utterance results from a device backtrace
    (:func:`backtrace_batched_device`): same output structure as
    :func:`backtrace_batched`."""
    out = []
    for i, g in enumerate(graphs):
        n = int(num_frames[i])
        if not ok[i]:
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        a_i = arcs[:n, i].astype(np.int64)
        s = int(g.arc_src[a_i[0]]) if n else int(end_state[i])
        words: list[int] = list(g.oseqs[g.start_oseq[s]])
        o_ids = g.arc_oseq[a_i]
        for o in o_ids[o_ids != 0]:  # oseqs[0] is (); skip wordless arcs
            words.extend(g.oseqs[o])
        words.extend(g.oseqs[g.final_oseq[int(end_state[i])]])
        out.append({
            "tids": g.arc_tid[a_i].tolist(),
            "words": words,
            "score": float(score[i]),
            "arcs": a_i.tolist(),
        })
    return out


def backtrace_batched(padded: dict, graphs: list[DenseGraph], alpha_end: np.ndarray,
                      bps: np.ndarray, num_frames: np.ndarray):
    """Backtrace for per-utterance graphs (training alignment)."""
    out = []
    arc_src = padded["arc_src"]
    for i, g in enumerate(graphs):
        t_end = int(num_frames[i])
        total = alpha_end[i, : g.num_states] + g.final_score
        if np.max(total) <= NEG_INF / 2:
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        s = int(np.argmax(total))
        score = float(total[s])
        final_words = g.oseqs[g.final_oseq[s]]
        arcs = []
        ok = True
        for t in range(t_end - 1, -1, -1):
            a = int(bps[t, i, s])
            if a < 0:
                ok = False
                break
            arcs.append(a)
            s = int(arc_src[i, a])
        if not ok:
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        arcs.reverse()
        words: list[int] = list(g.oseqs[g.start_oseq[s]])
        for a in arcs:
            words.extend(g.oseqs[g.arc_oseq[a]])
        words.extend(final_words)
        out.append({
            "tids": [int(g.arc_tid[a]) for a in arcs],
            "words": words,
            "score": score,
            "arcs": arcs,
        })
    return out
