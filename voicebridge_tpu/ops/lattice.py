"""Device-side lattice generation: windowed Viterbi forward-backward.

Counterpart of the lattice-generating decoder ``LatticeFasterDecoder``
(``decoder/lattice-faster-decoder.cc``) + its pruning
(``PruneActiveTokens``, lattice-beam semantics): an arc instance (frame t,
graph arc a) survives into the lattice iff the best COMPLETE path through it
scores within ``lattice_beam`` of the global best path — exactly the
invariant Kaldi's forward-link pruning converges to.  On the device this is
not token passing but two arc-parallel max-plus scans:

* forward:  alpha[t][s]  (beam/max-active pruned, identical to the decoder)
* backward: beta[t][s] = max over arcs s--a-->d of  w(a) + acwt*ll[t, pdf(a)]
            + beta[t+1][d],  with beta[nf] = final
* gamma[t][a] = alpha[t][src] + w + acwt*ll + beta[t+1][dst]
  survive iff gamma >= best_total - lattice_beam.

Memory is bounded by the same window strategy as ``viterbi_decode_windowed``:
phase 1 stores one alpha snapshot per window; phase 2 walks windows high→low,
recomputing in-window alphas, carrying beta, and emitting a packed survivor
bitmask per frame.  Only the [W, B, A/8] bitmasks are fetched to the host.

Scores are max-plus (higher = better); the host lattice stores graph and
acoustic costs separately (Kaldi ``LatticeWeight`` convention).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .viterbi import (DenseGraph, NEG_INF, ReductionPlan, _prune, _relax_tree,
                      build_reduction_plan)


def build_src_plan(graph: DenseGraph, k: int = 8) -> tuple:
    """Reduction plan grouping arcs by SOURCE state (for the backward pass)."""
    return build_reduction_plan(graph.arc_src, graph.num_states, k).levels


@functools.partial(jax.jit, static_argnames=("num_states", "max_active", "window"))
def _window_fb(arc_src, arc_dst, levels, rev_levels, arc_pdf, arc_score,
               alpha_snap, beta_carry, ll_win, t0, num_frames, final_score,
               total_best, acoustic_scale, beam, lattice_beam,
               num_states: int, max_active: int, window: int):
    """One reverse-order window of the lattice forward-backward.

    alpha_snap [B, S]: forward scores at frame t0 (window start).
    beta_carry [B, S]: beta at frame t0+window (from the previously processed
    higher window; arbitrary for utterances whose nf <= t0+window — patched
    via the ``t+1 == nf`` select).
    ll_win [B, W, P]; returns (packed survivor mask [W, B, ceil(A/8)] uint8,
    beta at t0 [B, S]).
    """
    b = ll_win.shape[0]

    # in-window alphas, alpha[t] = scores BEFORE consuming frame t
    def fwd(carry, inp):
        alpha, t = carry
        ll_t = inp
        am = ll_t[:, arc_pdf] * acoustic_scale
        score = alpha[:, arc_src] + arc_score[None, :] + am
        na, _ = _relax_tree(score, levels)
        na = _prune(na, beam, max_active)
        active = (t < num_frames)[:, None]
        na = jnp.where(active, na, alpha)
        return (na, t + 1), alpha

    (_, _), alphas = jax.lax.scan(fwd, (alpha_snap, t0),
                                  jnp.swapaxes(ll_win, 0, 1))
    # alphas [W, B, S] = alpha at times t0..t0+W-1

    thresh = (total_best - lattice_beam)[:, None]  # [B, 1]

    def bwd(beta_next, inp):
        alpha_t, ll_t, t = inp
        # effective beta at t+1: final scores where the utterance ends here
        # (final_score is per-utterance [B, S]: zeros when no final state was
        # reachable — Kaldi's partial-path fallback)
        beta_eff = jnp.where((t + 1 == num_frames)[:, None],
                             final_score, beta_next)
        am = ll_t[:, arc_pdf] * acoustic_scale  # [B, A]
        tail = am + arc_score[None, :] + beta_eff[:, arc_dst]  # [B, A]
        gamma = alpha_t[:, arc_src] + tail
        keep = (gamma >= thresh) & (t < num_frames)[:, None]
        beta_t, _ = _relax_tree(tail, rev_levels)
        beta_t = jnp.where((t < num_frames)[:, None], beta_t, beta_next)
        return beta_t, jnp.packbits(keep, axis=-1)

    ts = t0 + jnp.arange(window, dtype=jnp.int32)
    beta_lo, masks = jax.lax.scan(
        bwd, beta_carry,
        (alphas[::-1], jnp.swapaxes(ll_win, 0, 1)[::-1], ts[::-1]))
    return masks[::-1], beta_lo


def lattice_forward_backward(graph: DenseGraph, levels: tuple, rev_levels: tuple,
                             loglikes, num_frames, acoustic_scale: float,
                             beam: float, lattice_beam: float,
                             max_active: int = 0, window: int = 64):
    """Full windowed lattice FB over a shared graph.

    loglikes: [B, T, P] device array.  Returns (survivor mask [T, B, A] bool
    (numpy), total_best [B] numpy, alpha_end [B, S] numpy).
    """
    b, t_total, _p = loglikes.shape
    s = graph.num_states
    nw = max(1, -(-t_total // window))
    t_pad = nw * window
    if t_pad != t_total:
        pad = jnp.zeros((b, t_pad - t_total, loglikes.shape[2]), loglikes.dtype)
        loglikes = jnp.concatenate([loglikes, pad], axis=1)

    arc_src = jnp.asarray(graph.arc_src)
    arc_dst = jnp.asarray(graph.arc_dst)
    arc_pdf = jnp.asarray(graph.arc_pdf)
    arc_score = jnp.asarray(graph.arc_score)
    final_j = jnp.asarray(graph.final_score)
    alpha0 = jnp.broadcast_to(jnp.asarray(graph.alpha0)[None, :], (b, s))
    nf = jnp.asarray(num_frames)
    acwt = jnp.float32(acoustic_scale)
    beam_ = jnp.float32(beam)
    lbeam_ = jnp.float32(lattice_beam)

    @jax.jit
    def window_forward(alpha, at_end, ll_win, t0):
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

    # phase 1: snapshots
    alpha = alpha0
    at_end = jnp.where((nf == 0)[:, None], alpha0, jnp.full((b, s), NEG_INF))
    snaps = []
    for w in range(nw):
        snaps.append(alpha)
        ll_win = jax.lax.dynamic_slice_in_dim(loglikes, w * window, window, 1)
        alpha, at_end = window_forward(alpha, at_end, ll_win,
                                       jnp.int32(w * window))

    # best complete score per utterance (prefer final-reachable)
    with_final = jnp.max(at_end + final_j[None, :], axis=1)
    no_final = jnp.max(at_end, axis=1)
    use_final = with_final > NEG_INF / 2
    total_best = jnp.where(use_final, with_final, no_final)
    # when no final state is reachable, accept best partial path (Kaldi's
    # partial-path fallback): every reachable end state final with cost 0
    final_eff = jnp.where(use_final[:, None], final_j[None, :],
                          jnp.zeros((b, s)))

    # phase 2: reverse windows
    mask_chunks = []
    beta = jnp.full((b, s), NEG_INF)
    for w in range(nw - 1, -1, -1):
        lo = w * window
        ll_win = jax.lax.dynamic_slice_in_dim(loglikes, lo, window, 1)
        masks, beta = _window_fb(
            arc_src, arc_dst, levels, rev_levels, arc_pdf, arc_score,
            snaps[w], beta, ll_win, jnp.int32(lo), nf, final_eff,
            total_best, acwt, beam_, lbeam_, s, max_active, window)
        mask_chunks.append(masks)

    packed = np.asarray(jnp.concatenate(mask_chunks[::-1], axis=0))
    a = graph.num_arcs
    mask = np.unpackbits(packed, axis=-1, count=a).astype(bool)[:t_total]
    return mask, np.asarray(total_best), np.asarray(at_end), np.asarray(use_final)


# ---------------------------------------------------------------------------
# Batch-minor in-degree-row lattice forward-backward (production path)
# ---------------------------------------------------------------------------
# The windowed FB above gathers per (utterance, arc) from [B, A] arrays.
# This section re-expresses the FB on the decode core's batch-minor EmitPlan
# rows (ops/decode_core.py module docstring):
#   * forward  = emit_value_step over the FORWARD plan (rows by (dst, pdf));
#   * backward = emit_value_step over the plan of the TRANSPOSED graph
#     (rows by (src, pdf)) — the same kernel relaxes beta;
#   * survivor masks are computed on the forward plan's rows, where the
#     row's destination state and pdf are constants, and emitted as packed
#     row-major bits ([T, B, ceil(R*D/8)] uint8) — ONE device->host fetch.
#
# The two plans renumber states INDEPENDENTLY (each sorts its own row-count
# buckets; decode_core EmitPlan docstring): alpha lives in fwd-plan space,
# beta in bwd-plan space.  ``row_dst`` therefore maps each FORWARD row's
# destination into BWD-plan space so the gamma test can gather beta rows
# directly, and final scores are permuted per consumer.

from .decode_core import (EmitPlan, EmitPlanDev, build_emit_plan,
                          emit_value_step, plan_to_device, reduce_rows)


def build_lattice_plans(graph: DenseGraph, d: int | None = None,
                        fwd_plan: EmitPlan | None = None):
    """(fwd_plan, fwd_dev, bwd_plan, bwd_dev, row_dst [R]) for the row-based
    FB.  Pass an existing forward ``EmitPlan`` (the decoder's) to reuse it.
    ``row_dst[r]`` is the BWD-PLAN state id of forward row r's destination
    (the pad row maps to the pad state)."""
    if fwd_plan is None:
        fwd_plan = build_emit_plan(graph, d=d)
    gt = DenseGraph(
        num_states=graph.num_states, arc_src=graph.arc_dst,
        arc_dst=graph.arc_src, arc_tid=graph.arc_tid, arc_pdf=graph.arc_pdf,
        arc_score=graph.arc_score, arc_oseq=graph.arc_oseq,
        alpha0=graph.alpha0, start_oseq=graph.start_oseq,
        final_score=graph.final_score, final_oseq=graph.final_oseq,
        oseqs=graph.oseqs)
    bwd_plan = build_emit_plan(gt, d=d)
    s_pad = graph.num_states + 1
    # forward row -> graph dst -> bwd-plan state
    dst_plan = np.repeat(np.arange(s_pad, dtype=np.int64),
                         np.diff(fwd_plan.row_start))
    dst_graph = fwd_plan.sperm[dst_plan]
    bwd_iperm = np.empty(s_pad, np.int64)
    bwd_iperm[bwd_plan.sperm] = np.arange(s_pad)
    row_dst = bwd_iperm[dst_graph].astype(np.int32)
    return (fwd_plan, plan_to_device(fwd_plan), bwd_plan,
            plan_to_device(bwd_plan), row_dst)


@functools.partial(jax.jit, static_argnames=("rspec",))
def _fb_win_forward(fwd_dev: EmitPlanDev, alpha, at_end, ll_win, t0,
                    num_frames, acwt, rspec: tuple):
    """One forward window (one medium program per window, so only one
    window's state is live).  ll_win [W, P, B]; returns (alpha, at_end)
    after the window."""

    def frame(c, ll_t):
        a, e, t = c
        na = emit_value_step(a, ll_t, fwd_dev, acwt, rspec)
        a = jnp.where((t < num_frames)[None, :], na, a)
        e = jnp.where((t + 1 == num_frames)[None, :], a, e)
        return (a, e, t + 1), None

    (a, e, _), _ = jax.lax.scan(frame, (alpha, at_end, t0), ll_win)
    return a, e


def _sparsify_words(flat, budget: int):
    """Bounded-budget nonzero-WORD compaction: flat [M, B] uint8 (mask
    bytes in position order) -> (idx [K, B] int32 word positions of the
    first K nonzero 4-byte words (-1 pad), val [K, B] int32 big-endian
    packed words, count [B] total nonzero words).

    Survivor masks are extremely sparse on real HCLGs (~0.05% of bytes
    nonzero at lattice_beam 8 with peaked acoustics), but a dense
    [W, nbytes, B] fetch moves the zeros too (854 MB per 32-utt chunk at
    T=500 on the 90k-state graph).  Compaction of the position-ordered mask
    is a 2-operand ``lax.sort`` with key "descending position where
    nonzero" and the packed word as the carried value — no per-element
    gathers anywhere; sorting 4-byte words sorts 4x fewer elements than
    bytes, and the sort cost does not depend on K.
    Overflow (count > K) is detectable by the caller; clipped words drop
    the *latest-frame* survivors in the window (positions are scanned in
    frame order)."""
    m, b = flat.shape
    if m % 4:
        flat = jnp.concatenate(
            [flat, jnp.zeros((4 - m % 4, b), flat.dtype)], axis=0)
    mw = flat.shape[0] // 4
    w8 = flat.reshape(mw, 4, b).astype(jnp.int32)
    words = (w8[:, 0] << 24) | (w8[:, 1] << 16) | (w8[:, 2] << 8) | w8[:, 3]
    nz = words != 0
    count = jnp.sum(nz.astype(jnp.int32), axis=0)
    kk = min(budget, mw)
    g = 32  # words per block in the hierarchical path
    kb = max(kk // g, 1)

    def flat_sort(words):
        key = jnp.where(words != 0,
                        mw - jnp.arange(mw, dtype=jnp.int32)[:, None], 0)
        sk, sv = jax.lax.sort([key.T, words.T], dimension=-1, num_keys=1)
        topk = sk[:, mw - kk:][:, ::-1]  # desc key = ascending position
        topw = sv[:, mw - kk:][:, ::-1]
        idx = jnp.where(topk > 0, mw - topk, -1).T
        val = jnp.where(topk > 0, topw, 0).T
        return idx, val

    if mw <= max(kb * g, 4096):
        # graph too small for the hierarchy to pay for itself
        idx, val = flat_sort(words)
        return idx, val, count, jnp.packbits(nz, axis=0)

    # Hierarchical two-level compaction: a flat sort over all M words
    # (M ~= 417k words/window on the 90k-state HCLG) does far more work
    # than the few nonzero words of a realistic decode need.  Level 1 sorts
    # only the
    # M/g per-BLOCK any-nonzero flags to find the first kb active blocks;
    # level 2 gathers those blocks' words ([kb, B, g] — each slice g
    # contiguous int32, a row-shaped gather, not an element gather) and
    # runs the exact word-level sort on that g*kb-word subset (~6x
    # smaller).  Worst-case lattice densities SPREAD nonzero words over
    # more blocks than kb, so when any utterance's nonzero
    # blocks exceed kb the whole window falls back to the exact flat sort
    # via lax.cond — both branches compile once, only one executes.
    mb = -(-mw // g)
    if mb * g != mw:
        words = jnp.concatenate(
            [words, jnp.zeros((mb * g - mw, b), words.dtype)], axis=0)
    wblk = jnp.swapaxes(words.reshape(mb, g, b), 1, 2)  # [mb, B, g]
    bnz = jnp.any(wblk != 0, axis=2)  # [mb, B]
    blk_cnt = jnp.sum(bnz.astype(jnp.int32), axis=0)  # [B]
    mwp = mb * g

    def hier(wblk, bnz):
        bkey = jnp.where(bnz,
                         mb - jnp.arange(mb, dtype=jnp.int32)[:, None], 0)
        bval = jnp.broadcast_to(
            jnp.arange(mb, dtype=jnp.int32)[:, None], (mb, b))
        sk1, si1 = jax.lax.sort([bkey.T, bval.T], dimension=-1, num_keys=1)
        top_bk = sk1[:, mb - kb:][:, ::-1]  # [B, kb] desc key = asc pos
        top_bi = si1[:, mb - kb:][:, ::-1]
        # pad-block sentinel mb: gathered words all zero, never selected
        blk_idx = jnp.where(top_bk > 0, top_bi, mb).T  # [kb, B]
        wblk_s = jnp.concatenate(
            [wblk, jnp.zeros((1, b, g), wblk.dtype)], axis=0)  # [mb+1,B,g]
        gathered = jnp.take_along_axis(
            wblk_s, blk_idx[:, :, None].astype(jnp.int32), axis=0)
        pos = (blk_idx[:, :, None] * g
               + jnp.arange(g, dtype=jnp.int32)[None, None, :])  # [kb,B,g]
        wsub = jnp.swapaxes(gathered, 1, 2).reshape(kb * g, b)
        psub = jnp.swapaxes(pos, 1, 2).reshape(kb * g, b)
        key2 = jnp.where(wsub != 0, mwp - psub, 0)
        k2 = min(kk, kb * g)
        sk2, sv2 = jax.lax.sort([key2.T, wsub.T], dimension=-1, num_keys=1)
        topk = sk2[:, kb * g - k2:][:, ::-1]
        topw = sv2[:, kb * g - k2:][:, ::-1]
        idx = jnp.where(topk > 0, mwp - topk, -1).T
        val = jnp.where(topk > 0, topw, 0).T
        if k2 < kk:  # align output shape with the flat branch
            idx = jnp.concatenate(
                [idx, jnp.full((kk - k2, b), -1, idx.dtype)], axis=0)
            val = jnp.concatenate(
                [val, jnp.zeros((kk - k2, b), val.dtype)], axis=0)
        return idx, val

    idx, val = jax.lax.cond(
        jnp.any(blk_cnt > kb),
        lambda ops: flat_sort(ops[0][:mw]),
        lambda ops: hier(ops[1], ops[2]),
        (words, wblk, bnz))
    return idx, val, count, jnp.packbits(nz, axis=0)


@functools.partial(jax.jit,
                   static_argnames=("fwd_rspec", "bwd_rspec", "mask_budget"))
def _fb_win_backward(fwd_dev: EmitPlanDev, bwd_dev: EmitPlanDev, row_dst,
                     snap, beta, ll_win, t0, num_frames, final_eff, thresh,
                     acwt, fwd_rspec: tuple, bwd_rspec: tuple,
                     mask_budget: int | None = None):
    """One reverse window: pass 1 relaxes beta (descending), storing the
    per-frame ``beta_eff`` at t+1; pass 2 recomputes alphas ascending from
    the ``snap`` (alpha at t0) with the survivor test FUSED into the same
    row gather — gamma[r, d] = g[r, d] + am[r] + beta_next[dst(r)] reuses the
    alpha gather the relaxation already does (one fewer full-gather pass
    than the naive alpha-slab formulation).

    ``snap``/alpha live in FWD-plan space, ``beta``/``final_eff`` in
    BWD-plan space; ``row_dst`` maps forward rows into bwd space.
    Returns (beta at t0, bits [W, ceil(R*D/8), B] in forward frame order)."""
    w = ll_win.shape[0]
    b = snap.shape[1]
    r, d_w = fwd_dev.row_w.shape
    ts = t0 + jnp.arange(w, dtype=jnp.int32)

    def bwd_frame(bt, inp):
        ll_t, t = inp
        beta_eff = jnp.where((t + 1 == num_frames)[None, :], final_eff, bt)
        nb = emit_value_step(beta_eff, ll_t, bwd_dev, acwt, bwd_rspec)
        nb = jnp.where((t < num_frames)[None, :], nb, bt)
        return nb, beta_eff  # beta above frame t (used by gamma at t)

    beta, beta_slab_rev = jax.lax.scan(
        bwd_frame, beta, (ll_win[::-1], ts[::-1]))
    beta_slab = beta_slab_rev[::-1]  # [W, S+1, B]

    def fwd_frame(a, inp):
        ll_t, beta_next, t = inp
        am = jnp.take(ll_t, fwd_dev.row_pdf, axis=0) * acwt  # [R, B]
        g = jnp.take(a, fwd_dev.row_src, axis=0).reshape(r, d_w, b) \
            + fwd_dev.row_w[:, :, None]
        na = reduce_rows(jnp.max(g, axis=1) + am, fwd_rspec, b)
        na = jnp.where((t < num_frames)[None, :], na, a)
        tail = am + jnp.take(beta_next, row_dst, axis=0)  # [R, B]
        keep = (g + tail[:, None, :] >= thresh[None, None, :]) & \
            (t < num_frames)[None, None, :]
        # pack along the position axis ([R*D, B] -> [nbytes, B]): no
        # lane-major transpose of a 400k-wide array per frame
        bits = jnp.packbits(keep.reshape(r * d_w, b), axis=0)
        return na, bits

    _, bits = jax.lax.scan(fwd_frame, snap, (ll_win, beta_slab, ts))
    if mask_budget is None:
        return beta, bits
    nbytes = bits.shape[1]
    return beta, _sparsify_words(bits.reshape(w * nbytes, b), mask_budget)


def lattice_forward_backward_rows(graph: DenseGraph, fwd_plan: EmitPlan,
                                  fwd_dev: EmitPlanDev, bwd_plan: EmitPlan,
                                  bwd_dev: EmitPlanDev,
                                  row_dst: np.ndarray, loglikes, num_frames,
                                  acoustic_scale: float, lattice_beam: float,
                                  window: int = 64,
                                  mask_budget: int | None = None):
    """Row-based windowed lattice FB (exact forward — no beam pruning: the
    dense relaxation does the same work either way, so pruning could only
    lose paths).  loglikes [B, T, P] device array.  Windows dispatch one
    medium program each from Python.

    Returns (packed row-major masks [T, nbytes, B] np.uint8, total_best [B],
    alpha_at_end [S+1, B] np, use_final [B]).

    With ``mask_budget`` set (nonzero bytes per window per utterance), the
    first element is instead a SPARSE representation: a list of
    ``(t0, idx [K, B], val [K, B], count [B])`` per window in ascending-t0
    order, where idx are 4-byte WORD positions over the flat
    ``t_local * nbytes + byte`` mask space (-1 pad) and val the packed
    big-endian mask words.  The dense [T, nbytes, B] fetch moves ~99.95% zeros on real
    HCLGs; the sparse fetch is ~100-300x smaller (see _sparsify_words)."""
    b, t_total, _p = loglikes.shape
    nw = max(1, -(-t_total // window))
    t_pad = nw * window
    if t_pad != t_total:
        loglikes = jnp.concatenate(
            [loglikes, jnp.zeros((b, t_pad - t_total, loglikes.shape[2]),
                                 loglikes.dtype)], axis=1)
    ll = jnp.transpose(loglikes, (1, 2, 0))  # [T, P, B]
    nf = jnp.asarray(num_frames)
    acwt = jnp.float32(acoustic_scale)
    s1 = fwd_plan.num_states + 1
    # alpha / at_end live in FWD-plan space, beta / final_eff in BWD-plan
    # space (each plan renumbers states for its gather-free reduction)
    alpha0_col = jnp.concatenate(
        [jnp.asarray(graph.alpha0[fwd_plan.sperm[:-1]]),
         jnp.full((1,), NEG_INF, jnp.float32)])
    final_col = jnp.concatenate(
        [jnp.asarray(graph.final_score[fwd_plan.sperm[:-1]]),
         jnp.full((1,), NEG_INF, jnp.float32)])
    final_col_bwd = jnp.concatenate(
        [jnp.asarray(graph.final_score[bwd_plan.sperm[:-1]]),
         jnp.full((1,), NEG_INF, jnp.float32)])

    # phase 1: per-window forward, keeping one alpha snapshot per window
    alpha = jnp.broadcast_to(alpha0_col[:, None], (s1, b))
    at_end = jnp.where((nf == 0)[None, :], alpha,
                       jnp.full((s1, b), NEG_INF))
    snaps = []
    for w in range(nw):
        snaps.append(alpha)
        alpha, at_end = _fb_win_forward(
            fwd_dev, alpha, at_end, ll[w * window:(w + 1) * window],
            jnp.int32(w * window), nf, acwt, fwd_plan.rspec)

    with_final = jnp.max(at_end + final_col[:, None], axis=0)
    no_final = jnp.max(at_end, axis=0)
    use_final = with_final > NEG_INF / 2
    total_best = jnp.where(use_final, with_final, no_final)
    # partial-path fallback: when no final state is reachable, treat every
    # state as final with cost 0 (Kaldi's DecodeUtteranceLatticeFaster)
    final_eff = jnp.where(use_final[None, :], final_col_bwd[:, None],
                          jnp.zeros((s1, b)))
    thresh = total_best - jnp.float32(lattice_beam)

    # phase 2: reverse windows.  Each consumed snapshot is dropped as its
    # backward window is dispatched.
    #
    # Sparse-mode fetch is COUNT-FIRST and fully deferred: the budget K
    # covers the densest windows, but typical windows carry far fewer
    # nonzero words, and a host read inside the dispatch loop would stall
    # the dispatch pipeline.  So the loop only DISPATCHES: every window's
    # [B] counts start copying immediately; after the last window the
    # landed counts size one exact pow2-bucketed slice [hi, B] per window,
    # all slice copies go into flight together, and one drain reads them.
    # Each pow2 bucket compiles at most one slice program; hi >= max_count
    # keeps every survivor word, and genuine over-K overflow still reports
    # (hi caps at K, caller refetches dense).  The full [K, B] idx/val
    # buffers stay device-resident until sliced (nw * 2 * 4 * K * B bytes
    # — counted in steps/decode.py's chunk sizing).
    row_dst_j = jnp.asarray(row_dst)

    class _Fetch:
        __slots__ = ("t0", "idx", "val", "count", "nzb", "c_np", "idx_s",
                     "val_s")

        def __init__(self, t0, out):
            self.t0 = t0
            if mask_budget is None:
                self.idx = out
                out.copy_to_host_async()
                return
            self.idx, self.val, self.count, self.nzb = out
            self.count.copy_to_host_async()
            self.c_np = None

        @staticmethod
        def _bucket(top: int, cap: int) -> int:
            """Fetch-length bucket: the smallest of {2^k, 3*2^(k-1)} >= top
            (compiles at most 2*log2(K) distinct slice programs; plain pow2
            wasted 39% when worst-case counts land just above a power —
            23492 -> 32768 vs 24576)."""
            p = 1 << max(0, (max(top, 1) - 1).bit_length() - 1)
            for h in (p, 3 * p // 2, 2 * p, 3 * p):
                if h >= top:
                    return min(max(h, 64), cap)
            return cap

        def slice_to_counts(self):
            """Counts have landed: start the exact payload copies, free the
            full [K, B] buffers.  Called only after the dispatch loop.

            Two fetch encodings, chosen per window by total bytes: sparse
            windows move (idx, val) slices; DENSE windows (count >
            mask-words/32, i.e. idx bytes would exceed the bitmap) move
            the packed nonzero-word BITMAP + val slice instead and
            reconstruct positions on the host — at worst-case lattice
            density this nearly halves the dominant fetch (round 5)."""
            if mask_budget is None or self.c_np is not None:
                return
            c = np.asarray(self.count)
            self.c_np = c
            top = int(c.max()) if c.size else 0
            hi = self._bucket(top, self.idx.shape[0])
            self.val_s = self.val[:hi]
            self.val_s.copy_to_host_async()
            if top * 4 > self.nzb.shape[0]:
                self.idx_s = self.nzb  # bitmap mode
            else:
                self.idx_s = self.idx[:hi]
            self.idx_s.copy_to_host_async()
            self.idx = self.val = self.nzb = None

        def finish(self):
            if mask_budget is None:
                return self.t0, np.asarray(self.idx)
            self.slice_to_counts()
            idx_np = np.asarray(self.idx_s)
            val_np = np.asarray(self.val_s)
            if idx_np.dtype == np.uint8:
                # bitmap mode: positions = set bits, already in ascending
                # order — rebuild the rectangular idx the consumers expect
                bits = np.unpackbits(idx_np, axis=0)  # [mw8*8, B]
                k = val_np.shape[0]
                idx_r = np.full((k, bits.shape[1]), -1, np.int32)
                for bi in range(bits.shape[1]):
                    pos = np.flatnonzero(bits[:, bi])
                    n = min(len(pos), k)
                    idx_r[:n, bi] = pos[:n]
                idx_np = idx_r
            return self.t0, (idx_np, val_np, self.c_np)

    beta = jnp.full((s1, b), NEG_INF)
    mask_np = []
    pending: list[_Fetch] = []
    for w in range(nw - 1, -1, -1):
        beta, out = _fb_win_backward(
            fwd_dev, bwd_dev, row_dst_j, snaps[w], beta,
            ll[w * window:(w + 1) * window], jnp.int32(w * window), nf,
            final_eff, thresh, acwt, fwd_plan.rspec, bwd_plan.rspec,
            mask_budget)
        snaps[w] = None  # free the snapshot buffer
        pending.append(_Fetch(w * window, out))
        if mask_budget is None and len(pending) >= 3:
            # dense masks are big ([W, nbytes, B]); consume with lag so at
            # most two stay device-resident
            mask_np.append(pending.pop(0).finish())
    for f in pending:
        f.slice_to_counts()
    mask_np.extend(f.finish() for f in pending)
    mask_np = mask_np[::-1]  # ascending t0
    if mask_budget is None:
        masks = np.concatenate([m for _t0, m in mask_np], axis=0)
        return (masks[:t_total], np.asarray(total_best),
                np.asarray(at_end), np.asarray(use_final))
    sparse = [(t0, idx, val, count) for t0, (idx, val, count) in mask_np]
    return (sparse, np.asarray(total_best),
            np.asarray(at_end), np.asarray(use_final))
