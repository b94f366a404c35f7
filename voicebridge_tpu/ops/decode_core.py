"""Viterbi decode core: batch-minor state scores + in-degree rows.

Replaces the token-passing hot loop of the reference decoder
(``LatticeFasterDecoder::Decode``/``ProcessEmitting``,
``kaldi-master/src/decoder/lattice-faster-decoder.cc:72-89``) with a dense
arc-parallel relaxation over every state, every frame:

* **Batch-minor layout** ``alpha[S, B]``: every gather of a source state's
  scores is a *row* gather (``B`` contiguous floats) instead of an element
  gather per (utterance, arc).
* **In-degree rows**: incoming arcs of each state are grouped by
  ``(dst, pdf)`` into rows of width ``D`` (adapted to the run-length
  distribution).  A row is pdf-pure, so the acoustic score is ONE gathered
  value per row instead of one per arc.  Real HCLG graphs built with
  reorder-style self-loops (``fst/hmm_graph.py add_self_loops``) have the
  "all arcs entering a state share one pdf" property, so rows pack densely.
* **Bucketed, gather-free row->state reduction**: states are RENUMBERED so
  that states with the same (bucketed) row count are contiguous, every
  state owns exactly ``bucket`` row slots (dead rows pad), and the
  per-state max is a pure ``reshape(n, c, B).max(axis=1)`` per bucket —
  zero gathers.  Bucket sizes grow by ~1.5x, bounding dead-row overhead at
  ~33% of rows (real HCLGs: <10%, since ~85% of states have exactly one row
  and LM-backoff hubs are few).
* **One fused scan** over all frames per dispatch (no per-window Python
  dispatch).  Backpointers are ONE integer per state per frame: the winner
  code ``local_row * D + slot`` relative to the state's first row (uint8
  when ``max_bucket * D <= 256``, int16 otherwise).  Winner codes come from
  equality-masked max inside each bucket, not ``take_along_axis``.
* Backtrace runs on device as a tiny [T] scan; one host fetch at the end.

Scores are max-plus (higher is better), like ``ops/viterbi.py``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .viterbi import NEG_INF, DenseGraph

__all__ = [
    "EmitPlan", "build_emit_plan", "plan_to_device", "viterbi_scan",
    "decode_best_path", "reduce_rows",
]


class EmitPlan(NamedTuple):
    """Host-built decode plan for a shared graph (see module docstring).

    States are renumbered into PLAN space: ``sperm[i]`` is the graph state
    of plan state ``i`` (the pad state ``S`` maps to itself).  All row
    arrays, ``row_start``, backtrace states and alpha tables live in plan
    space; ``row_arc`` stores ORIGINAL arc ids so host-side lattice/path
    assembly never needs the permutation.

    ``rspec`` is a static tuple of ``(bucket, n_states)`` runs in plan-state
    order (last entry is the pad state's ``(1, 1)``): plan state block
    ``i0:i0+n`` owns rows ``r0 + k*bucket : r0 + (k+1)*bucket``, so the
    row->state reduction is one reshape-max per run.
    """

    row_src: np.ndarray  # [R, D] int32 source PLAN state per slot (pad: S)
    row_w: np.ndarray  # [R, D] f32 graph score (pad: NEG_INF)
    row_pdf: np.ndarray  # [R] int32 pdf shared by the row's arcs
    row_arc: np.ndarray  # [R, D] int32 original arc id (pad: -1; host only)
    row_start: np.ndarray  # [S+2] int32 CSR of rows per plan state
    sperm: np.ndarray  # [S+1] int32 plan state -> graph state (pad: S)
    rspec: tuple  # ((bucket, n_states), ...) static reduction spec
    num_states: int  # S (real states, excluding the pad state)
    packed: bool  # True: bp code fits uint8 (else int16)

    @property
    def num_rows(self) -> int:
        return len(self.row_pdf)

    @property
    def d(self) -> int:
        return self.row_w.shape[1]


def _chunk_runs(run_starts, run_ends, elems, width):
    """Chunk [start, end) runs over ``elems`` into [n_chunk, width] index rows
    (-1 padded).  Returns (rows, chunk_run)."""
    n = len(elems)
    run_lens = run_ends - run_starts
    cpr = -(-run_lens // width)
    n_chunk = int(cpr.sum())
    if n_chunk == 0:
        return (np.zeros((0, width), np.int64),
                np.zeros(0, np.int64))
    first = np.concatenate([[0], np.cumsum(cpr[:-1])])
    chunk_run = np.repeat(np.arange(len(run_starts)), cpr)
    rank = np.arange(n_chunk) - first[chunk_run]
    start = run_starts[chunk_run] + width * rank
    pos = start[:, None] + np.arange(width)[None, :]
    valid = pos < run_ends[chunk_run][:, None]
    rows = np.where(valid, elems[np.minimum(pos, max(n - 1, 0))], -1)
    return rows, chunk_run


def _runs(key: np.ndarray):
    n = len(key)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    b = np.flatnonzero(np.diff(key)) + 1
    return (np.concatenate([[0], b]).astype(np.int64),
            np.concatenate([b, [n]]).astype(np.int64))


def _buckets_upto(n: int) -> np.ndarray:
    """Bucket ladder 1, 2, 3, 4, 6, 9, 13, ... (~1.5x steps) covering n."""
    out = [1]
    while out[-1] < n:
        out.append(max(out[-1] + 1, out[-1] * 3 // 2))
    return np.asarray(out, np.int64)


def build_emit_plan(graph: DenseGraph, d: Optional[int] = None,
                    k_upper: int = 4) -> EmitPlan:
    """Group ``graph``'s arcs by (dst, pdf) into rows of width ``d``
    (defaulting to a value adapted to the run-length distribution), then
    renumber states by bucketed row count so the row->state reduction is
    gather-free (see EmitPlan docstring).  ``k_upper`` is accepted for
    call-site compatibility with the round-3 tree builder and ignored."""
    del k_upper
    s_real = graph.num_states
    s_pad = s_real + 1
    a = graph.num_arcs
    dst = graph.arc_dst.astype(np.int64)
    pdf = graph.arc_pdf.astype(np.int64)
    num_pdfs = int(pdf.max()) + 1 if a else 1

    order = np.argsort(dst * num_pdfs + pdf, kind="stable")
    dst_s, pdf_s = dst[order], pdf[order]
    run_starts, run_ends = _runs(dst_s * num_pdfs + pdf_s)

    if d is None:
        lens = run_ends - run_starts
        if len(lens) == 0:
            d = 2
        else:
            p90 = float(np.quantile(lens, 0.9))
            d = int(min(8, max(2, 2 ** int(np.ceil(np.log2(max(p90, 2)))))))

    arc_rows, chunk_run = _chunk_runs(run_starts, run_ends, order, d)
    n_chunk = len(chunk_run)
    chunk_dst = (dst_s[run_starts][chunk_run] if n_chunk else
                 np.zeros(0, np.int64))
    chunk_pdf = (pdf_s[run_starts][chunk_run] if n_chunk else
                 np.zeros(0, np.int64))

    # rows per graph state (row-less states get one dead row -> bucket 1)
    nrows = np.zeros(s_real, np.int64)
    np.add.at(nrows, chunk_dst, 1)
    nrows1 = np.maximum(nrows, 1)

    buckets = _buckets_upto(int(nrows1.max()))
    bidx = np.searchsorted(buckets, nrows1)
    cap = buckets[bidx]  # [S_real] row slots owned by each graph state

    # plan numbering: stable sort by bucket; the pad state stays at index S
    sperm = np.argsort(bidx, kind="stable")  # plan i -> graph state
    iperm = np.empty(s_real, np.int64)
    iperm[sperm] = np.arange(s_real)
    cap_plan = cap[sperm]
    row_start_plan = np.concatenate([[0], np.cumsum(cap_plan)])
    r = int(row_start_plan[-1]) + 1  # + one dead row for the pad state
    row_start = np.concatenate([row_start_plan, [r]]).astype(np.int32)

    # static reduction spec: runs of equal bucket in plan order + pad entry
    rs, re = _runs(cap_plan)
    rspec = tuple((int(cap_plan[s]), int(e - s)) for s, e in zip(rs, re))
    rspec = rspec + ((1, 1),)

    # scatter chunk rows into their plan slots (rank-within-state preserved:
    # chunks are (dst, pdf)-sorted, so per-dst chunks are consecutive)
    row_arc = np.full((r, d), -1, np.int64)
    row_pdf_all = np.zeros(r, np.int64)
    if n_chunk:
        first_chunk_of_dst = np.searchsorted(chunk_dst, chunk_dst)
        rank = np.arange(n_chunk) - first_chunk_of_dst
        tgt = row_start_plan[iperm[chunk_dst]] + rank
        row_arc[tgt] = arc_rows
        row_pdf_all[tgt] = chunk_pdf
    row_pdf_all = row_pdf_all.astype(np.int32)
    row_arc = row_arc.astype(np.int32)

    rvalid = row_arc >= 0
    safe = np.maximum(row_arc, 0)
    iperm_pad = np.concatenate([iperm, [s_real]])
    row_src = np.where(rvalid, iperm_pad[graph.arc_src[safe]],
                       s_real).astype(np.int32)
    row_w = np.where(rvalid, graph.arc_score[safe], NEG_INF).astype(np.float32)

    max_bucket = int(cap.max()) if s_real else 1
    # bp code = local_row * d + slot, stored as uint8 when it fits, else int16
    assert max_bucket * d <= 2 ** 15, \
        f"state with {max_bucket} row slots exceeds the int16 bp code range"
    packed = max_bucket * d <= 256

    sperm_full = np.concatenate([sperm, [s_real]]).astype(np.int32)
    return EmitPlan(row_src=row_src, row_w=row_w, row_pdf=row_pdf_all,
                    row_arc=row_arc, row_start=row_start, sperm=sperm_full,
                    rspec=rspec, num_states=s_real, packed=packed)


class EmitPlanDev(NamedTuple):
    """Device half of an EmitPlan (pure array pytree for jit)."""

    row_src: jnp.ndarray  # [R*D] flattened
    row_w: jnp.ndarray  # [R, D]
    row_pdf: jnp.ndarray  # [R]
    row_start: jnp.ndarray  # [S+2]


def plan_to_device(plan: EmitPlan) -> EmitPlanDev:
    return EmitPlanDev(
        row_src=jnp.asarray(plan.row_src.reshape(-1)),
        row_w=jnp.asarray(plan.row_w),
        row_pdf=jnp.asarray(plan.row_pdf),
        row_start=jnp.asarray(plan.row_start),
    )


def _bp_dtype(plan_packed: bool):
    return jnp.uint8 if plan_packed else jnp.int16


def reduce_rows(v, rspec: tuple, b: int):
    """Row values [R, B] -> plan-state values [S+1, B]: one reshape-max per
    bucket run, zero gathers (rows of a state are contiguous and every state
    in a run owns exactly ``bucket`` rows)."""
    parts = []
    lo = 0
    for c, n in rspec:
        blk = jax.lax.slice_in_dim(v, lo, lo + n * c)
        parts.append(blk if c == 1 else blk.reshape(n, c, b).max(axis=1))
        lo += n * c
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)


def emit_value_step(alpha, ll_t, dev: EmitPlanDev, acwt, rspec: tuple):
    """Value-only frame relaxation (no backpointer codes): alpha [S+1, B],
    ll_t [P, B] -> new alpha [S+1, B].  Used by the lattice forward-backward
    where winners are not needed (masks come from the gamma threshold)."""
    r, d_w = dev.row_w.shape
    b = alpha.shape[1]
    am = jnp.take(ll_t, dev.row_pdf, axis=0) * acwt  # [R, B]
    g = jnp.take(alpha, dev.row_src, axis=0).reshape(r, d_w, b) \
        + dev.row_w[:, :, None]
    v = jnp.max(g, axis=1) + am  # [R, B]
    return reduce_rows(v, rspec, b)


def _emit_step(alpha, ll_t, dev: EmitPlanDev, acwt, rspec: tuple,
               packed: bool, beam=None):
    """One frame of relaxation.  alpha [S+1, B], ll_t [P, B].

    Returns (new_alpha [S+1, B], bp [S+1, B]) where bp is the winner code
    ``local_row * D + slot`` relative to the state's first row.
    """
    r, d_w = dev.row_w.shape
    b = alpha.shape[1]
    am = jnp.take(ll_t, dev.row_pdf, axis=0) * acwt  # [R, B]
    g = jnp.take(alpha, dev.row_src, axis=0).reshape(r, d_w, b) \
        + dev.row_w[:, :, None]
    slot = jnp.argmax(g, axis=1).astype(jnp.int32)  # [R, B]
    v = jnp.max(g, axis=1) + am  # [R, B]

    parts_v, parts_c = [], []
    lo = 0
    for c, n in rspec:
        bv = jax.lax.slice_in_dim(v, lo, lo + n * c)
        bs = jax.lax.slice_in_dim(slot, lo, lo + n * c)
        if c == 1:
            parts_v.append(bv)
            parts_c.append(bs)  # local row 0 -> code == slot
        else:
            bvr = bv.reshape(n, c, b)
            codes = (jnp.arange(c, dtype=jnp.int32)[None, :, None] * d_w
                     + bs.reshape(n, c, b))
            vm = bvr.max(axis=1)
            # exact-equality tie-break: any maximal row's code is a valid
            # backpointer; take the largest so (value, code) stay consistent
            cm = jnp.max(jnp.where(bvr == vm[:, None, :], codes, -1), axis=1)
            parts_v.append(vm)
            parts_c.append(cm)
        lo += n * c
    if len(parts_v) == 1:
        v_out, code = parts_v[0], parts_c[0]
    else:
        v_out = jnp.concatenate(parts_v, axis=0)
        code = jnp.concatenate(parts_c, axis=0)
    if beam is not None:
        best = jnp.max(v_out, axis=0, keepdims=True)
        v_out = jnp.where(v_out >= best - beam, v_out, NEG_INF)
    return v_out, code.astype(_bp_dtype(packed))


@functools.partial(jax.jit,
                   static_argnames=("rspec", "packed", "use_beam", "with_bp"))
def viterbi_scan(dev: EmitPlanDev, alpha, alpha_at_end, loglikes, num_frames,
                 t0, acoustic_scale, beam, rspec: tuple, packed: bool,
                 use_beam: bool = False, with_bp: bool = True):
    """Forward Viterbi over a block of frames in ONE compiled scan, resuming
    from (alpha, alpha_at_end) at absolute frame ``t0``.

    loglikes [B, T, P]; num_frames [B].  Returns
    ((alpha [S+1, B], alpha_at_end [S+1, B]), bp) with bp stacked over T.
    ``with_bp=False`` skips the backpointer output entirely (the [T, S+1, B]
    table is never materialized in HBM) — used by the recompute-backtrace
    path's first pass, where only the carried alphas matter."""
    ll = jnp.transpose(loglikes, (1, 2, 0))  # [T, P, B]

    def step(carry, ll_t):
        a, ae, t = carry
        if with_bp:
            new_alpha, bp = _emit_step(
                a, ll_t, dev, acoustic_scale, rspec, packed,
                beam if use_beam else None)
        else:
            new_alpha = emit_value_step(a, ll_t, dev, acoustic_scale, rspec)
            if use_beam:
                best = jnp.max(new_alpha, axis=0, keepdims=True)
                new_alpha = jnp.where(new_alpha >= best - beam, new_alpha,
                                      NEG_INF)
            bp = None
        active = (t < num_frames)[None, :]
        a = jnp.where(active, new_alpha, a)
        at_end = (t + 1 == num_frames)[None, :]
        ae = jnp.where(at_end, a, ae)
        return (a, ae, t + 1), bp

    (a, ae, _), bps = jax.lax.scan(step, (alpha, alpha_at_end, t0), ll)
    return (a, ae), bps


@jax.jit
def backtrace_scan(row_start, row_src_flat, d, bps, end_state, num_frames, t0):
    """Device backtrace over one block's backpointers (frames [t0, t0+W)).

    bps [W, S+1, B] winner codes.  Returns packed global codes
    ``row * D + slot`` [W, B] int32 in forward frame order (-1 where
    inactive) and the carried state [B] at the block start.
    """
    w = bps.shape[0]
    b = bps.shape[2]
    bidx = jnp.arange(b)

    def step(carry, bp_t):
        s, t = carry
        active = t < num_frames
        code = bp_t[s, bidx].astype(jnp.int32)  # [B]
        gcode = row_start[s] * d + code
        src = row_src_flat[gcode]
        gcode_o = jnp.where(active, gcode, -1)
        s = jnp.where(active, src, s)
        return (s, t - 1), gcode_o

    (state, _), codes_rev = jax.lax.scan(
        step, (end_state, t0 + w - 1), bps[::-1])
    return codes_rev[::-1], state


@jax.jit
def select_end_state(alpha_end, final_score):
    """Device-side end-state selection (one tiny fetch instead of the full
    ``[S+1, B]`` alpha table).

    Mirrors the reference's final-state preference
    (``lattice-faster-decoder.cc`` ``FindBestPath``): use final-weighted
    scores when any final state is reachable, else the best non-final score.
    ``final_score`` must be in PLAN space (permute by ``plan.sperm``).
    Returns (end_state [B] plan space, score [B], use_final [B],
    has_path [B]).
    """
    s_real = final_score.shape[0]
    ae = alpha_end[:s_real]
    total = ae + final_score[:, None]
    best_final = jnp.max(total, axis=0)
    best_any = jnp.max(ae, axis=0)
    use_final = best_final > NEG_INF / 2
    has_path = best_any > NEG_INF / 2
    end_state = jnp.where(use_final, jnp.argmax(total, axis=0),
                          jnp.argmax(ae, axis=0)).astype(jnp.int32)
    score = jnp.where(use_final, best_final, best_any)
    return end_state, score, use_final, has_path


# device-resident backpointer budget for decode_best_path: above this the
# recompute-backtrace mode kicks in, bounding the backpointer table to 2 GB
BP_BYTES_BUDGET = 2_000_000_000


def decode_best_path(graph: DenseGraph, plan: EmitPlan, dev: EmitPlanDev,
                     loglikes, num_frames, acoustic_scale: float,
                     beam: Optional[float] = None,
                     chunk: Optional[int] = None,
                     bp_bytes_budget: int = BP_BYTES_BUDGET) -> list[dict]:
    """Full 1-best decode: forward scan + device backtrace + host assembly.

    Same output structure as ``viterbi.backtrace_shared``:
    [{"tids", "words", "score", "arcs"}] per utterance.  ``chunk`` bounds the
    scan length per dispatch (memory control for very long T); chunks carry
    ``alpha`` forward and the backtrace walks them in reverse.

    When the full backpointer table ``T * (S+1) * B`` would exceed
    ``bp_bytes_budget`` (real HCLGs break uint8 bp packing — an LM-backoff
    hub state has thousands of in-degree rows — so bps are int16 and a
    [1000, 90k, 128] table is ~23 GB), the decode switches to
    **checkpoint/recompute**: pass 1 runs the forward WITHOUT materializing
    backpointers, keeping one [S+1, B] alpha snapshot per chunk; pass 2
    walks chunks in reverse, recomputing each chunk's forward WITH
    backpointers from its snapshot and backtracing it immediately, so at
    most one chunk's bp table is ever resident.  2x forward FLOPs for a
    T-fold memory cut — the standard rematerialization trade."""
    b, t_total, _p = loglikes.shape
    nf = jnp.asarray(num_frames, jnp.int32)
    alpha0 = jnp.concatenate(
        [jnp.asarray(graph.alpha0[plan.sperm[:-1]]),
         jnp.full((1,), NEG_INF, jnp.float32)])
    acwt = jnp.float32(acoustic_scale)
    use_beam = beam is not None
    beam_j = jnp.float32(beam if use_beam else 0.0)
    s1 = plan.num_states + 1
    rspec = plan.rspec

    alpha = jnp.broadcast_to(alpha0[:, None], (s1, b))
    alpha_end = jnp.where((nf == 0)[None, :], alpha,
                          jnp.full((s1, b), NEG_INF))
    bp_width = 1 if plan.packed else 2
    recompute = t_total * s1 * b * bp_width > bp_bytes_budget
    step_t = t_total if chunk is None else min(chunk, t_total)
    if recompute and chunk is None:
        # a single chunk would make pass 2 materialize the full [T, S+1, B]
        # table anyway (no memory cut for 2x forward FLOPs); derive a chunk
        # that keeps one resident bp block within the budget
        step_t = max(16, min(t_total, bp_bytes_budget // (s1 * b * bp_width)))
    # pad T to a multiple of the chunk so every dispatch reuses ONE compiled
    # scan (a short remainder chunk would recompile per distinct T % chunk);
    # padded frames are masked by num_frames inside the scan
    t_pad = -(-t_total // step_t) * step_t
    if t_pad != t_total:
        loglikes = jnp.concatenate(
            [loglikes, jnp.zeros((b, t_pad - t_total, loglikes.shape[2]),
                                 loglikes.dtype)], axis=1)

    chunks = []  # (lo, bps) in keep mode; (lo, alpha_snap) in recompute mode
    for lo in range(0, t_pad, step_t):
        if recompute:
            # snapshot only alpha: alpha_at_end is a pure accumulator (it
            # never feeds back into the recursion or the backpointers), so
            # pass 2 can run with a dummy — halves checkpoint residency
            chunks.append((lo, alpha))
            (alpha, alpha_end), _ = viterbi_scan(
                dev, alpha, alpha_end, loglikes[:, lo:lo + step_t], nf,
                jnp.int32(lo), acwt, beam_j, rspec, plan.packed, use_beam,
                with_bp=False)
        else:
            (alpha, alpha_end), bps = viterbi_scan(
                dev, alpha, alpha_end, loglikes[:, lo:lo + step_t], nf,
                jnp.int32(lo), acwt, beam_j, rspec, plan.packed, use_beam)
            chunks.append((lo, bps))

    # choose end state per utterance on device; fetch only [B]-sized arrays
    nf_np = np.asarray(num_frames)
    end_dev, score_dev, use_final_dev, has_path_dev = select_end_state(
        alpha_end, jnp.asarray(graph.final_score[plan.sperm[:-1]]))
    end_state = np.asarray(end_dev)  # plan space
    scores = np.asarray(score_dev).astype(np.float64)
    use_final = np.asarray(use_final_dev)
    has_path = np.asarray(has_path_dev)
    end_orig = plan.sperm[end_state]  # graph space, for oseq lookups

    # backtrace chunks in reverse, carrying the state; ONE [T, B] host fetch
    # of packed codes row*D+slot
    d = jnp.int32(plan.d)
    state = end_dev
    code_parts = []
    for item in reversed(chunks):
        if recompute:
            lo, a_snap = item
            _, bps = viterbi_scan(
                dev, a_snap, a_snap, loglikes[:, lo:lo + step_t], nf,
                jnp.int32(lo), acwt, beam_j, rspec, plan.packed, use_beam)
        else:
            lo, bps = item
        codes_c, state = backtrace_scan(
            dev.row_start, dev.row_src, d, bps, state, nf, jnp.int32(lo))
        del bps  # recompute mode: at most one chunk's bp table resident
        # fetch this chunk's codes now so the buffer chain doesn't pin the
        # device queue; [W, B] int32 is tiny
        code_parts.append(np.asarray(codes_c))
    codes_all = np.concatenate(code_parts[::-1], axis=0)

    out = []
    for i in range(b):
        n = int(nf_np[i])
        if not has_path[i]:
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        codes_i = codes_all[:n, i]
        rows_i = codes_i // plan.d
        slots_i = codes_i % plan.d
        arcs = plan.row_arc[rows_i, slots_i] if n else np.zeros(0, np.int64)
        if n and (arcs < 0).any():
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        start_s = int(graph.arc_src[arcs[0]]) if n else int(end_orig[i])
        words = list(graph.oseqs[graph.start_oseq[start_s]])
        for a in arcs:
            words.extend(graph.oseqs[graph.arc_oseq[a]])
        if use_final[i]:
            words.extend(graph.oseqs[graph.final_oseq[end_orig[i]]])
        out.append({
            "tids": [int(t) for t in graph.arc_tid[arcs]],
            "words": words,
            "score": float(scores[i]),
            "arcs": [int(a) for a in arcs],
        })
    return out
