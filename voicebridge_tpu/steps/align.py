"""Alignment engine: batched Viterbi alignment over training graphs.

Counterparts: ``gmm-align-compiled`` / ``align-equal-compiled`` and the
per-shard thread fan-out in the reference's training steps
(``train_gmm_mono.cpp:398-459,577-612``).  Here the "fan-out" is a single
batched device call: all utterances advance frame-synchronously through their
own graphs ([B, S] state scores, SURVEY.md §2.6 P1).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..fst.core import Fst
from ..models.transition import TransitionModel
from ..ops import align_band as AB
from ..ops import viterbi as V
from ..utils.logging import get_logger

log = get_logger()

_UNSET = object()

# Beams at or above this are treated as "no pruning": alignment routes to the
# exact gather-free banded kernel (ops/align_band.py) when the graph set fits
# the banded form; below it the pruned generic kernel is used.  A large finite
# beam (e.g. 5e8) therefore also gets the unpruned banded kernel — harmless,
# since such beams prune nothing.
_NO_PRUNE_BEAM = 1e8


class DeviceBandPlan(NamedTuple):
    """Device-resident mirror of :class:`ops.align_band.BandPlan`.

    The plan arrays are invariant across EM iterations; re-uploading them on
    every ``align`` call costs ~7 host->device transfers.  Upload once, reuse
    every iteration."""

    W: jnp.ndarray  # [B, S, K] f32
    pdf: jnp.ndarray  # [B, S] int32
    arc_of: jnp.ndarray  # [B, S, K] int32
    offsets: tuple  # K static ints (jit-static arg)
    offsets_arr: jnp.ndarray  # [K] int32 (backtrace operand)
    alpha0: jnp.ndarray  # [B, S] f32
    final: jnp.ndarray  # [B, S] f32
    n2o: np.ndarray  # [B, S] HOST int32 (only used after the fetch)

    @classmethod
    def from_host(cls, plan: AB.BandPlan) -> "DeviceBandPlan":
        return cls(W=jnp.asarray(plan.W), pdf=jnp.asarray(plan.pdf),
                   arc_of=jnp.asarray(plan.arc_of), offsets=plan.offsets,
                   offsets_arr=jnp.asarray(plan.offsets, jnp.int32),
                   alpha0=jnp.asarray(plan.alpha0),
                   final=jnp.asarray(plan.final), n2o=plan.n2o)

    def take(self, idx: np.ndarray) -> "DeviceBandPlan":
        """Batch-subset the plan ON DEVICE (one small idx upload instead of
        re-uploading sliced host copies of every array per chunk)."""
        i = jnp.asarray(idx)
        return DeviceBandPlan(
            W=jnp.take(self.W, i, axis=0), pdf=jnp.take(self.pdf, i, axis=0),
            arc_of=jnp.take(self.arc_of, i, axis=0), offsets=self.offsets,
            offsets_arr=self.offsets_arr,
            alpha0=jnp.take(self.alpha0, i, axis=0),
            final=jnp.take(self.final, i, axis=0), n2o=self.n2o[idx])


def align_banded(plan: AB.BandPlan | DeviceBandPlan, graphs: list, loglikes,
                 num_frames, acoustic_scale: float):
    """Run the gather-free banded alignment kernel (ops/align_band.py) for
    ``graphs`` under ``plan`` and assemble per-utterance results.  loglikes
    [B, T, P] (device or host); T is padded to a multiple of 128 here."""
    if isinstance(plan, AB.BandPlan):
        plan = DeviceBandPlan.from_host(plan)
    num_frames = np.asarray(num_frames)
    t = loglikes.shape[1]
    t_pad = max(128, -(-t // 128) * 128)
    if t_pad != t:
        loglikes = jnp.pad(jnp.asarray(loglikes),
                           ((0, 0), (0, t_pad - t), (0, 0)))
    nf = jnp.asarray(num_frames)
    alpha_end, bps = AB.viterbi_forward_banded(
        plan.W, plan.pdf, plan.alpha0,
        jnp.asarray(loglikes), nf, np.float32(acoustic_scale), plan.offsets)
    packed, score = AB.backtrace_banded_device(
        alpha_end, plan.final, bps, nf, plan.offsets_arr, plan.arc_of)
    packed = np.asarray(packed)  # ONE [T+2, B] device->host fetch
    arcs, end_b, ok = packed[:-2], packed[-2], packed[-1].astype(bool)
    end_orig = plan.n2o[np.arange(len(graphs)), end_b]
    return V.assemble_batched_results(
        graphs, arcs, ok, np.maximum(end_orig, 0), np.asarray(score),
        num_frames)


class AlignmentSet:
    """Per-utterance dense training graphs padded into one device batch.

    At real-corpus scale the monolithic batch is impossible: the loglikes
    [B, T, P] and backpointers [T, B, S] tensors each exceed 1 GB around one
    thousand utterances.  :meth:`align_feats` therefore processes
    length-sorted fixed-size sub-batches whose combined device footprint
    stays under ``max_chunk_bytes`` (384 MB by default), with the backtrace
    run ON DEVICE so only [T, B] arc ids are fetched — the batched analog of
    the reference's nj-way sharded ``gmm-align-compiled`` fan-out
    (``train_gmm_mono.cpp:577-612``).
    """

    def __init__(self, graphs: list[V.DenseGraph],
                 max_chunk_bytes: int = 384 << 20):
        self.graphs = graphs
        self.max_chunk_bytes = max_chunk_bytes
        self._padded = None
        self._plans = None
        self._plan_spec = None
        self._band = _UNSET
        self._band_dev = None

    @property
    def band(self) -> AB.BandPlan | None:
        """Banded plan (ops/align_band.py), or None when the graph set
        doesn't fit the banded form (wide band / non-dst-pure pdfs)."""
        if self._band is _UNSET:
            why: list = []
            self._band = (AB.build_band_plan(self.graphs, reason=why)
                          if self.graphs else None)
            if self._band is None and self.graphs:
                log.info("alignment: graphs not banded-friendly (%s), using "
                         "the generic gather kernel for the whole batch",
                         why[0] if why else "unknown")
        return self._band

    @property
    def band_dev(self) -> DeviceBandPlan | None:
        """Device-resident band plan, uploaded once per AlignmentSet."""
        if self._band_dev is None and self.band is not None:
            self._band_dev = DeviceBandPlan.from_host(self.band)
        return self._band_dev

    @property
    def padded(self) -> dict:
        """Monolithic padded batch (small sets / tests)."""
        if self._padded is None:
            self._padded = V.pad_graphs(self.graphs)
        return self._padded

    def _graph_plans(self, s_pad: int):
        if self._plans is None:
            self._plans = [
                V.build_reduction_plan(g.arc_dst, s_pad)
                for g in self.graphs]
            self._plan_spec = V.batched_plan_spec(
                self._plans, [g.num_arcs for g in self.graphs])
        return self._plans, self._plan_spec

    @classmethod
    def from_fsts(cls, fsts: list[Fst], trans_model: TransitionModel) -> "AlignmentSet":
        tid2pdf = trans_model.tid2pdf
        return cls([V.compile_dense_graph(f, tid2pdf) for f in fsts])

    def align(self, loglikes, num_frames, acoustic_scale: float = 1.0,
              beam: float = 1e9):
        """loglikes [B, T, P] (already on device / materializable); returns
        list of alignment dicts (tids etc.).  Backtrace runs on device.

        beam >= _NO_PRUNE_BEAM routes to the exact banded kernel when the
        graphs fit the banded form; smaller beams use the pruned generic
        kernel."""
        if beam >= _NO_PRUNE_BEAM and self.band is not None:
            # exact alignment over banded training graphs: gather-free kernel
            return align_banded(self.band_dev, self.graphs, loglikes,
                                num_frames, acoustic_scale)
        p = self.padded
        alpha_end, bps = V.viterbi_forward_batched(
            p["arc_src"], p["levels"], p["arc_pdf"], p["arc_score"],
            p["alpha0"], loglikes, num_frames,
            np.float32(acoustic_scale), np.float32(beam), p["num_states"])
        nf = jnp.asarray(num_frames)
        arcs, ok, end_state, score = V.backtrace_batched_device(
            jnp.asarray(p["arc_src"]), alpha_end,
            jnp.asarray(p["final_score"]), bps, nf)
        return V.assemble_batched_results(
            self.graphs, np.asarray(arcs), np.asarray(ok),
            np.asarray(end_state), np.asarray(score), np.asarray(num_frames))

    def align_feats(self, params, feats: np.ndarray, num_frames: np.ndarray,
                    acoustic_scale: float = 1.0, beam: float = 1e9):
        """Chunked alignment from features: computes loglikes per sub-batch
        (never materializing the full [B, T, P]) and aligns each sub-batch
        with a bounded device footprint.  ``params`` is a packed GMM
        (ops/gmm_kernels.pack_gmm); feats [B, T, D] host array.

        Sub-batches share one padded shape (global S/A/plan spec, fixed
        chunk batch size, frame counts bucketed to multiples of 128) so the
        whole EM loop compiles a handful of programs, not one per chunk.
        """
        from ..ops import gmm_kernels as K

        feats = np.asarray(feats)
        num_frames = np.asarray(num_frames)
        b_total = len(self.graphs)
        if b_total == 0:
            return []
        s_max = max(g.num_states for g in self.graphs)
        a_max = max(g.num_arcs for g in self.graphs)
        s_pad = s_max + 1
        num_pdfs = int(params.gconsts.shape[0])
        band = self.band if beam >= _NO_PRUNE_BEAM else None
        plans, depth, rows = None, None, None
        if band is None:
            plans, (depth, rows) = self._graph_plans(s_pad)

        # fixed chunk batch size from the worst-case (longest) bucket
        t_bucket_max = max(128, -(-int(num_frames.max()) // 128) * 128)
        bytes_per_utt = 4 * t_bucket_max * (num_pdfs + 2 * s_pad)
        b_chunk = int(max(8, min(b_total, self.max_chunk_bytes // bytes_per_utt)))

        order = np.argsort(-num_frames, kind="stable")
        results: list = [None] * b_total
        for lo in range(0, len(order), b_chunk):
            idx = order[lo: lo + b_chunk]
            real = len(idx)
            # pad the tail chunk with repeats at 0 frames (masked inactive)
            if real < b_chunk:
                idx = np.concatenate(
                    [idx, np.full(b_chunk - real, idx[0], np.int64)])
            nf_c = num_frames[idx].copy()
            nf_c[real:] = 0
            t_c = max(128, -(-int(nf_c.max()) // 128) * 128)
            graphs_c = [self.graphs[i] for i in idx]
            feats_c = np.zeros((b_chunk, t_c, feats.shape[2]), np.float32)
            for j, i in enumerate(idx[:real]):
                n = int(num_frames[i])
                feats_c[j, :n] = feats[i, :n]
            ll = K.loglikes_batch(params, jnp.asarray(feats_c))
            if band is not None and beam >= _NO_PRUNE_BEAM:
                chunk_res = align_banded(
                    self.band_dev.take(idx),
                    graphs_c, ll, nf_c, acoustic_scale)[:real]
            else:
                padded = V.pad_graphs(
                    graphs_c, pad_states=s_max, pad_arcs=a_max,
                    plans=[plans[i] for i in idx], plan_depth=depth,
                    plan_rows=rows)
                nf_j = jnp.asarray(nf_c)
                alpha_end, bps = V.viterbi_forward_batched(
                    padded["arc_src"], padded["levels"], padded["arc_pdf"],
                    padded["arc_score"], padded["alpha0"], ll, nf_j,
                    np.float32(acoustic_scale), np.float32(beam),
                    padded["num_states"])
                arcs, ok, end_state, score = V.backtrace_batched_device(
                    jnp.asarray(padded["arc_src"]), alpha_end,
                    jnp.asarray(padded["final_score"]), bps, nf_j)
                chunk_res = V.assemble_batched_results(
                    graphs_c[:real], np.asarray(arcs), np.asarray(ok),
                    np.asarray(end_state), np.asarray(score), nf_c)
            for j, i in enumerate(idx[:real]):
                results[int(i)] = chunk_res[j]
        return results


def apply_alignments(results: list, tids: np.ndarray, weights: np.ndarray,
                     num_frames, stage: str, names: list | None = None,
                     max_fail_frac: float = 0.5) -> int:
    """Fill (tids, weights) in place from batched align results, zeroing
    failed utterances; failures are logged per utterance and a systemic
    failure (> max_fail_frac) aborts (utils/health.py failure model — the
    reference logs '** Alignment failed **' per utt and errors when all jobs
    fail).  Returns the number of failures."""
    from ..utils.health import FailureTracker

    tracker = FailureTracker(stage, total=len(results))
    tids[:] = 0
    weights[:] = 0.0
    for i, r in enumerate(results):
        if r["tids"]:
            tids[i, : num_frames[i]] = r["tids"]
            weights[i, : num_frames[i]] = 1.0
        else:
            tracker.record(names[i] if names else f"utt[{i}]",
                           "no path through training graph")
    tracker.finish(max_fail_frac)
    return tracker.num_failed


def equal_align(graph: V.DenseGraph, num_frames: int, seed: int = 0):
    """Evenly-spread initial alignment (align-equal-compiled): pick a RANDOM
    successful path through the graph (like the reference — a deterministic
    shortest path would always skip optional silence, starving the silence
    pdfs of flat-start data), then pad with self-loops distributed evenly.
    Returns list of arc indices (one per frame) or None if impossible."""
    rng = np.random.default_rng(seed)
    # adjacency: arcs by src
    by_src: dict[int, list[int]] = {}
    for i, s in enumerate(graph.arc_src):
        by_src.setdefault(int(s), []).append(i)
    # self-loop arc per state (prefer the max-score one)
    self_loop: dict[int, int] = {}
    for i in range(graph.num_arcs):
        s, d = int(graph.arc_src[i]), int(graph.arc_dst[i])
        if s == d and (s not in self_loop or
                       graph.arc_score[i] > graph.arc_score[self_loop[s]]):
            self_loop[s] = i

    init = int(np.argmax(graph.alpha0))
    if graph.alpha0[init] <= V.NEG_INF / 2:
        return None
    # reverse BFS: min #arcs from each state to a final state (self-loops
    # excluded) so the random walk never overshoots the frame budget
    radj: dict[int, list[int]] = {}
    for i in range(graph.num_arcs):
        s, d = int(graph.arc_src[i]), int(graph.arc_dst[i])
        if s != d:
            radj.setdefault(d, []).append(s)
    inf = 10 ** 9
    dist_final = np.full(graph.num_states, inf, np.int64)
    frontier = [s for s in range(graph.num_states)
                if graph.final_score[s] > V.NEG_INF / 2]
    for s in frontier:
        dist_final[s] = 0
    while frontier:
        nxt = []
        for d in frontier:
            for s in radj.get(d, ()):  # predecessors
                if dist_final[s] > dist_final[d] + 1:
                    dist_final[s] = dist_final[d] + 1
                    nxt.append(s)
        frontier = nxt
    if dist_final[init] > num_frames:
        return None

    # random walk with feasibility constraint
    path: list[int] = []
    s = init
    budget = num_frames
    while True:
        if graph.final_score[s] > V.NEG_INF / 2 and (
                dist_final[s] == 0 and (budget == 0 or rng.random() < 0.3)):
            break
        choices = [i for i in by_src.get(s, ())
                   if int(graph.arc_dst[i]) != s
                   and dist_final[int(graph.arc_dst[i])] <= budget - 1]
        if not choices:
            if graph.final_score[s] > V.NEG_INF / 2:
                break
            return None
        i = int(choices[rng.integers(len(choices))])
        path.append(i)
        s = int(graph.arc_dst[i])
        budget -= 1

    k = len(path)
    if k > num_frames:
        return None
    extra = num_frames - k
    loop_positions = [i for i, a in enumerate(path)
                      if int(graph.arc_dst[a]) in self_loop]
    if extra > 0 and not loop_positions:
        return None
    frames: list[int] = []
    m = len(loop_positions)
    base, rem = (extra // m, extra % m) if m else (0, 0)
    extras = {}
    for j, pos in enumerate(loop_positions):
        extras[pos] = base + (1 if j < rem else 0)
    for i, a in enumerate(path):
        frames.append(a)
        n_extra = extras.get(i, 0)
        if n_extra:
            frames.extend([self_loop[int(graph.arc_dst[a])]] * n_extra)
    assert len(frames) == num_frames
    return frames


def alignment_to_tids(graph: V.DenseGraph, arc_frames: list[int]) -> list[int]:
    return [int(graph.arc_tid[a]) for a in arc_frames]


def align_utterances(am, trans_model, lang, feats_by_utt: dict,
                     transcripts: dict, acoustic_scale: float = 1.0,
                     boost_silence: float = 1.0, transition_scale: float = 1.0,
                     self_loop_scale: float = 0.1,
                     silence_pdfs: list | None = None) -> dict:
    """AlignSi (scr/steps/align_si.cpp): align every utterance to its
    transcript with an existing model; returns utt -> list[tid]."""
    import jax.numpy as jnp

    from ..fst.hclg import TrainingGraphCompiler
    from ..ops import gmm_kernels as K

    utts = sorted(feats_by_utt)
    compiler = TrainingGraphCompiler(lang, trans_model.tree, trans_model,
                                     transition_scale, self_loop_scale)
    fsts = compiler.compile_batch([transcripts[u] for u in utts])
    aset = AlignmentSet.from_fsts(fsts, trans_model)
    b = len(utts)
    t_max = max(feats_by_utt[u].shape[0] for u in utts)
    d = feats_by_utt[utts[0]].shape[1]
    feats = np.zeros((b, t_max, d), np.float32)
    nf = np.zeros(b, np.int32)
    for i, u in enumerate(utts):
        f = feats_by_utt[u]
        feats[i, : f.shape[0]] = f
        nf[i] = f.shape[0]
    align_am = am
    if boost_silence != 1.0 and silence_pdfs:
        align_am = am.boost_silence(silence_pdfs, boost_silence)
    results = aset.align_feats(K.pack_gmm(align_am), feats, nf,
                               acoustic_scale=acoustic_scale)
    out = {}
    for u, r in zip(utts, results):
        out[u] = r["tids"]
    return out
