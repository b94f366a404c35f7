"""Decoding: batched Viterbi over the shared HCLG decode graph.

Counterpart of the reference's ``Decode`` step (``scr/steps/decode_gmm.cpp``,
call trace SURVEY.md §3.2) with ``gmm-latgen-faster``'s role played by the
arc-parallel device Viterbi (``ops/viterbi.py``).

LM-weight sweep design: the reference decodes ONCE into lattices and rescales
them per LMWT (``score_kaldi_wer.cpp:279-289``); ``decode_sweep_lattice`` does
the same.  ``decode_sweep`` instead re-runs the exact best-path scan per LMWT —
each run is the same compiled program.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import time

import jax
import jax.numpy as jnp
import numpy as np

from ..config import DecodeOptions
from ..fst.core import Fst
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..ops import gmm_kernels as K
from ..ops import viterbi as V
from ..utils.logging import get_logger

log = get_logger()


@dataclass
class DecodeResult:
    utt: str
    words: list  # word ids
    score: float
    tids: list = field(default_factory=list)


class Decoder:
    def __init__(self, hclg: Fst, trans_model: TransitionModel, am: AmDiagGmm,
                 opts: DecodeOptions = DecodeOptions()):
        from ..ops import decode_core as DC

        self.graph = V.compile_dense_graph(hclg, trans_model.tid2pdf)
        self.plan = DC.build_emit_plan(self.graph)
        self.plan_dev = DC.plan_to_device(self.plan)
        self.trans_model = trans_model
        self.opts = opts
        self.params = K.pack_gmm(am)
        self._levels = None
        log.info("decoder: graph states=%d arcs(eps-free)=%d rows=%d d=%d "
                 "packed-bp=%s", self.graph.num_states, self.graph.num_arcs,
                 self.plan.num_rows, self.plan.d, self.plan.packed)

    @property
    def levels(self):
        """Reduction-plan levels for the lattice forward-backward path
        (built lazily; best-path decoding no longer uses them)."""
        if self._levels is None:
            self._levels = V.build_reduction_plan(
                self.graph.arc_dst, self.graph.num_states, k=8).levels
        return self._levels

    def _loglikes(self, feats: jnp.ndarray) -> jnp.ndarray:
        """[B, T, D] -> [B, T, P] acoustic log-likelihoods, one path on
        every backend (ops/gmm_kernels.loglikes_batch)."""
        return K.loglikes_batch(self.params, feats)

    def _bp_chunk(self, b: int) -> int:
        """Frames per forward-scan dispatch so one backpointer block stays
        under ~1 GB of device memory."""
        bytes_per_frame = (self.plan.num_states + 1) * b * \
            (1 if self.plan.packed else 2)
        return max(32, int(1e9 // max(bytes_per_frame, 1)))

    @staticmethod
    def _bucket(feats: np.ndarray, num_frames: np.ndarray):
        """Pad (B, T) up to a small fixed set of shapes so repeated decodes
        with varying batch/length hit the jit cache: B to the
        next power of two (extra lanes are nearly free in the batch-minor
        layout), T to a multiple of 128 frames."""
        b, t = feats.shape[0], feats.shape[1]
        b_pad = 1 << max(3, (b - 1).bit_length())
        t_pad = max(128, -(-t // 128) * 128)
        if b_pad == b and t_pad == t:
            return feats, np.asarray(num_frames), b
        padded = np.zeros((b_pad, t_pad, feats.shape[2]), feats.dtype)
        padded[:b, :t] = feats
        nf = np.zeros(b_pad, np.int32)
        nf[:b] = num_frames
        return padded, nf, b

    def _batch_chunk(self, t_pad: int, extra_per_utt_bytes: float = 0.0,
                     device_budget: float = 768e6,
                     fetch_budget: float = 48e6,
                     extra_dev_per_utt_bytes: float = 0.0) -> int:
        """Utterances per decode dispatch so device residents (loglikes +
        per-frame state tables) stay under ``device_budget`` and any
        host-fetched per-utterance artifact (``extra_per_utt_bytes``, e.g.
        lattice survivor masks) stays under ``fetch_budget``: the caps bound
        one dispatch's device working set and one device->host copy."""
        p = self.params.gconsts.shape[0]
        # loglikes are the only [B, T, *]-resident common to both paths; the
        # best-path backpointer block is frame-chunked separately
        # (_bp_chunk), so it does not scale with B here
        dev_per_utt = 4.0 * t_pad * p + extra_dev_per_utt_bytes
        n = min(device_budget / dev_per_utt,
                fetch_budget / max(extra_per_utt_bytes, 1.0))
        return int(max(2, min(256, n)))

    def decode_batch(self, utts: list[str], feats: np.ndarray,
                     num_frames: np.ndarray,
                     acoustic_scale: float | None = None,
                     keep_tids: bool = False) -> list[DecodeResult]:
        """feats [B, T, D] padded; returns per-utterance best paths.

        Search is EXACT (infinite beam): the dense relaxation touches every
        state each frame regardless, so pruning would save nothing and can
        only lose paths (the reference's beam exists for CPU token passing).
        Large batches are decoded in bounded sub-batches (device memory)."""
        from ..ops import decode_core as DC

        acwt = self.opts.acoustic_scale if acoustic_scale is None else acoustic_scale
        feats = np.asarray(feats)
        num_frames = np.asarray(num_frames)
        b_chunk = self._batch_chunk(max(128, -(-feats.shape[1] // 128) * 128))
        out = []
        for lo in range(0, len(utts), b_chunk):
            hi = min(len(utts), lo + b_chunk)
            f, nf, b_real = self._bucket(feats[lo:hi], num_frames[lo:hi])
            ll = self._loglikes(jnp.asarray(f))
            paths = DC.decode_best_path(
                self.graph, self.plan, self.plan_dev, ll, nf,
                acoustic_scale=acwt, chunk=self._bp_chunk(f.shape[0]))
            for u, r in zip(utts[lo:hi], paths[:b_real]):
                out.append(DecodeResult(u, r["words"], r["score"],
                                        r["tids"] if keep_tids else []))
        return out

    def decode_sweep(self, utts: list[str], feats: np.ndarray,
                     num_frames: np.ndarray, lmwts: list[int]) -> dict:
        """Exact best-path per LM weight: {lmwt: [DecodeResult]}."""
        return {w: self.decode_batch(utts, feats, num_frames,
                                     acoustic_scale=1.0 / w)
                for w in lmwts}

    @staticmethod
    @jax.jit
    def _ac_gather(ll_dev, idx):
        """Negated flat-index gather over the device loglik block: the
        acoustic costs of surviving lattice arcs (see _fill_ac)."""
        return -jnp.take(ll_dev.reshape(-1), idx)

    @staticmethod
    def _lattice_window(t: int) -> int:
        """Frames per lattice-FB window.  Device residency per utterance
        scales as S*(W + T/W) — the in-window beta/alpha recompute plus one
        alpha snapshot per window — minimized at W ~ sqrt(T).  Rounded to
        the nearest power of two and clamped to [16, 64] so the whole
        T = 100..3000 range shares at most three compiled window programs
        (16 vs 64 also bounds the per-window mask fetch)."""
        w = 1 << max(0, int(round(np.log2(max(t, 1)) / 2.0)))
        return max(16, min(64, w))

    def decode_lattice(self, utts: list[str], feats: np.ndarray,
                       num_frames: np.ndarray,
                       acoustic_scale: float | None = None) -> dict:
        """Lattice-generating decode (``gmm-latgen-faster``'s lattice output):
        batch-minor row-based forward-backward (ops/lattice.py
        ``lattice_forward_backward_rows``); arcs whose best complete path is
        within ``lattice_beam`` of the global best survive.  Returns
        {utt: Lattice} with graph/acoustic costs stored separately.

        Survivor masks come back via the bounded-budget sparse fetch
        (ops/lattice._sparsify_words): typically well under 1% of mask
        bytes are nonzero on real HCLGs, so the dense fetch would move
        ~825 MB of near-zeros per 16-utterance chunk at T=1000 on a
        90k-state graph.  A chunk whose survivor count ever exceeds the
        budget is transparently refetched dense (exact, no clipping)."""
        from ..lat import build_lattices_packed, build_lattices_sparse
        from ..ops import lattice as LAT

        acwt = self.opts.acoustic_scale if acoustic_scale is None else acoustic_scale
        g = self.graph
        window = self._lattice_window(np.asarray(feats).shape[1])
        if not hasattr(self, "_lat_plans"):
            _plan, fwd_dev, bwd_plan, bwd_dev, row_dst = \
                LAT.build_lattice_plans(g, fwd_plan=self.plan)
            self._lat_plans = (fwd_dev, bwd_plan, bwd_dev, row_dst)
        fwd_dev, bwd_plan, bwd_dev, row_dst = self._lat_plans
        feats = np.asarray(feats)
        num_frames = np.asarray(num_frames)
        # pad T to a multiple of 128: a multiple of every window choice, and
        # the same T-bucketing as the best-path `_bucket`, so both decode
        # paths share compiled loglik programs across varying raw lengths
        t_pad = max(128, -(-feats.shape[1] // 128) * 128)
        if t_pad != feats.shape[1]:
            feats = np.concatenate(
                [feats, np.zeros((feats.shape[0], t_pad - feats.shape[1],
                                  feats.shape[2]), feats.dtype)], axis=1)
        s1 = self.plan.num_states + 1
        nbytes = -(-self.plan.num_rows * self.plan.d // 8)
        nw = t_pad // window
        # nonzero-WORD budget per (window, utt): 1024 words/frame.  The
        # hierarchical sparsify's sort cost is nearly K-independent and the
        # count-first fetch moves only pow2(max_count) words per window
        # (ops/lattice.py).  Overflow falls back to the exact dense fetch
        # for the whole chunk, so lattices are NEVER clipped on this path.
        budget = window * 1024
        # device residency per utterance: beta slab + snapshots + loglikes
        # + the full [K, B] sparse idx/val buffers held until the deferred
        # post-loop slice (ops/lattice.py round-5 fetch design)
        dev_per_utt = (4.0 * s1 * (window + nw)
                       + 4.0 * t_pad * self.params.gconsts.shape[0]
                       + 8.0 * budget * nw)
        # at most 128 utterances per chunk: bounds one chunk's device
        # residency and the host assembly that overlaps the next chunk
        n = max(2, min(128, self.opts.lattice_mem_budget / dev_per_utt))
        # power-of-two sub-batch: arbitrary b_chunk values would compile one
        # window program per distinct (graph, B) pair
        b_chunk = 1 << int(np.log2(n))
        out: dict = {}
        n_chunks = -(-len(utts) // b_chunk)

        def _assemble(ci, sparse, nf, use_final):
            clips = []
            lats = build_lattices_sparse(
                g, self.plan.row_arc, sparse, nbytes, None, nf,
                use_final, log_warn=lambda *a: clips.append(a))
            return ci, lats, clips

        p_tot = self.params.gconsts.shape[0]

        def _fill_ac(lats, ll_dev):
            """Fill acoustic costs with ONE device gather of exactly the
            surviving (utt, t, pdf) loglik entries, instead of copying the
            whole [B, T, P] loglik block (~258 MB per 128-utt chunk) to the
            host; the survivors are a few MB."""
            import jax

            sizes = [lat.num_arcs for lat in lats]
            total = int(np.sum(sizes))
            if total == 0:
                return
            idx = np.empty(total, np.int64)
            o = 0
            for i, lat in enumerate(lats):
                n = lat.num_arcs
                pdfs = g.arc_pdf[lat.arc_id]
                idx[o: o + n] = (np.int64(i) * t_pad
                                 + lat.arc_t.astype(np.int64)) * p_tot + pdfs
                o += n
            k_pad = max(1024, 1 << (total - 1).bit_length())
            idx_p = np.zeros(k_pad, np.int32)
            idx_p[:total] = idx  # flat indices < B*T*P ~ 65M, int32-safe
            ac = np.asarray(self._ac_gather(ll_dev, jnp.asarray(idx_p)))
            o = 0
            for lat, n in zip(lats, sizes):
                lat.acoustic_cost = ac[o: o + n].copy()
                o += n

        # Host lattice assembly overlaps the NEXT chunk's device FB: the
        # main thread keeps dispatching window programs while one helper
        # thread expands the previous chunk's sparse masks (numpy releases
        # the GIL on the large ops).
        from concurrent.futures import ThreadPoolExecutor
        results: dict[int, list] = {}
        redo: list[tuple] = []  # (ci, clips) -> dense refetch, main thread

        def _drain(fut):
            ci, lats, clips = fut.result()
            if clips:
                redo.append((ci, clips))
            else:
                results[ci] = lats

        with ThreadPoolExecutor(max_workers=1) as pool:
            pending = None
            pending_ll = None  # chunk's device loglikes, for the ac gather
            chunk_args = []  # (lo, hi, f, nf) per chunk, for redo + zip

            def _drain_and_fill(fut, ll_dev):
                _drain(fut)
                ci = fut.result()[0]
                if ci in results:
                    _fill_ac(results[ci], ll_dev)

            for ci, lo in enumerate(range(0, len(utts), b_chunk)):
                hi = min(len(utts), lo + b_chunk)
                real = hi - lo
                f, nf = feats[lo:hi], num_frames[lo:hi]
                if real < b_chunk:  # pad tail chunk: one jitted shape only
                    f = np.concatenate(
                        [f, np.zeros((b_chunk - real,) + f.shape[1:],
                                     f.dtype)])
                    nf = np.concatenate(
                        [nf, np.zeros(b_chunk - real, nf.dtype)])
                chunk_args.append((lo, hi, f, nf))
                t_fb0 = time.perf_counter()
                ll = self._loglikes(jnp.asarray(f))
                sparse, _best, _aend, use_final = \
                    LAT.lattice_forward_backward_rows(
                        g, self.plan, fwd_dev, bwd_plan, bwd_dev, row_dst,
                        ll, nf, acoustic_scale=acwt,
                        lattice_beam=self.opts.lattice_beam, window=window,
                        mask_budget=budget)
                log.debug("decode_lattice: chunk %d fb+fetch %.2fs",
                          ci + 1, time.perf_counter() - t_fb0)
                if pending is not None:
                    _drain_and_fill(pending, pending_ll)
                pending = pool.submit(_assemble, ci, sparse, nf, use_final)
                pending_ll = ll
                if ci == 0 or (ci + 1) % 8 == 0 or ci + 1 == n_chunks:
                    log.info("decode_lattice: chunk %d/%d (%d utts) "
                             "dispatched", ci + 1, n_chunks, hi)
            if pending is not None:
                _drain_and_fill(pending, pending_ll)

        for ci, clips in redo:
            # rare: redo the chunk with the dense mask fetch — exactness
            # over speed
            log.info(
                "decode_lattice: chunk %d: %d window(s) over the sparse "
                "budget (worst %d > %d); refetching dense", ci + 1,
                len(clips), max(c[2] for c in clips), budget)
            _lo, _hi, f, nf = chunk_args[ci]
            ll = self._loglikes(jnp.asarray(f))
            packed, _best, _aend, use_final = \
                LAT.lattice_forward_backward_rows(
                    g, self.plan, fwd_dev, bwd_plan, bwd_dev, row_dst,
                    ll, nf, acoustic_scale=acwt,
                    lattice_beam=self.opts.lattice_beam, window=window)
            results[ci] = build_lattices_packed(
                g, self.plan.row_arc, packed, None, nf, use_final)
            _fill_ac(results[ci], ll)
        for ci, (lo, hi, _f, _nf) in enumerate(chunk_args):
            out.update(zip(utts[lo:hi], results[ci][:hi - lo]))
        return out

    def decode_sweep_lattice(self, utts: list[str], feats: np.ndarray,
                             num_frames: np.ndarray, lmwts: list[int],
                             word_ins_penalties: tuple = (0.0,)
                             ) -> tuple[dict, dict]:
        """The reference's scoring design (``score_kaldi_wer.cpp:279-356``):
        decode ONCE into lattices at the training acoustic scale, then per
        (LMWT, WIP) grid point rescale + add word-insertion penalty + best
        path on the host (``lattice-scale`` -> ``lattice-add-penalty`` ->
        ``lattice-best-path``) — no re-decode.

        The grid sweep is vectorized over all grid points inside ONE host
        pass per utterance (lat.lattice_best_path_grid), so it is not
        threaded (the reference threads it, score_kaldi_wer.cpp:93-111,
        because its per-point best path is a full lattice pass).

        Returns ({(lmwt, wip): [DecodeResult]}, {utt: Lattice})."""
        from ..lat import lattice_best_path_grid

        lats = self.decode_lattice(utts, feats, num_frames)
        grid = [(w, wip) for w in lmwts for wip in word_ins_penalties]
        points = [(1.0, 1.0 / w, wip) for (w, wip) in grid]
        sweep = {gp: [] for gp in grid}
        for u in utts:  # the whole grid sweeps in one vectorized pass per utt
            for gp, p in zip(grid, lattice_best_path_grid(lats[u], points)):
                sweep[gp].append(DecodeResult(u, p["words"], p["score"],
                                              p["tids"]))
        return sweep, lats

    def decode_nbest(self, utts: list[str], feats: np.ndarray,
                     num_frames: np.ndarray, nbest: int = 4,
                     acoustic_scale: float | None = None) -> dict:
        """Exact N-best decoding (lattice-nbest role): utt -> list of
        (words, score) hypotheses.  Full backpointers are stored, so use
        rescoring-scale batches."""
        acwt = self.opts.acoustic_scale if acoustic_scale is None else acoustic_scale
        g = self.graph
        ll = self._loglikes(jnp.asarray(feats))
        alpha_end, bpa, bps = V.viterbi_nbest_forward(
            jnp.asarray(g.arc_src), self.levels, jnp.asarray(g.arc_pdf),
            jnp.asarray(g.arc_score), jnp.asarray(g.alpha0), ll,
            jnp.asarray(num_frames), np.float32(acwt),
            np.float32(self.opts.beam), g.num_states, nbest)
        hyps = V.backtrace_nbest(g, alpha_end, bpa, bps,
                                 np.asarray(num_frames), nbest)
        return {u: [(h["words"], h["score"]) for h in hs]
                for u, hs in zip(utts, hyps)}

    def decode_mbr(self, utts: list[str], feats: np.ndarray,
                   num_frames: np.ndarray, nbest: int = 8) -> list[DecodeResult]:
        """MBR consensus decoding over lattices (``lattice-mbr-decode`` role):
        one lattice decode, then a confusion network from each lattice's
        word-unique N best paths."""
        from ..lat import lattice_mbr, lattice_best_path

        lats = self.decode_lattice(utts, feats, num_frames)
        acwt = self.opts.acoustic_scale
        out = []
        for u in utts:
            words, _conf = lattice_mbr(lats[u], n=nbest, lm_scale=1.0,
                                       acoustic_scale=acwt)
            score = lattice_best_path(lats[u], 1.0, acwt)["score"]
            out.append(DecodeResult(u, words, score))
        return out
