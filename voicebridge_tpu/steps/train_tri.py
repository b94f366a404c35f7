"""Triphone GMM training with decision-tree state tying ("train_deltas").

Counterpart of the reference's ``TrainDeltas`` (``scr/steps/train_deltas.cpp``,
SURVEY.md §2.1): tree prologue (AccTreeStats -> ClusterPhones ->
CompileQuestions -> BuildTree), GmmInitModel from tree stats, ConvertAli of
the previous stage's alignments, then the usual EM loop with Viterbi
realignment.  ``TrainLdaMllt``/``TrainSat`` reuse this skeleton with
transform estimation interleaved (see train_lda_mllt.py / train_sat.py).

Design notes: the whole E-step (likelihoods, Viterbi over per-utterance
graphs, stat segment-sums) is batched on device; tree building and M-step are
host-side between iterations.
"""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..config import TriTrainOptions
from ..data.lang import Lang
from ..fst.hclg import TrainingGraphCompiler
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..models.treebuild import GaussStats, acc_tree_stats, build_tree
from ..ops import gmm_kernels as K
from ..utils.logging import get_logger
from .align import AlignmentSet, apply_alignments
from .train_mono import TrainedModel, save_model

log = get_logger()


def init_model_from_tree_stats(tree, tree_stats: dict, min_variance=0.001) -> AmDiagGmm:
    """gmm-init-model: each leaf pdf = 1 Gaussian from its pooled stats."""
    dim = len(next(iter(tree_stats.values())).sum_x)
    per_pdf = [GaussStats(dim) for _ in range(tree.num_pdfs)]
    total = GaussStats(dim)
    for (window, pdf_class), st in tree_stats.items():
        pdf = tree.map(window, pdf_class)
        per_pdf[pdf].add(st)
        total.add(st)
    glob_mean = total.sum_x / max(total.count, 1.0)
    glob_var = np.maximum(total.sum_x2 / max(total.count, 1.0) - glob_mean ** 2,
                          min_variance)
    miv = np.zeros((tree.num_pdfs, 1, dim), np.float32)
    iv = np.ones((tree.num_pdfs, 1, dim), np.float32)
    w = np.ones((tree.num_pdfs, 1), np.float32)
    for p, st in enumerate(per_pdf):
        if st.count > 2.0:
            mean = st.sum_x / st.count
            var = np.maximum(st.sum_x2 / st.count - mean * mean, min_variance)
        else:
            mean, var = glob_mean, glob_var
        iv[p, 0] = (1.0 / var).astype(np.float32)
        miv[p, 0] = (mean / var).astype(np.float32)
    return AmDiagGmm(miv, iv, w)


def train_tri(feats_by_utt: dict, transcripts: dict, prev_alignments: dict,
              lang: Lang, opts: TriTrainOptions = TriTrainOptions(),
              prev_trans_model: TransitionModel | None = None,
              out_dir: str | Path | None = None) -> TrainedModel:
    """``prev_alignments``: utt -> tids from the previous stage's model
    (``prev_trans_model``; e.g. the monophone system)."""
    assert prev_trans_model is not None
    utts = sorted(feats_by_utt)
    n_ctx, p_ctx = opts.context_width, opts.central_position

    # ---- tree building (stages -3..-1 of train_deltas) ---------------------
    sil = set(lang.silence_phone_ids)
    tree_stats = acc_tree_stats(prev_alignments, feats_by_utt, prev_trans_model,
                                n_ctx, p_ctx, ci_phones=sil)
    tree = build_tree(tree_stats, lang, n_ctx, p_ctx,
                      num_leaves=opts.num_leaves,
                      cluster_thresh=opts.cluster_thresh)
    trans_model = TransitionModel(lang.topo, tree)
    am = init_model_from_tree_stats(tree_stats=tree_stats, tree=tree,
                                    min_variance=opts.min_variance)
    log.info("train_tri: tree has %d leaves (asked %d); %d tids",
             tree.num_pdfs, opts.num_leaves, trans_model.num_transition_ids)

    # ---- convert alignments (convert-ali) ----------------------------------
    tids_by_utt = {}
    for u in utts:
        ali = prev_alignments.get(u) or []
        if ali:
            tids_by_utt[u] = prev_trans_model.convert_alignment(
                ali, trans_model, n_ctx, p_ctx)
        else:
            tids_by_utt[u] = []

    # ---- batched data ------------------------------------------------------
    b = len(utts)
    t_max = max(feats_by_utt[u].shape[0] for u in utts)
    dim = feats_by_utt[utts[0]].shape[1]
    feats = np.zeros((b, t_max, dim), np.float32)
    num_frames = np.zeros(b, np.int32)
    for i, u in enumerate(utts):
        f = feats_by_utt[u]
        feats[i, : f.shape[0]] = f
        num_frames[i] = f.shape[0]
    tids = np.zeros((b, t_max), np.int32)
    weights = np.zeros((b, t_max), np.float32)
    for i, u in enumerate(utts):
        a = tids_by_utt[u]
        if a:
            tids[i, : len(a)] = a
            weights[i, : len(a)] = 1.0

    # ---- training graphs ---------------------------------------------------
    compiler = TrainingGraphCompiler(lang, tree, trans_model,
                                     opts.transition_scale, opts.self_loop_scale)
    fsts = compiler.compile_batch([transcripts[u] for u in utts])
    aset = AlignmentSet.from_fsts(fsts, trans_model)
    log.info("train_tri: graphs compiled (max states=%d, max arcs=%d)",
             max(g.num_states for g in aset.graphs),
             max(g.num_arcs for g in aset.graphs))

    silence_pdfs = sorted({pdf for p in lang.silence_phone_ids
                           for c in range(lang.topo.num_pdf_classes(p))
                           for pdf in tree.possible_pdfs(p, c)})

    def accumulate():
        params = K.pack_gmm(am)
        x = feats.reshape(b * t_max, dim)
        tflat = tids.reshape(-1)
        wflat = weights.reshape(-1)
        pdfs = trans_model.tid2pdf[tflat]
        occ, macc, vacc, ll = K.acc_gmm_stats_chunked(
            params, x, pdfs, tree.num_pdfs, wflat)
        tstats = K.acc_transition_stats(jnp.asarray(tflat),
                                        trans_model.num_transition_ids,
                                        jnp.asarray(wflat))
        return occ, macc, vacc, np.asarray(tstats), ll

    num_gauss = am.num_gauss
    inc_gauss = max((opts.totgauss - num_gauss) // opts.max_iter_inc, 0)

    for it in range(1, opts.num_iters + 1):
        if it in opts.realign_iters:
            align_am = (am.boost_silence(silence_pdfs, opts.boost_silence)
                        if opts.boost_silence != 1.0 else am)
            results = aset.align_feats(K.pack_gmm(align_am), feats, num_frames,
                                       acoustic_scale=opts.acoustic_scale)
            apply_alignments(results, tids, weights, num_frames,
                             "train_tri realign", names=utts)
        occ, macc, vacc, tstats, ll = accumulate()
        if it <= opts.max_iter_inc:
            num_gauss += inc_gauss
        am.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy,
                      opts.min_variance)
        am.split_to_target(num_gauss, occ, power=opts.power, seed=1000 + it)
        trans_model.mle_update(tstats)
        if it % 5 == 0 or it == opts.num_iters:
            log.info("train_tri iter %d: loglike/frame %.4f, num_gauss %d",
                     it, ll / max(float(weights.sum()), 1.0), am.num_gauss)

    model = TrainedModel(am, trans_model, tree, lang)
    if out_dir:
        save_model(Path(out_dir), am, trans_model, tree)
    return model
