"""Speaker-adapted training (SAT) with per-speaker fMLLR.

Counterpart of the reference's ``TrainSat`` (``scr/steps/train_sat.cpp``,
1 886 LoC; SURVEY.md §2.1): initial per-speaker fMLLR from the previous
system's alignments, tree rebuild on adapted features, EM with transforms
re-estimated on ``fmllr_iters``, and a final speaker-independent ``alimdl``
(GmmAccStatsTwofeats) for first-pass decoding.

Batched re-design notes: all speakers' fMLLR statistics are accumulated in ONE
device pass (segment-sum over a speaker-id vector) instead of the reference's
per-speaker job loop; the row-wise solves run host-side per speaker (40x41
matrices).  Transforms are re-estimated from the *base* features with the
current model each time (mathematically the same family as the reference's
incremental compose chain).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..config import TriTrainOptions
from ..data.lang import Lang
from ..fst.hclg import TrainingGraphCompiler
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..models.treebuild import acc_tree_stats, build_tree
from ..ops import gmm_kernels as K
from ..transforms.fmllr import (acc_fmllr_stats, apply_fmllr_batch,
                                estimate_fmllr_batch)
from ..utils.logging import get_logger
from .align import AlignmentSet, apply_alignments
from .train_lda_mllt import _batch, silence_frame_weights
from .train_mono import TrainedModel, save_model
from .train_tri import init_model_from_tree_stats

log = get_logger()


@dataclass
class SatModel:
    model: TrainedModel
    alimdl: AmDiagGmm  # speaker-independent model for first-pass decoding
    transforms: dict  # speaker -> [D, D+1] (training speakers)


def _estimate_transforms(am, trans_model, base_flat, pdfs_flat, w_flat,
                         spk_flat, num_spk, min_count=500.0, mesh=None):
    params = K.pack_gmm(am)
    beta, k, g = acc_fmllr_stats(
        params, jnp.asarray(am.means()), jnp.asarray(am.inv_vars),
        base_flat, pdfs_flat, w_flat, spk_flat, num_spk, mesh=mesh)
    trans, imprs = estimate_fmllr_batch(np.asarray(beta), np.asarray(k),
                                        np.asarray(g), min_count=min_count)
    return trans, float(np.mean([i for i in imprs if i] or [0.0]))


def train_sat(base_feats: dict, utt2spk: dict, transcripts: dict,
              prev_alignments: dict, prev_am: AmDiagGmm, lang: Lang,
              opts: TriTrainOptions = TriTrainOptions(),
              prev_trans_model: TransitionModel | None = None,
              out_dir: str | Path | None = None, mesh=None) -> SatModel:
    """Full SAT training (see module docstring).

    ``mesh``: optional jax.sharding.Mesh — routes the fMLLR / tree
    statistics accumulation through the data-axis-sharded psum programs
    (SURVEY §2.6 P2; parallel/mesh.py)."""
    assert prev_trans_model is not None
    utts = sorted(base_feats)
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    num_spk = len(speakers)
    raw, num_frames = _batch(base_feats, utts)
    b, t_max, dim = raw.shape
    spk_of_utt = np.asarray([spk_idx[utt2spk[u]] for u in utts], np.int32)
    spk_flat = np.repeat(spk_of_utt, t_max)
    sil_set = set(lang.silence_phone_ids)
    base_flat = raw.reshape(b * t_max, dim)  # host array; stats wrappers chunk it

    tids = np.zeros((b, t_max), np.int32)
    weights = np.zeros((b, t_max), np.float32)
    for i, u in enumerate(utts):
        a = prev_alignments.get(u) or []
        if a:
            tids[i, : len(a)] = a
            weights[i, : len(a)] = 1.0

    def fmllr_weights(tm):
        return silence_frame_weights(tids.reshape(-1), weights.reshape(-1),
                                     tm, sil_set, opts.silence_weight)

    # ---- initial transforms from the previous model ------------------------
    trans, impr = _estimate_transforms(
        prev_am, prev_trans_model, base_flat,
        jnp.asarray(prev_trans_model.tid2pdf[tids.reshape(-1)]),
        jnp.asarray(fmllr_weights(prev_trans_model)),
        jnp.asarray(spk_flat), num_spk, mesh=mesh)
    log.info("train_sat: initial fMLLR impr/frame %.4f (%d speakers)",
             impr, num_spk)
    feats = np.asarray(apply_fmllr_batch(jnp.asarray(raw), trans, spk_of_utt))

    # ---- tree on adapted features -----------------------------------------
    feats_by_utt = {u: feats[i, : num_frames[i]] for i, u in enumerate(utts)}
    ali_by_utt = {u: list(tids[i, : num_frames[i]])
                  for i, u in enumerate(utts) if weights[i].sum() > 0}
    tree_stats = acc_tree_stats(ali_by_utt, feats_by_utt, prev_trans_model,
                                opts.context_width, opts.central_position,
                                ci_phones=sil_set, mesh=mesh)
    tree = build_tree(tree_stats, lang, opts.context_width,
                      opts.central_position, num_leaves=opts.num_leaves)
    trans_model = TransitionModel(lang.topo, tree)
    am = init_model_from_tree_stats(tree, tree_stats,
                                    min_variance=opts.min_variance)
    log.info("train_sat: tree has %d leaves; %d tids", tree.num_pdfs,
             trans_model.num_transition_ids)

    new_tids = np.zeros_like(tids)
    for i, u in enumerate(utts):
        a = prev_alignments.get(u) or []
        if a:
            conv = prev_trans_model.convert_alignment(
                a, trans_model, opts.context_width, opts.central_position)
            new_tids[i, : len(conv)] = conv
    tids = new_tids

    compiler = TrainingGraphCompiler(lang, tree, trans_model,
                                     opts.transition_scale, opts.self_loop_scale)
    fsts = compiler.compile_batch([transcripts[u] for u in utts])
    aset = AlignmentSet.from_fsts(fsts, trans_model)

    silence_pdfs = sorted({pdf for p in lang.silence_phone_ids
                           for c in range(lang.topo.num_pdf_classes(p))
                           for pdf in tree.possible_pdfs(p, c)})
    num_gauss = am.num_gauss
    inc_gauss = max((opts.totgauss - num_gauss) // opts.max_iter_inc, 0)

    for it in range(1, opts.num_iters + 1):
        if it in opts.fmllr_iters:
            trans, impr = _estimate_transforms(
                am, trans_model, base_flat,
                jnp.asarray(trans_model.tid2pdf[tids.reshape(-1)]),
                jnp.asarray(fmllr_weights(trans_model)),
                jnp.asarray(spk_flat), num_spk, mesh=mesh)
            feats = np.asarray(apply_fmllr_batch(jnp.asarray(raw), trans,
                                                 spk_of_utt))
            log.info("train_sat iter %d: fMLLR impr/frame %.4f", it, impr)
        if it in opts.realign_iters:
            align_am = (am.boost_silence(silence_pdfs, opts.boost_silence)
                        if opts.boost_silence != 1.0 else am)
            results = aset.align_feats(K.pack_gmm(align_am), feats, num_frames,
                                       acoustic_scale=opts.acoustic_scale)
            apply_alignments(results, tids, weights, num_frames,
                             "train_sat realign", names=utts)

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
        if it <= opts.max_iter_inc:
            num_gauss += inc_gauss
        am.mle_update(occ, np.asarray(macc), np.asarray(vacc),
                      opts.min_gaussian_occupancy, opts.min_variance)
        am.split_to_target(num_gauss, occ, power=opts.power, seed=3000 + it)
        trans_model.mle_update(np.asarray(tstats))
        if it % 5 == 0 or it == opts.num_iters:
            log.info("train_sat iter %d: loglike/frame %.4f, num_gauss %d",
                     it, float(ll) / max(float(weights.sum()), 1.0), am.num_gauss)

    # ---- speaker-independent alignment model (gmm-acc-stats-twofeats) ------
    # posteriors from adapted features/current model, stats over base features
    params = K.pack_gmm(am)
    x_adapted = feats.reshape(b * t_max, dim)
    pdfs = trans_model.tid2pdf[tids.reshape(-1)]
    wflat = weights.reshape(-1)
    occ2, macc2, vacc2, _ll2 = K.acc_gmm_stats_twofeats_chunked(
        params, x_adapted, base_flat, pdfs, tree.num_pdfs, wflat)
    alimdl = AmDiagGmm(am.means_invvars.copy(), am.inv_vars.copy(),
                       am.weights.copy())
    alimdl.mle_update(occ2, macc2, vacc2,
                      opts.min_gaussian_occupancy, opts.min_variance)

    model = TrainedModel(am, trans_model, tree, lang)
    if out_dir:
        out = Path(out_dir)
        save_model(out, am, trans_model, tree)
        alimdl.save(out / "final.alimdl.npz")
    return SatModel(model=model, alimdl=alimdl,
                    transforms={s: trans[spk_idx[s]] for s in speakers})
