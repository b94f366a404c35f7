"""Flat-start monophone GMM training (EM with Viterbi realignment).

Counterpart of the reference's ``TrainGmmMono``
(``scr/steps/train_gmm_mono.cpp:52-774``; full call trace SURVEY.md §3.1):

    flat start (global mean/var)  ->  graphs  ->  equal alignment pass-0  ->
    EM loop: [realign on schedule] -> E-step stats -> M-step + mixup

Batched re-design: the reference's nj-thread/ark-file sharding becomes one padded
device batch — alignment is a single batched Viterbi scan, E-step statistics
are segment-sums, and the per-job accumulator files + ``GmmSumAccs`` barrier
become a ``psum`` over the data mesh axis when sharded (SURVEY.md §2.6 P1/P2).
The M-step / mixup run host-side between iterations (tiny arrays).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import jax.numpy as jnp
import numpy as np

from ..config import MonoTrainOptions
from ..data.lang import Lang
from ..fst.hclg import TrainingGraphCompiler
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..models.tree import MonophoneTree
from ..ops import gmm_kernels as K
from ..utils.logging import get_logger
from .align import AlignmentSet, apply_alignments, equal_align

log = get_logger()


@dataclass
class TrainedModel:
    am: AmDiagGmm
    trans_model: TransitionModel
    tree: object
    lang: Lang


def make_mono_tree(lang: Lang, shared_phones: list[list[int]] | None = None) -> MonophoneTree:
    pdf_classes = {p: lang.topo.num_emitting_states(p) for p in lang.topo.phones()}
    if shared_phones is None:
        shared_phones = [[p] for p in sorted(pdf_classes)]
    return MonophoneTree(shared_phones, pdf_classes)


def _batchify(feats_list: list[np.ndarray]):
    b = len(feats_list)
    t_max = max(f.shape[0] for f in feats_list)
    d = feats_list[0].shape[1]
    out = np.zeros((b, t_max, d), np.float32)
    nf = np.zeros(b, np.int32)
    for i, f in enumerate(feats_list):
        out[i, : f.shape[0]] = f
        nf[i] = f.shape[0]
    return out, nf


def train_mono(feats_by_utt: dict[str, np.ndarray],
               transcripts: dict[str, list[int]],
               lang: Lang,
               opts: MonoTrainOptions = MonoTrainOptions(),
               out_dir: str | Path | None = None,
               checkpoint_every: int = 0,
               resume: bool = True) -> TrainedModel:
    """``feats_by_utt``: utt -> [T, D] final features (CMVN+deltas applied);
    ``transcripts``: utt -> word-id sequence.

    With ``checkpoint_every > 0`` and an ``out_dir``, per-iteration state is
    checkpointed (SURVEY.md §5.4 role of 0.mdl..40.mdl) and training resumes
    from the latest checkpoint when re-invoked (``resume=True``)."""
    utts = sorted(feats_by_utt)
    feats_list = [feats_by_utt[u] for u in utts]
    feats, num_frames = _batchify(feats_list)
    b, t_max, dim = feats.shape

    # ---- flat start (STAGE -3): global mean/var over (a subset of) frames --
    tree = make_mono_tree(lang)
    trans_model = TransitionModel(lang.topo, tree)
    all_frames = np.concatenate([f for f in feats_list], axis=0)
    glob_mean = all_frames.mean(axis=0)
    glob_var = all_frames.var(axis=0)
    am = AmDiagGmm.flat_start(tree.num_pdfs, glob_mean, glob_var)
    log.info("train_mono: %d utts, dim=%d, %d pdfs, %d tids", b, dim,
             tree.num_pdfs, trans_model.num_transition_ids)

    # ---- training graphs (STAGE -2) ---------------------------------------
    compiler = TrainingGraphCompiler(lang, tree, trans_model,
                                     opts.transition_scale, opts.self_loop_scale)
    fsts = compiler.compile_batch([transcripts[u] for u in utts])
    aset = AlignmentSet.from_fsts(fsts, trans_model)
    log.info("train_mono: graphs compiled (max states=%d, max arcs=%d)",
             max(g.num_states for g in aset.graphs),
             max(g.num_arcs for g in aset.graphs))

    # ---- pass-0 equal alignment (STAGE -1) --------------------------------
    tids = np.zeros((b, t_max), np.int32)
    weights = np.zeros((b, t_max), np.float32)
    n_fail = 0
    for i, g in enumerate(aset.graphs):
        fr = equal_align(g, int(num_frames[i]), seed=i)
        if fr is None:
            n_fail += 1
            continue
        tids[i, : num_frames[i]] = g.arc_tid[fr]
        weights[i, : num_frames[i]] = 1.0
    if n_fail:
        log.warning("train_mono: %d utterances failed equal alignment", n_fail)

    def accumulate(tids_flat, weights_flat):
        params = K.pack_gmm(am)
        x = feats.reshape(b * t_max, dim)
        pdfs = trans_model.tid2pdf[tids_flat]
        occ, macc, vacc, ll = K.acc_gmm_stats_chunked(
            params, x, pdfs, tree.num_pdfs, weights_flat)
        tstats = K.acc_transition_stats(jnp.asarray(tids_flat),
                                        trans_model.num_transition_ids,
                                        jnp.asarray(weights_flat))
        return occ, macc, vacc, np.asarray(tstats), ll

    # ---- STAGE 0: first estimate from equal alignment ----------------------
    occ, macc, vacc, tstats, ll = accumulate(tids.reshape(-1), weights.reshape(-1))
    am.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy, opts.min_variance)
    trans_model.mle_update(tstats)
    tot_frames = float(weights.sum())
    log.info("train_mono iter 0: loglike/frame %.4f", ll / max(tot_frames, 1))

    num_gauss = am.num_gauss
    inc_gauss = (opts.totgauss - num_gauss) // opts.max_iter_inc

    silence_pdfs = sorted({tree.map_mono(p, c)
                           for p in lang.silence_phone_ids
                           for c in range(lang.topo.num_pdf_classes(p))})

    # ---- checkpoint/resume -------------------------------------------------
    ckpt = None
    start_it = 1
    if out_dir and checkpoint_every:
        from ..utils.checkpoint import TrainCheckpoint

        ckpt = TrainCheckpoint(Path(out_dir) / "checkpoints")
        if resume:
            state = ckpt.latest()
            if state is not None:
                am = state["am"]
                trans_model.log_probs = state["trans_log_probs"]
                tids = state["tids"]
                weights = state["weights"]
                num_gauss = state["meta"].get("num_gauss_target", num_gauss)
                start_it = state["iteration"] + 1
                log.info("train_mono: resumed from iteration %d",
                         state["iteration"])

    # ---- EM loop -----------------------------------------------------------
    for it in range(start_it, opts.num_iters + 1):
        if it in opts.realign_iters:
            align_am = (am.boost_silence(silence_pdfs, opts.boost_silence)
                        if opts.boost_silence != 1.0 else am)
            # exact Viterbi (no pruning): graphs are small; the reference's
            # beam/retry_beam machinery only bounds token-passing cost on CPU
            results = aset.align_feats(K.pack_gmm(align_am), feats, num_frames,
                                       acoustic_scale=opts.acoustic_scale,
                                       beam=1e9)
            apply_alignments(results, tids, weights, num_frames,
                             "train_mono realign", names=utts)

        occ, macc, vacc, tstats, ll = accumulate(tids.reshape(-1),
                                                 weights.reshape(-1))
        if it <= opts.max_iter_inc:
            num_gauss += inc_gauss
        am.mle_update(occ, macc, vacc, opts.min_gaussian_occupancy,
                      opts.min_variance)
        am.split_to_target(num_gauss, occ, power=opts.power,
                           perturb_factor=opts.perturb_factor, seed=it)
        trans_model.mle_update(tstats)
        if it % 5 == 0 or it == opts.num_iters:
            log.info("train_mono iter %d: loglike/frame %.4f, num_gauss %d",
                     it, ll / max(float(weights.sum()), 1), am.num_gauss)
        if ckpt is not None and it % checkpoint_every == 0:
            ckpt.save(it, am, trans_model.log_probs, tids, weights,
                      {"num_gauss_target": num_gauss})

    model = TrainedModel(am, trans_model, tree, lang)
    if out_dir:
        save_model(Path(out_dir), am, trans_model, tree)
    return model


def save_model(out_dir: Path, am: AmDiagGmm, trans_model: TransitionModel,
               tree, iteration: int | None = None) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    suffix = f".{iteration}" if iteration is not None else ""
    am.save(out_dir / f"final{suffix}.am.npz")
    trans_model.save(out_dir / f"final{suffix}.tm.json")
    tree.save(out_dir / f"tree{suffix}.json")
