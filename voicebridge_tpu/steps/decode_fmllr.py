"""Two-pass speaker-adapted decoding (fMLLR) from lattice posteriors.

Counterpart of the reference's ``DecodeFmllr`` (``scr/steps/decode_fmllr.cpp``,
1 299 LoC; stage trace SURVEY.md §2.1):

  (0) speaker-independent first pass with ``final.alimdl`` into lattices;
  (1) per-speaker fMLLR from SI-lattice posteriors
      (``LatticeToPost -> WeightSilencePost -> GmmPostToGpost ->
      GmmEstFmllrGpost``, decode_fmllr.cpp:314-383);
  (2) adapted lattice decode with ``final.mdl`` (:405-458);
  (3) second fMLLR estimate from the adapted lattices (:491-...) — estimated
      directly as the TOTAL transform on base features (same fixed point as
      the reference's delta-transform + ComposeTransforms);
  (4) final rescoring of the adapted-pass lattices with the final features
      (``GmmRescoreLattice``, :583-640) and best-path extraction.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import FmllrDecodeOptions
from ..data.lang import Lang
from ..fst.core import Fst
from ..lat import lattice_best_path, lattice_to_post
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..transforms.fmllr import (acc_fmllr_stats, apply_fmllr_batch,
                                estimate_fmllr_batch)
from ..ops import gmm_kernels as K
from ..steps.decode import Decoder, DecodeResult
from ..utils.logging import get_logger

log = get_logger()

K_POST = 4  # posterior entries kept per frame (lattice posteriors are peaky)


def decode_fmllr(hclg: Fst, trans_model: TransitionModel, am: AmDiagGmm,
                 alimdl: AmDiagGmm, lang: Lang, utts: list, feats: np.ndarray,
                 num_frames: np.ndarray, utt2spk: dict,
                 opts: FmllrDecodeOptions = FmllrDecodeOptions(), mesh=None):
    """Returns (results list[DecodeResult], transforms [S, D, D+1]).

    ``mesh``: optional jax.sharding.Mesh — routes both fMLLR statistics
    passes through the data-axis-sharded psum accumulator (SURVEY §2.6
    P2; parallel/mesh.py)."""
    b, t_max, dim = feats.shape
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    spk_of_utt = np.asarray([spk_idx[utt2spk[u]] for u in utts], np.int32)
    spk_flat = np.repeat(np.repeat(spk_of_utt, t_max), K_POST)
    sil_set = set(lang.silence_phone_ids)
    base_rep = feats.reshape(b * t_max, dim)[
        np.repeat(np.arange(b * t_max), K_POST)]  # host: [N*K, D]

    def lattice_posteriors(lats):
        """Per-frame top-K (pdf, weight) from lattice posteriors, silence
        down-weighted (WeightSilencePost role)."""
        pdf = np.zeros((b, t_max, K_POST), np.int32)
        w = np.zeros((b, t_max, K_POST), np.float32)
        for i, u in enumerate(utts):
            lat = lats[u]
            if lat.num_arcs == 0:
                continue
            _ap, per_frame = lattice_to_post(
                lat, acoustic_scale=opts.acoustic_scale, min_post=0.01)
            for t, entries in enumerate(per_frame):
                entries = sorted(entries, key=lambda e: -e[2])[:K_POST]
                for kk, (tid, pdfk, p) in enumerate(entries):
                    sil = int(trans_model.tid2phone[tid]) in sil_set
                    pdf[i, t, kk] = pdfk
                    w[i, t, kk] = p * (opts.silence_weight if sil else 1.0)
        return pdf.reshape(-1), w.reshape(-1)

    def estimate(model, pdf_flat, wflat):
        params = K.pack_gmm(model)
        beta, k, g = acc_fmllr_stats(
            params, jnp.asarray(model.means()), jnp.asarray(model.inv_vars),
            base_rep, pdf_flat, wflat, spk_flat, len(speakers), mesh=mesh)
        trans, imprs = estimate_fmllr_batch(np.asarray(beta), np.asarray(k),
                                            np.asarray(g),
                                            min_count=opts.fmllr_min_count)
        return trans, imprs

    # ---- stage 0: SI lattice pass with alimdl -------------------------------
    si_dec = Decoder(hclg, trans_model, alimdl, _decode_opts(opts, first=True))
    si_lats = si_dec.decode_lattice(utts, feats, num_frames)

    # ---- stage 1: first transforms from SI-lattice posteriors ---------------
    pdf_flat, wflat = lattice_posteriors(si_lats)
    trans, _imprs = estimate(am, pdf_flat, wflat)
    log.info("decode_fmllr: pass-1 transforms for %d speakers", len(speakers))

    # ---- stage 2: adapted lattice decode ------------------------------------
    adapted = np.asarray(apply_fmllr_batch(jnp.asarray(feats), trans, spk_of_utt))
    ad_dec = Decoder(hclg, trans_model, am, _decode_opts(opts, first=False))
    ad_lats = ad_dec.decode_lattice(utts, adapted, num_frames)

    # ---- stage 3: second estimate from adapted lattices ---------------------
    pdf_flat, wflat = lattice_posteriors(ad_lats)
    trans2, _ = estimate(am, pdf_flat, wflat)
    adapted2 = np.asarray(apply_fmllr_batch(jnp.asarray(feats), trans2, spk_of_utt))

    # ---- stage 4: rescore + true pruned determinization ---------------------
    # (GmmRescoreLattice -> LatticeDeterminizePruned, decode_fmllr.cpp:583-640)
    from dataclasses import replace as _dc_replace

    from ..lat import determinize_lattice_pruned_safe
    from .decode import Decoder as _D

    results = []
    num_pdfs = int(am.num_pdfs)
    g = ad_dec.graph
    # Rescoring needs ll2 only at each lattice's surviving (t, pdf): one
    # flat device gather per sub-batch moves ~2 MB where a full [B, T, P]
    # host copy would move ~450 MB (same design as Decoder._fill_ac).
    b_chunk = 64
    for lo in range(0, len(utts), b_chunk):
        hi = min(len(utts), lo + b_chunk)
        ll2_dev = K.loglikes_batch(ad_dec.params, jnp.asarray(adapted2[lo:hi]))
        lats_c = [ad_lats[u] for u in utts[lo:hi]]
        sizes = [lat.num_arcs for lat in lats_c]
        total = int(np.sum(sizes))
        idx = np.empty(max(total, 1), np.int64)
        o = 0
        for j, lat in enumerate(lats_c):
            pdfs = g.arc_pdf[lat.arc_id]
            idx[o: o + lat.num_arcs] = \
                (np.int64(j) * t_max + lat.arc_t.astype(np.int64)) \
                * num_pdfs + pdfs
            o += lat.num_arcs
        k_pad = max(1024, 1 << (max(total, 2) - 1).bit_length())
        idx_p = np.zeros(k_pad, np.int32)
        idx_p[:total] = idx[:total]
        ac = np.asarray(_D._ac_gather(ll2_dev, jnp.asarray(idx_p)))
        o = 0
        for u, lat, n in zip(utts[lo:hi], lats_c, sizes):
            lat2 = _dc_replace(lat, acoustic_cost=ac[o: o + n].copy(),
                               _states={})
            o += n
            clat = determinize_lattice_pruned_safe(
                lat2, beam=opts.lattice_beam, lm_scale=1.0,
                acoustic_scale=opts.acoustic_scale)
            p = clat.best_path(lm_scale=1.0,
                               acoustic_scale=opts.acoustic_scale)
            results.append(DecodeResult(u, p["words"], p["score"], p["tids"]))
    return results, trans2


def _decode_opts(opts: FmllrDecodeOptions, first: bool):
    from ..config import DecodeOptions

    return DecodeOptions(
        beam=opts.first_beam if first else opts.beam,
        max_active=opts.first_max_active if first else opts.max_active,
        acoustic_scale=opts.acoustic_scale,
        lattice_beam=opts.lattice_beam,
    )
