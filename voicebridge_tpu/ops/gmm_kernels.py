"""Batched diagonal-GMM log-likelihood and EM statistics on the device.

The acoustic hot kernel of the whole framework (reference:
``DecodableAmDiagGmmScaled::LogLikelihoodZeroBased``,
``gmm/decodable-am-diag-gmm.cc:28-64``): per (frame, pdf)

    loglike = logsumexp_m( gconst[p,m] + miv[p,m]·x - 0.5·iv[p,m]·x² )

Batched formulation: with x' = [x, x²] (``[N, 2D]``) and
W = [miv; -0.5·iv] flattened to ``[P·M, 2D]``, all scores for all pdfs are ONE
``[N, 2D] @ [2D, P·M]`` matmul + gconst bias + masked logsumexp over the
mixture axis — no per-frame loop, no per-pdf loop.  E-step sufficient
statistics are segment-sums over the Viterbi-aligned pdf ids (replacing the
reference's per-job accumulator files + GmmSumAccs with one ``segment_sum`` +
``psum``, SURVEY.md §2.6 P2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.gmm import AmDiagGmm


class GmmParams(NamedTuple):
    """Device-resident GMM parameters (a pytree; shard or replicate freely).
    Sizes (P, M, D) are derived from array shapes so the tuple stays a pure
    array pytree (jit-friendly)."""

    w_matrix: jnp.ndarray  # [2D, P*M]  = [miv; -0.5*iv] transposed
    gconsts: jnp.ndarray  # [P, M], -1e30 padding for inactive components

    @property
    def num_pdfs(self) -> int:
        return self.gconsts.shape[0]

    @property
    def max_mix(self) -> int:
        return self.gconsts.shape[1]

    @property
    def dim(self) -> int:
        return self.w_matrix.shape[0] // 2


def pack_gmm(am: AmDiagGmm) -> GmmParams:
    p, m, d = am.num_pdfs, am.max_mix, am.dim
    w = np.concatenate([am.means_invvars, -0.5 * am.inv_vars], axis=2)  # [P,M,2D]
    w = w.reshape(p * m, 2 * d).T.astype(np.float32)  # [2D, P*M]
    gc = np.where(np.isfinite(am.gconsts), am.gconsts, -1e30).astype(np.float32)
    return GmmParams(jnp.asarray(w), jnp.asarray(gc))


def _expand(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([x, x * x], axis=-1)  # [N, 2D]


def component_logliks(params: GmmParams, x: jnp.ndarray) -> jnp.ndarray:
    """``[N, D] -> [N, P, M]`` per-component log-likelihoods."""
    n = x.shape[0]
    scores = jnp.dot(_expand(x), params.w_matrix,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)  # [N, P*M]
    return scores.reshape(n, params.num_pdfs, params.max_mix) + params.gconsts[None]


def loglikes(params: GmmParams, x: jnp.ndarray) -> jnp.ndarray:
    """``[N, D] -> [N, P]`` total per-pdf log-likelihoods (the decoder input)."""
    comp = component_logliks(params, x)
    return jax.scipy.special.logsumexp(comp, axis=2)


@jax.jit
def loglikes_batch(params: GmmParams, feats: jnp.ndarray) -> jnp.ndarray:
    """``[B, T, D] -> [B, T, P]`` (jitted: one program, no eager op-by-op
    dispatch)."""
    b, t, d = feats.shape
    return loglikes(params, feats.reshape(b * t, d)).reshape(b, t, params.num_pdfs)


# ---------------------------------------------------------------------------
# E-step statistics from a hard (Viterbi) alignment
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(3,))
def acc_gmm_stats(params: GmmParams, x: jnp.ndarray, pdf_ids: jnp.ndarray,
                  num_pdfs: int, frame_weights: jnp.ndarray | None = None):
    """Accumulate GMM sufficient statistics for aligned frames.

    x: ``[N, D]`` frames; pdf_ids: ``[N]`` aligned pdf per frame (padding frames
    must carry weight 0 via ``frame_weights``).  Returns (occ ``[P, M]``,
    mean_acc ``[P, M, D]``, var_acc ``[P, M, D]``) — the content of the
    reference's ``AccumAmDiagGmm`` (``gmm/mle-am-diag-gmm.h:34``).
    """
    comp = component_logliks(params, x)  # [N, P, M]
    sel = jnp.take_along_axis(comp, pdf_ids[:, None, None], axis=1)[:, 0, :]  # [N, M]
    gamma = jax.nn.softmax(sel, axis=1)  # [N, M] mixture posteriors
    if frame_weights is not None:
        gamma = gamma * frame_weights[:, None]
    occ = jax.ops.segment_sum(gamma, pdf_ids, num_pdfs)  # [P, M]
    gx = gamma[:, :, None] * x[:, None, :]  # [N, M, D]
    mean_acc = jax.ops.segment_sum(gx, pdf_ids, num_pdfs)  # [P, M, D]
    var_acc = jax.ops.segment_sum(gx * x[:, None, :], pdf_ids, num_pdfs)
    return occ, mean_acc, var_acc


def aligned_mixture_logliks(params: GmmParams, x: jnp.ndarray,
                            pdf_ids: jnp.ndarray) -> jnp.ndarray:
    """Per-frame component log-likelihoods of each frame's ALIGNED pdf only:
    ``[N, D], [N] -> [N, M]``.  Gathers [N, M, 2D] parameters instead of
    evaluating all pdfs ([N, P, M] blows up at real-corpus scale)."""
    p, m, d = params.num_pdfs, params.max_mix, params.dim
    wt = params.w_matrix.T.reshape(p, m, 2 * d)
    wsel = jnp.take(wt, pdf_ids, axis=0)  # [N, M, 2D]
    return jnp.einsum("nmd,nd->nm", wsel, _expand(x),
                      precision=jax.lax.Precision.HIGHEST) \
        + jnp.take(params.gconsts, pdf_ids, axis=0)


@functools.partial(jax.jit, static_argnums=(4,))
def acc_gmm_stats_aligned_twofeats(params: GmmParams, x_post: jnp.ndarray,
                                   x_acc: jnp.ndarray, pdf_ids: jnp.ndarray,
                                   num_pdfs: int, frame_weights: jnp.ndarray):
    """Aligned-pdf E-step stats with *separate* posterior / accumulation
    features (``gmm-acc-stats-twofeats``: posteriors from the adapted
    features, statistics over the base features).  Gathers ONLY each frame's
    aligned pdf's component parameters ([N, M, 2D]) instead of evaluating all
    pdfs ([N, P, M] — several GB at real-corpus scale).

    Returns (occ [P, M], mean_acc [P, M, D], var_acc [P, M, D], ll scalar).
    """
    sel = aligned_mixture_logliks(params, x_post, pdf_ids)  # [N, M]
    ll = jnp.sum(jax.scipy.special.logsumexp(sel, axis=1) * frame_weights)
    gamma = jax.nn.softmax(sel, axis=1) * frame_weights[:, None]
    occ = jax.ops.segment_sum(gamma, pdf_ids, num_pdfs)
    gx = gamma[:, :, None] * x_acc[:, None, :]
    mean_acc = jax.ops.segment_sum(gx, pdf_ids, num_pdfs)
    var_acc = jax.ops.segment_sum(gx * x_acc[:, None, :], pdf_ids, num_pdfs)
    return occ, mean_acc, var_acc, ll


def acc_gmm_stats_aligned(params: GmmParams, x: jnp.ndarray,
                          pdf_ids: jnp.ndarray, num_pdfs: int,
                          frame_weights: jnp.ndarray):
    """Single-feature variant of :func:`acc_gmm_stats_aligned_twofeats`
    (the common ``gmm-acc-stats-ali`` path)."""
    return acc_gmm_stats_aligned_twofeats(params, x, x, pdf_ids, num_pdfs,
                                          frame_weights)


def acc_gmm_stats_twofeats_chunked(params: GmmParams, x_post, x_acc, pdf_ids,
                                   num_pdfs: int, frame_weights=None,
                                   chunk: int = 1 << 18):
    """Host wrapper over :func:`acc_gmm_stats_aligned_twofeats`: fixed-size
    frame chunks (zero-weight padded tail) so device residents stay bounded
    and the jit cache sees one shape per training run.  Returns np arrays +
    float ll."""
    x_post = np.asarray(x_post, np.float32)
    x_acc = np.asarray(x_acc, np.float32)
    n = x_post.shape[0]
    pdf_ids = np.asarray(pdf_ids, np.int32)
    w = (np.ones(n, np.float32) if frame_weights is None
         else np.asarray(frame_weights, np.float32))
    c = min(chunk, 1 << max(12, (n - 1).bit_length()))
    p, m, d = num_pdfs, params.max_mix, params.dim
    occ = np.zeros((p, m), np.float64)
    macc = np.zeros((p, m, d), np.float64)
    vacc = np.zeros((p, m, d), np.float64)
    ll = 0.0

    def padded(a, lo, hi, width=None):
        if hi - lo == c:
            return a[lo:hi]
        out = np.zeros((c,) + a.shape[1:], a.dtype)
        out[: hi - lo] = a[lo:hi]
        return out

    for lo in range(0, n, c):
        hi = min(n, lo + c)
        o, ma, va, l = acc_gmm_stats_aligned_twofeats(
            params, jnp.asarray(padded(x_post, lo, hi)),
            jnp.asarray(padded(x_acc, lo, hi)),
            jnp.asarray(padded(pdf_ids, lo, hi)), num_pdfs,
            jnp.asarray(padded(w, lo, hi)))
        occ += np.asarray(o, np.float64)
        macc += np.asarray(ma, np.float64)
        vacc += np.asarray(va, np.float64)
        ll += float(l)
    return (occ.astype(np.float32), macc.astype(np.float32),
            vacc.astype(np.float32), ll)


def acc_gmm_stats_chunked(params: GmmParams, x, pdf_ids, num_pdfs: int,
                          frame_weights=None, chunk: int = 1 << 18):
    """Single-feature chunked E-step stats (``gmm-acc-stats-ali`` at scale)."""
    return acc_gmm_stats_twofeats_chunked(params, x, x, pdf_ids, num_pdfs,
                                          frame_weights, chunk)


def acc_transition_stats(tids: jnp.ndarray, num_tids: int,
                         frame_weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Transition-id occupancies from alignment (``[N]`` -> ``[num_tids+1]``)."""
    w = frame_weights if frame_weights is not None else jnp.ones_like(tids, jnp.float32)
    return jax.ops.segment_sum(w, tids, num_tids + 1)


def aligned_loglike(params: GmmParams, x: jnp.ndarray, pdf_ids: jnp.ndarray,
                    frame_weights: jnp.ndarray | None = None) -> jnp.ndarray:
    """Total data log-likelihood of an alignment (for EM monitoring)."""
    comp = component_logliks(params, x)
    sel = jnp.take_along_axis(comp, pdf_ids[:, None, None], axis=1)[:, 0, :]
    ll = jax.scipy.special.logsumexp(sel, axis=1)
    if frame_weights is not None:
        ll = ll * frame_weights
    return jnp.sum(ll)
