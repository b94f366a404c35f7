"""fMLLR (CMLLR) speaker-adaptation transforms.

Counterparts: ``gmm-est-fmllr{,-gpost}`` / ``gmm-post-to-gpost`` and the
row-by-row solve in ``transform/fmllr-diag-gmm.{h,cc}:43-61``; pipeline use in
train_sat.cpp and decode_fmllr.cpp (SURVEY.md §2.1/§3.2).

Per-speaker sufficient statistics (device, one pass over all speakers via
segment-sums over a speaker-id vector):

    beta_s          = sum gamma
    K_s[d, e]       = sum gamma * mu_d / var_d * xhat_e        (xhat = [x; 1])
    G_s[d, e, f]    = sum gamma / var_d * xhat_e * xhat_f

Estimation (host, per speaker): iterative row update of the affine transform
W [D, D+1] maximizing  beta log|det A| - 0.5 sum_d (w_d G_d w_d^T - 2 w_d K_d)
(FmllrInnerUpdate).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gmm_kernels import GmmParams, aligned_mixture_logliks


@jax.jit
def _fmllr_frame_stats(params: GmmParams, means, inv_vars, feats, pdf_ids,
                       weights):
    """Per-frame collapsed stats for one chunk: [N, D] w_miv / w_iv +
    per-frame gamma mass (everything downstream is matmuls)."""
    sel = aligned_mixture_logliks(params, feats, pdf_ids)  # [N, M]
    gamma = jax.nn.softmax(sel, axis=1) * weights[:, None]  # [N, M]
    mu = means[pdf_ids]  # [N, M, D]
    iv = inv_vars[pdf_ids]
    w_miv = jnp.einsum("nm,nmd->nd", gamma, mu * iv,
                       precision=jax.lax.Precision.HIGHEST)
    w_iv = jnp.einsum("nm,nmd->nd", gamma, iv,
                      precision=jax.lax.Precision.HIGHEST)
    return jnp.sum(gamma, axis=1), w_miv, w_iv


@jax.jit
def _fmllr_reduce_one(gmass, w_miv, w_iv, feats):
    """One speaker-chunk's (beta, K [D, D+1], G [D, D+1, D+1]): matmul-shaped
    contractions that never materialize an [N, D, E, E] intermediate (the
    naive per-frame outer-product segment-sum is hundreds of GB at corpus
    scale)."""
    n = feats.shape[0]
    xhat = jnp.concatenate([feats, jnp.ones((n, 1), feats.dtype)], axis=1)
    beta = jnp.sum(gmass)
    k = jnp.einsum("nd,ne->de", w_miv, xhat,
                   precision=jax.lax.Precision.HIGHEST)
    y = w_iv[:, :, None] * xhat[:, None, :]  # [N, D, E]
    g = jnp.einsum("nde,nf->def", y, xhat,
                   precision=jax.lax.Precision.HIGHEST)
    return beta, k, g


def acc_fmllr_stats(params: GmmParams, means: jnp.ndarray, inv_vars: jnp.ndarray,
                    feats: jnp.ndarray, pdf_ids: jnp.ndarray,
                    weights: jnp.ndarray, spk_ids: jnp.ndarray,
                    num_speakers: int, chunk: int = 1 << 14, mesh=None):
    """feats [N, D]; spk_ids [N] -> (beta [S], K [S, D, D+1], G [S, D, D+1, D+1]).

    Host wrapper: frames are grouped per speaker and processed in fixed-size
    padded chunks so device intermediates stay bounded at corpus scale
    (FmllrDiagGmmAccs role, ``transform/fmllr-diag-gmm.h:43-61``).

    With ``mesh`` set, speaker-major frame slabs are sharded over the data
    axis and the per-speaker stats psum-reduced
    (parallel/mesh.acc_fmllr_stats_sharded) — the reference's per-job fMLLR
    acc files composed per speaker (``train_sat.cpp:906-954``) as one
    collective."""
    feats = np.asarray(feats, np.float32)
    pdf_ids = np.asarray(pdf_ids, np.int32)
    weights = np.asarray(weights, np.float32)
    spk_ids = np.asarray(spk_ids, np.int32)
    n, d = feats.shape
    order = np.argsort(spk_ids, kind="stable")
    sorted_spk = spk_ids[order]
    starts = np.searchsorted(sorted_spk, np.arange(num_speakers + 1))
    if mesh is not None:
        return _acc_fmllr_stats_mesh(params, means, inv_vars, feats, pdf_ids,
                                     weights, order, starts, num_speakers,
                                     mesh)
    c = min(chunk, 1 << max(12, (max(n, 2) - 1).bit_length()))
    beta = np.zeros(num_speakers, np.float64)
    k = np.zeros((num_speakers, d, d + 1), np.float64)
    g = np.zeros((num_speakers, d, d + 1, d + 1), np.float64)
    for s in range(num_speakers):
        span = order[starts[s]: starts[s + 1]]
        for lo in range(0, len(span), c):
            idx = span[lo: lo + c]
            real = len(idx)
            if real < c:
                idx = np.concatenate(
                    [idx, np.full(c - real, idx[0], np.int64)])
            w_c = weights[idx].copy()
            w_c[real:] = 0.0
            x_c = jnp.asarray(feats[idx])
            gmass, w_miv, w_iv = _fmllr_frame_stats(
                params, means, inv_vars, x_c,
                jnp.asarray(pdf_ids[idx]), jnp.asarray(w_c))
            b_c, k_c, g_c = _fmllr_reduce_one(gmass, w_miv, w_iv, x_c)
            beta[s] += float(b_c)
            k[s] += np.asarray(k_c, np.float64)
            g[s] += np.asarray(g_c, np.float64)
    return (jnp.asarray(beta.astype(np.float32)),
            jnp.asarray(k.astype(np.float32)),
            jnp.asarray(g.astype(np.float32)))


def _acc_fmllr_stats_mesh(params, means, inv_vars, feats, pdf_ids, weights,
                          order, starts, num_speakers: int, mesh,
                          t_slab: int = 1024):
    """Speaker-major slab packing for the mesh-sharded fMLLR accumulator:
    each speaker's frames are cut into rows of ``t_slab`` frames (zero
    weight on padding), rows are padded to the data-axis size and tagged
    with their speaker slot; the sharded program vmaps the per-row
    contraction and segment-sums rows into disjoint speaker slots before
    the psum (P4 speaker-affinity: rows stay speaker-contiguous)."""
    from ..parallel.mesh import DATA_AXIS, acc_fmllr_stats_sharded

    d = feats.shape[1]
    rows = []
    for s in range(num_speakers):
        span = order[starts[s]: starts[s + 1]]
        for lo in range(0, max(len(span), 1), t_slab):
            rows.append((s, span[lo: lo + t_slab]))
    nd = mesh.shape[DATA_AXIS]
    # pad the row count to a power-of-two multiple of the axis so repeated
    # calls share a handful of compiled shapes
    n_rows = max(nd, 1 << (len(rows) - 1).bit_length())
    n_rows = -(-n_rows // nd) * nd
    f_r = np.zeros((n_rows, t_slab, d), np.float32)
    p_r = np.zeros((n_rows, t_slab), np.int32)
    w_r = np.zeros((n_rows, t_slab), np.float32)
    slot_r = np.zeros(n_rows, np.int32)
    for i, (s, idx) in enumerate(rows):
        f_r[i, : len(idx)] = feats[idx]
        p_r[i, : len(idx)] = pdf_ids[idx]
        w_r[i, : len(idx)] = weights[idx]
        slot_r[i] = s
    acc = acc_fmllr_stats_sharded(mesh, num_speakers)
    return acc(params, jnp.asarray(means), jnp.asarray(inv_vars),
               f_r, p_r, w_r, slot_r)


def estimate_fmllr(beta: float, k: np.ndarray, g: np.ndarray,
                   num_iters: int = 20, min_count: float = 500.0):
    """Solve one speaker's transform (row-wise quadratic maximization with
    cofactors — FmllrInnerUpdate).  Returns (W [D, D+1], objf impr/frame) or
    (identity, 0.0) when below min_count (reference --fmllr-min-count).
    Thin wrapper over the speaker-batched solver."""
    w, imprs = estimate_fmllr_batch(np.asarray([beta]), k[None], g[None],
                                    min_count=min_count, num_iters=num_iters)
    return w[0], imprs[0]


def estimate_fmllr_batch(beta: np.ndarray, k: np.ndarray, g: np.ndarray,
                         min_count: float = 500.0, num_iters: int = 20):
    """All speakers at once, vectorized over the speaker axis (the
    reference's per-speaker job loop becomes batched [S, D, ...] linear
    algebra).  Returns (transforms [S, D, D+1], impr list).  Speakers below
    ``min_count`` keep the identity transform."""
    s_num, d = k.shape[0], k.shape[1]
    ident = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    if s_num == 0:
        return np.zeros((0, d, d + 1), np.float32), []
    beta = beta.astype(np.float64)
    k = k.astype(np.float64)
    g = g.astype(np.float64)
    active = beta >= min_count
    w = np.broadcast_to(ident, (s_num, d, d + 1)).copy()
    if not active.any():
        return w.astype(np.float32), [0.0] * s_num

    # regularized per-row G inverses: [S, D, D+1, D+1]
    tr = np.einsum("sdii->sd", g) / (d + 1)
    reg = 1e-5 * np.maximum(tr, 1e-10)[:, :, None, None] * np.eye(d + 1)
    ginv = np.linalg.inv(g + reg)
    gk = np.einsum("sdef,sdf->sde", ginv, k)  # [S, D, D+1]

    def objf(ww):
        a = ww[:, :, :d]
        sign, logdet = np.linalg.slogdet(a)
        quad = np.einsum("sde,sde->s", ww, k) \
            - 0.5 * np.einsum("sde,sdef,sdf->s", ww, g, ww)
        val = beta * np.where(sign > 0, logdet, -np.inf) + quad
        return np.where(active, val, 0.0)

    start = objf(w)
    prev = start
    for _ in range(num_iters):
        for i in range(d):
            a = w[:, :, :d]  # [S, D, D]
            inv_t = np.linalg.inv(a).transpose(0, 2, 1)
            cof = np.linalg.det(a)[:, None] * inv_t[:, i]  # [S, D]
            chat = np.concatenate([cof, np.zeros((s_num, 1))], axis=1)
            gc = np.einsum("sef,sf->se", ginv[:, i], chat)  # [S, D+1]
            c1 = np.einsum("se,se->s", chat, gc)
            c2 = np.einsum("se,se->s", chat, gk[:, i])
            ok = active & (c1 > 0)
            disc = np.maximum(c2 * c2 + 4.0 * beta * c1, 0.0)
            step = (-c2 + np.sqrt(disc)) / np.maximum(2.0 * c1, 1e-20)
            new_row = gk[:, i] + step[:, None] * gc
            w[:, i] = np.where(ok[:, None], new_row, w[:, i])
        cur = objf(w)
        if np.all(cur - prev < 1e-6 * np.maximum(np.abs(prev), 1.0)):
            prev = cur
            break
        prev = cur
    imprs = [float((prev[s] - start[s]) / max(beta[s], 1.0)) if active[s] else 0.0
             for s in range(s_num)]
    return w.astype(np.float32), imprs


def apply_fmllr_batch(feats: jnp.ndarray, transforms: np.ndarray,
                      spk_ids: np.ndarray) -> jnp.ndarray:
    """feats [B, T, D] with per-speaker affine transforms gathered by spk."""
    w = jnp.asarray(transforms)[jnp.asarray(spk_ids)]  # [B, D, D+1]
    a = w[:, :, :-1]
    b = w[:, :, -1]
    return jnp.einsum("bde,bte->btd", a, feats,
                      precision=jax.lax.Precision.HIGHEST) + b[:, None, :]
