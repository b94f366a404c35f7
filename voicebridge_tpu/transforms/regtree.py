"""Regression-tree fMLLR / MLLR adaptation.

Counterpart of the reference's regression-tree transforms
(``transform/regression-tree.{h,cc}`` ``RegressionTree``,
``transform/regtree-fmllr-diag-gmm.{h,cc}`` ``RegtreeFmllrDiagGmm[Accs]``,
``transform/regtree-mllr-diag-gmm.{h,cc}``; SURVEY.md §2.3 transform row):
Gaussians are clustered into base classes by a binary tree over their means;
per-speaker statistics are accumulated per base class on device, and at
estimation time each leaf walks up the tree to the lowest ancestor with
enough occupancy, yielding one affine transform per *regression class* —
more data, more transforms; little data degrades gracefully to one global
transform.

Device design: the per-Gaussian posteriors and per-class sufficient statistics
are one batched einsum + segment reduction over frames (the class axis is
tiny); only the small per-class row solves run on the host, reusing the
speaker-batched fMLLR solver (``transforms/fmllr.py``).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.gmm_kernels import (GmmParams, aligned_mixture_logliks,
                               component_logliks)
from .fmllr import estimate_fmllr_batch


# ---------------------------------------------------------------------------
# Regression tree (host; built once per model)
# ---------------------------------------------------------------------------


@dataclass
class RegressionTree:
    """Binary tree over Gaussians. Leaves are base classes ``0..C-1``;
    ``parent[n]`` gives each node's parent (root's is -1). ``bclass_of``
    maps (pdf, mix) -> leaf id (-1 for padded/inactive components)."""

    bclass_of: np.ndarray      # [P, M] int32
    parent: np.ndarray         # [num_nodes] int32
    num_leaves: int

    @property
    def num_nodes(self) -> int:
        return len(self.parent)


def _two_means(x: np.ndarray, w: np.ndarray, iters: int = 10, seed: int = 0):
    """Weighted 2-means split; returns bool mask for cluster 1."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    c0 = x[int(rng.integers(n))]
    far = np.argmax(((x - c0) ** 2).sum(1))
    c1 = x[int(far)]
    assign = np.zeros(n, bool)
    for _ in range(iters):
        d0 = ((x - c0) ** 2).sum(1)
        d1 = ((x - c1) ** 2).sum(1)
        new = d1 < d0
        if (new == assign).all():
            break
        assign = new
        for side, mask in ((0, ~assign), (1, assign)):
            if mask.any():
                c = (w[mask, None] * x[mask]).sum(0) / w[mask].sum()
                if side == 0:
                    c0 = c
                else:
                    c1 = c
    if not assign.any() or assign.all():  # degenerate: split by median dim
        dim = np.argmax(x.var(0))
        assign = x[:, dim] > np.median(x[:, dim])
    return assign


def build_regression_tree(means: np.ndarray, weights: np.ndarray,
                          num_baseclasses: int, active: np.ndarray | None = None,
                          seed: int = 0) -> RegressionTree:
    """Top-down binary splitting of Gaussian means into ``num_baseclasses``
    leaves (``RegressionTree::BuildTree`` role: largest-occupancy node is
    split first).

    means [P, M, D], weights [P, M] (occupancy or mixture weights);
    ``active`` marks real (non-padded) components.
    """
    p, m, d = means.shape
    flat_mu = means.reshape(p * m, d).astype(np.float64)
    flat_w = weights.reshape(p * m).astype(np.float64)
    if active is None:
        active = flat_w > 0
    else:
        active = active.reshape(p * m).astype(bool)
    idx_active = np.nonzero(active)[0]
    num_baseclasses = max(1, min(num_baseclasses, len(idx_active)))

    # leaves as index lists; split the heaviest splittable leaf repeatedly
    leaves = [idx_active]
    while len(leaves) < num_baseclasses:
        order = np.argsort([-flat_w[leaf].sum() for leaf in leaves])
        split_at = next((i for i in order if len(leaves[int(i)]) > 1), None)
        if split_at is None:
            break
        leaf = leaves.pop(int(split_at))
        mask = _two_means(flat_mu[leaf], np.maximum(flat_w[leaf], 1e-8),
                          seed=seed + len(leaves))
        leaves.insert(int(split_at), leaf[~mask])
        leaves.append(leaf[mask])

    c = len(leaves)
    bclass = np.full(p * m, -1, np.int32)
    for li, leaf in enumerate(leaves):
        bclass[leaf] = li
    # build a balanced binary merge hierarchy over the leaves by re-merging
    # nearest centroids (parents get ids c, c+1, ...)
    cents = [((flat_w[leaf, None] * flat_mu[leaf]).sum(0) /
              max(flat_w[leaf].sum(), 1e-8)) for leaf in leaves]
    occs = [flat_w[leaf].sum() for leaf in leaves]
    nodes = list(range(c))
    parent = [-1] * c
    cur = {i: (cents[i], occs[i]) for i in range(c)}
    next_id = c
    while len(nodes) > 1:
        best = None
        for i in range(len(nodes)):
            for j in range(i + 1, len(nodes)):
                dist = float(((cur[nodes[i]][0] - cur[nodes[j]][0]) ** 2).sum())
                if best is None or dist < best[0]:
                    best = (dist, i, j)
        _, i, j = best
        a, b = nodes[i], nodes[j]
        parent.append(-1)
        parent[a] = next_id
        parent[b] = next_id
        wa, wb = cur[a][1], cur[b][1]
        cur[next_id] = ((cur[a][0] * wa + cur[b][0] * wb) / max(wa + wb, 1e-8),
                        wa + wb)
        nodes = [n for k, n in enumerate(nodes) if k not in (i, j)] + [next_id]
        next_id += 1
    return RegressionTree(bclass.reshape(p, m), np.asarray(parent, np.int32), c)


# ---------------------------------------------------------------------------
# Per-baseclass fMLLR statistics (device)
# ---------------------------------------------------------------------------


def acc_regtree_fmllr_stats(params: GmmParams, means: jnp.ndarray,
                            inv_vars: jnp.ndarray, feats: jnp.ndarray,
                            pdf_ids: jnp.ndarray, weights: jnp.ndarray,
                            bclass_of: jnp.ndarray, num_classes: int):
    """One speaker's per-baseclass stats
    (``RegtreeFmllrDiagGmmAccs::AccumulateForGmm`` role).

    feats [N, D] aligned to pdf_ids [N] with frame weights [N];
    bclass_of [P, M] -> (beta [C], K [C, D, D+1], G [C, D, D+1, D+1]).
    """
    n, d = feats.shape
    sel = aligned_mixture_logliks(params, feats, pdf_ids)  # [N, M]
    gamma = jax.nn.softmax(sel, axis=1) * weights[:, None]        # [N, M]
    cls = jnp.asarray(bclass_of)[pdf_ids]                          # [N, M]
    onehot = jax.nn.one_hot(cls, num_classes, dtype=feats.dtype)   # [N, M, C]
    mu = means[pdf_ids]                                            # [N, M, D]
    iv = inv_vars[pdf_ids]
    xhat = jnp.concatenate([feats, jnp.ones((n, 1), feats.dtype)], axis=1)
    hi = jax.lax.Precision.HIGHEST
    w_miv = jnp.einsum("nm,nmc,nmd->ncd", gamma, onehot, mu * iv,
                       precision=hi)
    w_iv = jnp.einsum("nm,nmc,nmd->ncd", gamma, onehot, iv, precision=hi)
    beta = jnp.einsum("nm,nmc->c", gamma, onehot, precision=hi)
    k = jnp.einsum("ncd,ne->cde", w_miv, xhat, precision=hi)
    g = jnp.einsum("ncd,ne,nf->cdef", w_iv, xhat, xhat, precision=hi)
    return beta, k, g


# ---------------------------------------------------------------------------
# Estimation with tree fallback (host)
# ---------------------------------------------------------------------------


def choose_regression_classes(tree: RegressionTree, leaf_occ: np.ndarray,
                              min_count: float) -> tuple[np.ndarray, list]:
    """Walk each leaf up to its lowest ancestor with occupancy >= min_count
    (``RegressionTree::GatherStats`` role). Returns (leaf -> class index,
    list of chosen tree nodes, one per class)."""
    occ = np.zeros(tree.num_nodes)
    occ[: tree.num_leaves] = leaf_occ
    # push occupancies up the tree (parents have larger ids)
    for node in range(tree.num_nodes):
        par = tree.parent[node]
        if par >= 0:
            occ[par] += occ[node]
    chosen: dict[int, int] = {}
    leaf_to_class = np.zeros(tree.num_leaves, np.int32)
    nodes: list[int] = []
    for leaf in range(tree.num_leaves):
        node = leaf
        while occ[node] < min_count and tree.parent[node] >= 0:
            node = int(tree.parent[node])
        if node not in chosen:
            chosen[node] = len(nodes)
            nodes.append(node)
        leaf_to_class[leaf] = chosen[node]
    return leaf_to_class, nodes


def _pool_by_class(tree: RegressionTree, leaf_to_class: np.ndarray,
                   num_classes: int, *stats):
    """Sum per-leaf stat arrays into per-class arrays."""
    out = []
    for s in stats:
        pooled = np.zeros((num_classes,) + s.shape[1:], np.float64)
        np.add.at(pooled, leaf_to_class, np.asarray(s, np.float64))
        out.append(pooled)
    return out


def estimate_regtree_fmllr(tree: RegressionTree, beta: np.ndarray,
                           k: np.ndarray, g: np.ndarray,
                           min_count: float = 1000.0, num_iters: int = 20):
    """Per-leaf stats -> (transforms [R, D, D+1], leaf_to_class [C],
    objf impr/frame list) (``RegtreeFmllrDiagGmmAccs::Update``)."""
    leaf_to_class, nodes = choose_regression_classes(tree, beta, min_count)
    r = len(nodes)
    pb, pk, pg = _pool_by_class(tree, leaf_to_class, r, beta[:, None], k, g)
    pb = pb[:, 0]
    # below-min-count classes (possible only at the root) keep identity
    w, imprs = estimate_fmllr_batch(pb, pk, pg, min_count=min(min_count, 1.0),
                                    num_iters=num_iters)
    return w, leaf_to_class, imprs


def regtree_fmllr_loglikes(params: GmmParams, feats: jnp.ndarray,
                           transforms: np.ndarray, leaf_to_class: np.ndarray,
                           bclass_of: np.ndarray) -> jnp.ndarray:
    """Adapted per-frame per-pdf log-likelihoods
    (``RegtreeFmllrDiagGmm::LogLikelihood`` role): each Gaussian is scored on
    the feature transformed by its regression class, plus log|det A_c|.

    feats [N, D] -> [N, P] loglikes.
    """
    w = jnp.asarray(transforms, feats.dtype)           # [R, D, D+1]
    a, b = w[:, :, :-1], w[:, :, -1]
    xr = jnp.einsum("rde,ne->nrd", a, feats,
                    precision=jax.lax.Precision.HIGHEST) + b[None]   # [N, R, D]
    logdets = jnp.linalg.slogdet(a)[1]                               # [R]
    comp_r = jax.vmap(lambda x: component_logliks(params, x),
                      in_axes=1, out_axes=1)(xr)                     # [N, R, P, M]
    cls_of = jnp.asarray(leaf_to_class)[jnp.asarray(bclass_of)]      # [P, M]
    cls_safe = jnp.maximum(cls_of, 0)
    sel = jnp.take_along_axis(
        comp_r, cls_safe[None, None, :, :], axis=1)[:, 0]            # [N, P, M]
    sel = sel + logdets[cls_safe][None]
    sel = jnp.where((jnp.asarray(bclass_of) >= 0)[None], sel, -jnp.inf)
    return jax.scipy.special.logsumexp(sel, axis=2)


# ---------------------------------------------------------------------------
# Regression-tree MLLR (mean adaptation; RegtreeMllrDiagGmm)
# ---------------------------------------------------------------------------


def acc_regtree_mllr_stats(params: GmmParams, feats: jnp.ndarray,
                           pdf_ids: jnp.ndarray, weights: jnp.ndarray):
    """Per-Gaussian occupancies and first moments for MLLR
    (``RegtreeMllrDiagGmmAccs`` role): returns (occ [P, M], xbar [P, M, D])."""
    comp = component_logliks(params, feats)
    sel = jnp.take_along_axis(comp, pdf_ids[:, None, None], axis=1)[:, 0, :]
    gamma = jax.nn.softmax(sel, axis=1) * weights[:, None]          # [N, M]
    p, m = params.num_pdfs, params.max_mix
    occ = jax.ops.segment_sum(gamma, pdf_ids, p)                    # [P, M]
    xbar = jax.ops.segment_sum(gamma[:, :, None] * feats[:, None, :],
                               pdf_ids, p)                          # [P, M, D]
    return occ, xbar


def estimate_regtree_mllr(tree: RegressionTree, occ: np.ndarray,
                          xbar: np.ndarray, means: np.ndarray,
                          inv_vars: np.ndarray, min_count: float = 1000.0):
    """Closed-form per-class mean transforms mu' = A mu + b
    (``RegtreeMllrDiagGmmAccs::Update``): per row d,
    G_d = sum_g occ_g ivar_gd muhat muhat^T, k_d = sum_g ivar_gd xbar_gd muhat.

    Returns (transforms [R, D, D+1], leaf_to_class)."""
    p, m, d = means.shape
    flat = lambda x: np.asarray(x, np.float64).reshape(p * m, *x.shape[2:])
    occ_f, xbar_f = flat(occ), flat(xbar)
    mu_f, iv_f = flat(means), flat(inv_vars)
    bc = tree.bclass_of.reshape(p * m)
    leaf_occ = np.zeros(tree.num_leaves)
    valid = bc >= 0
    np.add.at(leaf_occ, bc[valid], occ_f[valid])
    leaf_to_class, nodes = choose_regression_classes(tree, leaf_occ, min_count)
    r = len(nodes)
    muhat = np.concatenate([mu_f, np.ones((p * m, 1))], axis=1)      # [G, D+1]
    gcls = np.where(valid, leaf_to_class[np.maximum(bc, 0)], 0)
    w_occ = np.where(valid, occ_f, 0.0)
    # per-class per-row normal equations
    gmat = np.zeros((r, d, d + 1, d + 1))
    kmat = np.zeros((r, d, d + 1))
    outer = muhat[:, :, None] * muhat[:, None, :]                    # [G, D+1, D+1]
    for c in range(r):
        sel = gcls == c
        if not sel.any():
            continue
        wiv = (w_occ[sel, None] * iv_f[sel])                         # [g, D]
        gmat[c] = np.einsum("gd,gef->def", wiv, outer[sel])
        kmat[c] = np.einsum("gd,gd,ge->de", iv_f[sel], xbar_f[sel], muhat[sel])
    xforms = np.broadcast_to(
        np.concatenate([np.eye(d), np.zeros((d, 1))], 1), (r, d, d + 1)).copy()
    for c in range(r):
        cnt = sum(leaf_occ[le] for le in range(tree.num_leaves)
                  if leaf_to_class[le] == c)
        if cnt < 1.0:
            continue
        for i in range(d):
            tr = np.trace(gmat[c, i]) / (d + 1)
            reg = 1e-6 * max(tr, 1e-10) * np.eye(d + 1)
            xforms[c, i] = np.linalg.solve(gmat[c, i] + reg, kmat[c, i])
    return xforms.astype(np.float32), leaf_to_class


def apply_regtree_mllr(means: np.ndarray, tree: RegressionTree,
                       transforms: np.ndarray, leaf_to_class: np.ndarray
                       ) -> np.ndarray:
    """Adapted means mu' = A_c mu + b_c per Gaussian ([P, M, D] -> same)."""
    p, m, d = means.shape
    bc = tree.bclass_of.reshape(p * m)
    mu = means.reshape(p * m, d)
    cls = np.where(bc >= 0, leaf_to_class[np.maximum(bc, 0)], 0)
    w = transforms[cls]                                              # [G, D, D+1]
    out = np.einsum("gde,ge->gd", w[:, :, :d], mu) + w[:, :, d]
    out = np.where((bc >= 0)[:, None], out, mu)
    return out.reshape(p, m, d).astype(means.dtype)
