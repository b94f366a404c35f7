"""Full-covariance GMM, batched device layout.

Counterpart of Kaldi ``FullGmm`` (``gmm/full-gmm.h:40``) and its MLE
re-estimation (``gmm/mle-full-gmm.h``).  The reference pipeline trains
diagonal models; FullGmm exists in the library for UBM-style modeling and as
the target of diag->full conversions — mirrored here with the same roles.

Layout: dense padded arrays over [P pdfs, M mixtures]:

    weights    [P, M]        (0 marks inactive padding)
    means      [P, M, D]
    inv_covars [P, M, D, D]  (symmetric precision matrices)
    gconsts    [P, M]        log w + 0.5 log|inv_cov| - D/2 log(2pi)
                             - 0.5 mu^T inv_cov mu   (full-gmm.cc gconst)

Log-likelihood per frame/component:

    gconst + x^T (inv_cov mu) - 0.5 x^T inv_cov x

which evaluates as one [N, D] x [D, P*M] matmul for the linear
term plus a batched quadratic form — see :func:`loglikes_full`.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

M_LOG_2PI = math.log(2.0 * math.pi)


class FullGmm:
    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 inv_covars: np.ndarray):
        self.weights = np.asarray(weights, np.float64)  # [P, M]
        self.means = np.asarray(means, np.float64)  # [P, M, D]
        self.inv_covars = np.asarray(inv_covars, np.float64)  # [P, M, D, D]
        self.gconsts = self.compute_gconsts()

    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def max_mix(self) -> int:
        return self.weights.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @classmethod
    def from_diag(cls, am) -> "FullGmm":
        """Diag -> full conversion (``FullGmm::CopyFromDiagGmm``)."""
        p, m, d = am.inv_vars.shape
        ic = np.zeros((p, m, d, d))
        idx = np.arange(d)
        ic[:, :, idx, idx] = am.inv_vars
        return cls(am.weights, am.means(), ic)

    def to_diag(self):
        """Full -> diag (``DiagGmm::CopyFromFullGmm``): keep the covariance
        diagonal (inverse of the covariance's diagonal, not the precision's)."""
        from .gmm import AmDiagGmm

        p, m, d = self.means.shape
        var = np.empty((p, m, d))
        for i in range(p):
            for j in range(m):
                if self.weights[i, j] > 0:
                    var[i, j] = np.diag(np.linalg.inv(self.inv_covars[i, j]))
                else:
                    var[i, j] = 1.0
        iv = 1.0 / np.maximum(var, 1e-10)
        return AmDiagGmm((self.means * iv).astype(np.float32),
                         iv.astype(np.float32),
                         self.weights.astype(np.float32))

    def compute_gconsts(self) -> np.ndarray:
        p, m, d = self.means.shape
        g = np.full((p, m), -np.inf)
        for i in range(p):
            for j in range(m):
                w = self.weights[i, j]
                if w <= 0:
                    continue
                sign, logdet = np.linalg.slogdet(self.inv_covars[i, j])
                if sign <= 0:
                    raise ValueError(f"non-PD precision at pdf {i} mix {j}")
                mu = self.means[i, j]
                g[i, j] = (math.log(w) + 0.5 * logdet - 0.5 * d * M_LOG_2PI
                           - 0.5 * mu @ self.inv_covars[i, j] @ mu)
        return g

    def loglike(self, pdf: int, x: np.ndarray) -> float:
        """Naive single-frame loglik (test oracle)."""
        vals = []
        for j in range(self.max_mix):
            if self.weights[pdf, j] <= 0:
                continue
            ic = self.inv_covars[pdf, j]
            vals.append(self.gconsts[pdf, j] + x @ ic @ self.means[pdf, j]
                        - 0.5 * x @ ic @ x)
        vals = np.asarray(vals)
        mx = vals.max()
        return float(mx + np.log(np.exp(vals - mx).sum()))

    def save(self, path: str | Path) -> None:
        np.savez_compressed(path, weights=self.weights, means=self.means,
                            inv_covars=self.inv_covars)

    @classmethod
    def load(cls, path: str | Path) -> "FullGmm":
        z = np.load(path)
        return cls(z["weights"], z["means"], z["inv_covars"])

    # -- EM -------------------------------------------------------------------
    def mle_update(self, occ: np.ndarray, x_acc: np.ndarray, xx_acc: np.ndarray,
                   min_occ: float = 10.0, cov_floor: float = 1e-3) -> dict:
        """M-step from full-covariance sufficient statistics
        (``MleFullGmmUpdate``): occ [P, M], x_acc [P, M, D],
        xx_acc [P, M, D, D] (sum of x x^T).  Components below ``min_occ``
        keep their parameters.  Covariances floored by adding
        ``cov_floor * avg_var * I``."""
        p, m, d = self.means.shape
        updated = 0
        for i in range(p):
            tot = occ[i].sum()
            if tot <= 0:
                continue
            for j in range(m):
                if self.weights[i, j] <= 0 or occ[i, j] < min_occ:
                    continue
                mu = x_acc[i, j] / occ[i, j]
                cov = xx_acc[i, j] / occ[i, j] - np.outer(mu, mu)
                floor = cov_floor * max(np.trace(cov) / d, 1e-6)
                cov = cov + floor * np.eye(d)
                self.means[i, j] = mu
                self.inv_covars[i, j] = np.linalg.inv(cov)
                self.weights[i, j] = occ[i, j] / tot
                updated += 1
        # renormalize weights over active comps
        wsum = self.weights.sum(axis=1, keepdims=True)
        self.weights = np.where(wsum > 0, self.weights / np.maximum(wsum, 1e-10),
                                self.weights)
        self.gconsts = self.compute_gconsts()
        return {"updated": updated}


# ---------------------------------------------------------------------------
# Device kernels
# ---------------------------------------------------------------------------


def pack_full_gmm(gmm: FullGmm):
    """Device arrays for :func:`loglikes_full` / :func:`acc_full_stats`."""
    import jax.numpy as jnp

    ic_mu = np.einsum("pmde,pme->pmd", gmm.inv_covars, gmm.means)
    return dict(
        gconsts=jnp.asarray(gmm.gconsts, jnp.float32),
        ic=jnp.asarray(gmm.inv_covars, jnp.float32),
        ic_mu=jnp.asarray(ic_mu, jnp.float32),
    )


def loglikes_full(packed: dict, x) -> "jnp.ndarray":
    """x [N, D] -> per-pdf loglikes [N, P]: linear term as a matmul,
    quadratic form as a batched einsum."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    lin = jnp.einsum("nd,pmd->npm", x, packed["ic_mu"], precision=hi)
    quad = jnp.einsum("nd,pmde,ne->npm", x, packed["ic"], x, precision=hi)
    comp = packed["gconsts"][None] + lin - 0.5 * quad  # [N, P, M]
    return jax.nn.logsumexp(comp, axis=2)


def acc_full_stats(packed: dict, x, pdf_ids, num_pdfs: int, weights=None):
    """E-step stats for hard alignments: component posteriors within the
    aligned pdf, then (occ [P, M], x_acc [P, M, D], xx_acc [P, M, D, D])."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    n, d = x.shape
    lin = jnp.einsum("nd,pmd->npm", x, packed["ic_mu"], precision=hi)
    quad = jnp.einsum("nd,pmde,ne->npm", x, packed["ic"], x, precision=hi)
    comp = packed["gconsts"][None] + lin - 0.5 * quad
    sel = jnp.take_along_axis(comp, pdf_ids[:, None, None], axis=1)[:, 0]  # [N, M]
    gamma = jax.nn.softmax(sel, axis=1)
    if weights is not None:
        gamma = gamma * weights[:, None]
    occ = jax.ops.segment_sum(gamma, pdf_ids, num_pdfs)  # [P, M]
    x_acc = jax.ops.segment_sum(gamma[:, :, None] * x[:, None, :], pdf_ids,
                                num_pdfs)
    xx = x[:, None, :, None] * x[:, None, None, :]  # [N, 1, D, D]
    xx_acc = jax.ops.segment_sum(gamma[:, :, None, None] * xx, pdf_ids,
                                 num_pdfs)
    return occ, x_acc, xx_acc
