"""Diagonal-covariance GMM acoustic model, batched device layout.

Counterpart of Kaldi ``DiagGmm``/``AmDiagGmm`` (``gmm/diag-gmm.h``,
``gmm/am-diag-gmm.h:36``) and the MLE re-estimation machinery
(``gmm/mle-diag-gmm.h:106``, ``mle-am-diag-gmm.h:34``).

Instead of a ragged per-pdf collection, parameters live in dense padded arrays

    means_invvars [P, M, D]   (mean / var)
    inv_vars      [P, M, D]   (1 / var)
    gconsts       [P, M]      (-inf marks inactive padding components)
    weights       [P, M]

with ``M = max mixtures per pdf``: this is what lets the acoustic log-likelihood
be evaluated as one ``[N, 2D] x [2D, P*M]`` matmul
(``voicebridge_tpu/ops/gmm_kernels.py``).  Per-pdf active-component counts are
implicit in gconst = -inf padding.  gconst formula matches
``gmm/diag-gmm.cc:121-129``:

    gconst[p,m] = log w - 0.5 * (D log(2pi) + sum_d(log var_d + mu_d^2/var_d))

The M-step (``MleDiagGmmUpdate``), mixture splitting (``DiagGmm::Split`` /
gmm-mixup), and silence boosting (gmm-boost-silence) are host-side numpy —
tiny arrays, offline between EM iterations.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

M_LOG_2PI = math.log(2.0 * math.pi)
NEG_INF = -np.inf


class AmDiagGmm:
    def __init__(self, means_invvars: np.ndarray, inv_vars: np.ndarray,
                 weights: np.ndarray):
        self.means_invvars = np.asarray(means_invvars, np.float32)  # [P, M, D]
        self.inv_vars = np.asarray(inv_vars, np.float32)  # [P, M, D]
        self.weights = np.asarray(weights, np.float32)  # [P, M]; 0 = inactive
        self.gconsts = self.compute_gconsts()

    # -- construction --------------------------------------------------------
    @classmethod
    def flat_start(cls, num_pdfs: int, glob_mean: np.ndarray, glob_var: np.ndarray,
                   max_mix: int = 1) -> "AmDiagGmm":
        """gmm-init-mono: every pdf = 1 Gaussian at the global mean/var
        (gmm-init-mono.cpp:89-127)."""
        d = len(glob_mean)
        inv_var = 1.0 / np.maximum(glob_var, 1e-10)
        miv = np.zeros((num_pdfs, max_mix, d), np.float32)
        iv = np.ones((num_pdfs, max_mix, d), np.float32)
        w = np.zeros((num_pdfs, max_mix), np.float32)
        miv[:, 0, :] = glob_mean * inv_var
        iv[:, 0, :] = inv_var
        w[:, 0] = 1.0
        return cls(miv, iv, w)

    @property
    def num_pdfs(self) -> int:
        return self.means_invvars.shape[0]

    @property
    def max_mix(self) -> int:
        return self.means_invvars.shape[1]

    @property
    def dim(self) -> int:
        return self.means_invvars.shape[2]

    @property
    def num_gauss(self) -> int:
        return int((self.weights > 0).sum())

    def active_mask(self) -> np.ndarray:
        return self.weights > 0

    def means(self) -> np.ndarray:
        var = 1.0 / np.maximum(self.inv_vars, 1e-20)
        return self.means_invvars * var

    def variances(self) -> np.ndarray:
        return 1.0 / np.maximum(self.inv_vars, 1e-20)

    def compute_gconsts(self) -> np.ndarray:
        miv = self.means_invvars.astype(np.float64)
        iv = np.maximum(self.inv_vars.astype(np.float64), 1e-20)
        w = self.weights.astype(np.float64)
        d = self.dim
        # sum_d (log var + mu^2/var) = sum_d (-log iv + miv^2/iv)
        quad = (-np.log(iv) + miv * miv / iv).sum(axis=2)
        with np.errstate(divide="ignore"):
            gc = np.where(w > 0, np.log(np.maximum(w, 1e-300)), NEG_INF)
        gc = gc - 0.5 * (d * M_LOG_2PI + quad)
        gc = np.where(w > 0, gc, NEG_INF)
        self.gconsts = gc.astype(np.float32)
        return self.gconsts

    # -- reference (host) log-likelihood, for tests --------------------------
    def loglike(self, pdf: int, x: np.ndarray) -> float:
        gc = self.gconsts[pdf].astype(np.float64)
        ll = gc + self.means_invvars[pdf].astype(np.float64) @ x \
            - 0.5 * (self.inv_vars[pdf].astype(np.float64) @ (x * x))
        m = ll.max()
        return float(m + np.log(np.exp(ll - m).sum()))

    # -- M-step (MleDiagGmmUpdate, mle-diag-gmm.cc) --------------------------
    def mle_update(self, occ: np.ndarray, mean_acc: np.ndarray, var_acc: np.ndarray,
                   min_gaussian_occupancy: float = 10.0, min_variance: float = 0.001,
                   min_gaussian_weight: float = 1e-5) -> dict:
        """Update in place from sufficient stats (shapes [P,M], [P,M,D], [P,M,D]).
        Low-occupancy components are dropped (weight 0) unless they are the
        pdf's last component.  Returns update diagnostics."""
        from ..utils.health import check_finite

        # divergence detection (utils/health.py): NaN/Inf in the E-step stats
        # would otherwise propagate silently into the model
        check_finite("gmm mle_update", occ=occ, mean_acc=mean_acc,
                     var_acc=var_acc)
        occ = occ.astype(np.float64)
        tot_occ_per_pdf = occ.sum(axis=1, keepdims=True)  # [P, 1]
        active = self.weights > 0
        # keep: enough occupancy, or sole surviving component of the pdf
        keep = active & (occ >= min_gaussian_occupancy)
        for p in range(self.num_pdfs):
            if active[p].any() and not keep[p].any():
                keep[p, int(np.argmax(occ[p]))] = True

        new_w = np.where(keep, occ / np.maximum(tot_occ_per_pdf, 1e-10), 0.0)
        # renormalize over kept comps
        w_sum = new_w.sum(axis=1, keepdims=True)
        new_w = np.where(keep, new_w / np.maximum(w_sum, 1e-10), 0.0)
        new_w = np.where(keep & (new_w < min_gaussian_weight), min_gaussian_weight, new_w)
        new_w = new_w / np.maximum(new_w.sum(axis=1, keepdims=True), 1e-10)

        occ_e = np.maximum(occ, 1e-10)[:, :, None]
        mean = mean_acc / occ_e
        var = var_acc / occ_e - mean * mean
        var = np.maximum(var, min_variance)

        # only update components that were re-estimated
        upd = keep[:, :, None]
        inv_var = 1.0 / var
        self.means_invvars = np.where(upd, mean * inv_var, self.means_invvars).astype(np.float32)
        self.inv_vars = np.where(upd, inv_var, self.inv_vars).astype(np.float32)
        self.weights = np.where(keep, new_w, 0.0).astype(np.float32)
        self._compact_components()
        self.compute_gconsts()
        removed = int((active & ~keep).sum())
        return {"removed": removed, "tot_occ": float(occ.sum())}

    def _compact_components(self) -> None:
        """Move active components to the front of each pdf's mixture axis
        (split_to_target and the padded kernels assume contiguous actives)."""
        active = self.weights > 0
        order = np.argsort(~active, kind="stable", axis=1)  # actives first
        self.weights = np.take_along_axis(self.weights, order, axis=1)
        self.means_invvars = np.take_along_axis(
            self.means_invvars, order[:, :, None], axis=1)
        self.inv_vars = np.take_along_axis(
            self.inv_vars, order[:, :, None], axis=1)

    # -- mixture splitting (gmm-mixup / DiagGmm::Split) ----------------------
    def split_to_target(self, target_total: int, occs: np.ndarray,
                        power: float = 0.2, min_count: float = 20.0,
                        perturb_factor: float = 0.01, seed: int = 0) -> None:
        """Increase total #Gaussians to ``target_total``, allocating per pdf
        proportionally to occupancy^power (gmm-mixup.cc GetSplitTargets) and
        splitting the highest-weight components (diag-gmm.cc:154-213)."""
        rng = np.random.default_rng(seed)
        pdf_occ = occs.sum(axis=1)  # [P]
        cur = (self.weights > 0).sum(axis=1)  # [P]
        if target_total <= int(cur.sum()):
            return
        # allocate targets: proportional to occ^power with min-count clamp
        score = np.maximum(pdf_occ, 1.0) ** power
        raw = score / score.sum() * target_total
        targets = np.maximum(np.floor(raw).astype(int), 1)
        # cap by occupancy: don't give a pdf more gaussians than occ/min_count
        cap = np.maximum((pdf_occ / min_count).astype(int), 1)
        targets = np.minimum(targets, np.maximum(cap, cur))
        targets = np.maximum(targets, cur)
        # distribute remainder to highest fractional parts
        remainder = target_total - int(targets.sum())
        if remainder > 0:
            frac = raw - np.floor(raw)
            frac = np.where(targets < np.maximum(cap, cur), frac, -1.0)
            for i in np.argsort(-frac)[:remainder]:
                if frac[i] >= 0:
                    targets[i] += 1

        new_m = int(targets.max())
        if new_m > self.max_mix:
            # grow in powers of two: keeps the padded [P, M, D] shapes stable
            # across EM iterations so device kernels don't recompile per iter
            m = 1
            while m < new_m:
                m *= 2
            self._grow_mix(m)
        d = self.dim
        for p in range(self.num_pdfs):
            n_cur, n_tgt = int(cur[p]), int(targets[p])
            while n_cur < n_tgt:
                # split the component with the largest weight
                m = int(np.argmax(self.weights[p, :n_cur]))
                w = self.weights[p, m] * 0.5
                iv = self.inv_vars[p, m]
                std = 1.0 / np.sqrt(np.maximum(iv, 1e-20))
                mean = self.means_invvars[p, m] / np.maximum(iv, 1e-20)
                rand = rng.standard_normal(d).astype(np.float32)
                m_new = n_cur
                self.weights[p, m] = w
                self.weights[p, m_new] = w
                self.inv_vars[p, m_new] = iv
                self.means_invvars[p, m_new] = (mean + perturb_factor * std * rand) * iv
                self.means_invvars[p, m] = (mean - perturb_factor * std * rand) * iv
                n_cur += 1
        self.compute_gconsts()

    def _grow_mix(self, new_m: int) -> None:
        p, m, d = self.num_pdfs, self.max_mix, self.dim
        grow = new_m - m
        self.means_invvars = np.concatenate(
            [self.means_invvars, np.zeros((p, grow, d), np.float32)], axis=1)
        self.inv_vars = np.concatenate(
            [self.inv_vars, np.ones((p, grow, d), np.float32)], axis=1)
        self.weights = np.concatenate(
            [self.weights, np.zeros((p, grow), np.float32)], axis=1)

    # -- silence boosting (gmm-boost-silence) --------------------------------
    def boost_silence(self, silence_pdfs: list[int], boost: float) -> "AmDiagGmm":
        """Return a copy with silence pdf weights scaled by ``boost``
        (gmm-boost-silence.cpp; weights not renormalized, gconsts recomputed)."""
        out = AmDiagGmm(self.means_invvars.copy(), self.inv_vars.copy(),
                        self.weights.copy())
        for p in silence_pdfs:
            out.weights[p] *= boost
        out.compute_gconsts()
        return out

    # -- serialization -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        np.savez_compressed(path, means_invvars=self.means_invvars,
                            inv_vars=self.inv_vars, weights=self.weights)

    @classmethod
    def load(cls, path: str | Path) -> "AmDiagGmm":
        z = np.load(path)
        return cls(z["means_invvars"], z["inv_vars"], z["weights"])
