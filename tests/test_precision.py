"""Every matrix product on the device asks for Precision.HIGHEST.

A float32 product that names no precision may run in TF32 on a GPU (about
three decimal digits), which breaks best-path parity with the float32
reference.  These checks read the jaxpr, so they hold on any backend."""

import jax
import jax.extend
import jax.numpy as jnp
import numpy as np
import pytest

from voicebridge_tpu.config import DeltaOptions
from voicebridge_tpu.models.gmm import AmDiagGmm
from voicebridge_tpu.ops import features as F
from voicebridge_tpu.ops import gmm_kernels as K
from voicebridge_tpu.transforms import fmllr, lda, regtree

P, M, D, N = 7, 3, 5, 16


def _am():
    rng = np.random.default_rng(0)
    return AmDiagGmm(rng.standard_normal((P, M, D)).astype(np.float32),
                     (np.abs(rng.standard_normal((P, M, D))) + 0.5
                      ).astype(np.float32),
                     np.full((P, M), 1.0 / M, np.float32))


def _cases():
    am = _am()
    params = K.pack_gmm(am)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal((N, D)), jnp.float32)
    pdf = jnp.asarray(rng.integers(0, P, N), jnp.int32)
    w = jnp.ones(N, jnp.float32)
    means, iv = jnp.asarray(am.means()), jnp.asarray(am.inv_vars)
    feats = jnp.asarray(rng.standard_normal((2, 9, D)), jnp.float32)
    nf = jnp.asarray([9, 6], jnp.int32)
    gm, wm, wi = fmllr._fmllr_frame_stats(params, means, iv, x, pdf, w)
    return {
        "loglik": lambda: K.loglikes_batch(params, feats),
        "stats_aligned": lambda: K.acc_gmm_stats_aligned(params, x, pdf, P, w),
        "stats_all_pdfs": lambda: K.acc_gmm_stats(params, x, pdf, P, w),
        "fmllr_frame_stats": lambda: fmllr._fmllr_frame_stats(
            params, means, iv, x, pdf, w),
        "fmllr_reduce": lambda: fmllr._fmllr_reduce_one(gm, wm, wi, x),
        "regtree": lambda: regtree.acc_regtree_fmllr_stats(
            params, means, iv, x, pdf, w,
            jnp.zeros((P, M), jnp.int32), 2),
        "delta": lambda: F.add_deltas_batch(feats, nf, DeltaOptions()),
        "lda_stats": lambda: lda.acc_lda_stats(x, pdf, w, P),
        "lda_apply": lambda: lda.apply_affine_transform(
            x, np.ones((3, D + 1), np.float32)),
    }


def _dot_precisions(jaxpr):
    """Precision of every dot_general in ``jaxpr``, sub-jaxprs included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else (v,)):
                inner = getattr(sub, "jaxpr", None)
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    inner = sub.jaxpr
                if isinstance(inner, jax.extend.core.Jaxpr):
                    out.extend(_dot_precisions(inner))
    return out


HIGHEST = jax.lax.Precision.HIGHEST


@pytest.mark.parametrize("name", sorted(_cases()))
def test_dot_general_precision_highest(name):
    fn = _cases()[name]
    precisions = _dot_precisions(jax.make_jaxpr(fn)().jaxpr)
    assert precisions, f"{name}: no dot_general found"
    for p in precisions:
        assert p is not None and all(q == HIGHEST for q in p), (name, p)
