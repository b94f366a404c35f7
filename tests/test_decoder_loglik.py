"""Decoder has one acoustic path on every backend: ops/gmm_kernels
loglikes_batch, which equals a float64 numpy reference."""

import importlib

import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from voicebridge_tpu.ops import gmm_kernels as K
from voicebridge_tpu.steps.decode import Decoder


def _decoder():
    ge = importlib.import_module("__graft_entry__")
    _lang, _tree, tm, am, hclg, _c = ge._tiny_pipeline()
    return Decoder(hclg, tm, am), am


def test_decoder_loglikes_is_the_xla_path():
    dec, am = _decoder()
    feats = np.random.default_rng(0).standard_normal(
        (3, 11, am.dim)).astype(np.float32)
    got = np.asarray(dec._loglikes(jnp.asarray(feats)))
    np.testing.assert_array_equal(
        got, np.asarray(K.loglikes_batch(dec.params, jnp.asarray(feats))))
    want = cs.loglik_reference(am, feats.reshape(-1, am.dim))
    np.testing.assert_allclose(got.reshape(-1, am.num_pdfs), want,
                               rtol=1e-5, atol=1e-4)


def test_decoder_state_holds_one_parameter_set():
    dec, _am = _decoder()
    gmm_attrs = [k for k, v in vars(dec).items()
                 if isinstance(v, K.GmmParams) or "pallas" in k]
    assert gmm_attrs == ["params"]
