"""voicebridge_tpu — a batched GMM-HMM speech-recognition framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
AI-TOOLKIT/VoiceBridge (a C++/MKL packaging of the classical Kaldi GMM-HMM
pipeline): data preparation, lexicon/G2P, n-gram language
models, MFCC/CMVN/delta/LDA features, monophone -> triphone -> LDA+MLLT ->
SAT/fMLLR acoustic-model training via EM with Viterbi realignment, HCLG WFST
graph compilation, beam-search decoding, and WER scoring.

Design principles:
  * features / GMM likelihoods / Viterbi / EM statistics run as batched XLA
    programs over `[batch, frames, dim]` arrays with length masks;
  * parallelism is `jax.sharding.Mesh` + collectives (psum of EM stats), not
    the reference's std::thread-over-file-shards model;
  * WFST graph *compilation* stays on host (it is offline), the *decoder*
    runs on device.
"""

__version__ = "0.1.0"
