"""Decode benchmark on a REAL compiled HCLG.

Builds the same decode graph the flagship example's mono stage uses —
`fst/hclg.py mkgraph` over the testing-lexicon lang and a mod-KN trigram
estimated from template-grammar sentences (`testing/corpus.sample_sentence`)
— then times BOTH production decode paths through `steps/decode.Decoder`:

* `decode_batch`   — best path (gmm-latgen-faster --determinize=false role)
* `decode_lattice` — lattice-generating forward-backward, the path every
  committed WER flows through (`gmm-latgen-faster.cpp:110-160`,
  `lattice-faster-decoder.cc:72-89` GetRawLattice)

Unlike bench.py's `synth_decode_graph`, this graph has everything a real
HCLG has: epsilon structure, non-dst-pure states after determinize/minimize
(multiplying (dst, pdf) EmitPlan rows), long-range backoff arcs, and final
weights.  The graph is cached under ``<repo>/.bench_cache`` keyed by a
content version.

Usage: python tools/bench_real_graph.py [--batch 128] [--frames 1000]
           [--sentences 1200] [--lattice-batch 32] [--json-out PATH]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402

GRAPH_VERSION = "r3a"


def build_real_hclg(num_sentences: int = 1200, seed: int = 0):
    """-> (hclg Fst, trans_model, tree, lang).  Deterministic; mkgraph
    takes seconds with the native WFST library and much longer on the
    Python fallback."""
    from voicebridge_tpu.config import LangOptions
    from voicebridge_tpu.data.lang import prepare_lang
    from voicebridge_tpu.fst.hclg import mkgraph
    from voicebridge_tpu.lm.arpa import arpa_to_fst
    from voicebridge_tpu.lm.ngram import estimate_ngram
    from voicebridge_tpu.models.transition import TransitionModel
    from voicebridge_tpu.steps.train_mono import make_mono_tree
    from voicebridge_tpu.testing import LEXICON
    from voicebridge_tpu.testing.corpus import sample_sentence

    rng = np.random.default_rng(seed)
    sentences = [sample_sentence(rng) for _ in range(num_sentences)]
    arpa = estimate_ngram(sentences, order=3)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    tree = make_mono_tree(lang)
    tm = TransitionModel(lang.topo, tree)
    g = arpa_to_fst(arpa, lang.words.id, lang.word_disambig_id)
    hclg = mkgraph(lang, tree, tm, g)
    return hclg, tm, tree, lang


def _cache_path(num_sentences: int, seed: int) -> Path:
    return (REPO / ".bench_cache"
            / f"hclg_{GRAPH_VERSION}_{num_sentences}_{seed}.npz")


def load_or_build(num_sentences: int = 1200, seed: int = 0):
    """Cached (hclg, tm, tree, lang); the Fst round-trips through npz, the
    model objects are cheap to rebuild."""
    from voicebridge_tpu.config import LangOptions
    from voicebridge_tpu.data.lang import prepare_lang
    from voicebridge_tpu.fst.core import Fst
    from voicebridge_tpu.models.transition import TransitionModel
    from voicebridge_tpu.steps.train_mono import make_mono_tree
    from voicebridge_tpu.testing import LEXICON

    cache = _cache_path(num_sentences, seed)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    tree = make_mono_tree(lang)
    tm = TransitionModel(lang.topo, tree)
    if cache.exists():
        return Fst.load(cache), tm, tree, lang
    hclg, tm2, tree2, lang2 = build_real_hclg(num_sentences, seed)
    cache.parent.mkdir(exist_ok=True)
    hclg.save(cache)
    return hclg, tm2, tree2, lang2


def make_decoder(hclg, tm, tree, lattice_beam: float = 8.0,
                 mem_budget: float | None = None):
    from voicebridge_tpu.config import DecodeOptions
    from voicebridge_tpu.models.gmm import AmDiagGmm
    from voicebridge_tpu.steps.decode import Decoder

    rng = np.random.default_rng(1)
    p, m, d = tree.num_pdfs, 5, 39
    am = AmDiagGmm(
        rng.standard_normal((p, m, d)).astype(np.float32),
        (np.abs(rng.standard_normal((p, m, d))) + 0.5).astype(np.float32),
        np.full((p, m), 1.0 / m, np.float32))
    opts = (DecodeOptions(lattice_beam=lattice_beam,
                          lattice_mem_budget=mem_budget)
            if mem_budget else DecodeOptions(lattice_beam=lattice_beam))
    return Decoder(hclg, tm, am, opts), am, d


def model_feats(am, b: int, t: int, rng) -> np.ndarray:
    """Model-consistent features: a persistent random pdf walk emitting from
    each pdf's first mixture.  Random N(0,1) features give FLAT acoustic
    scores, so a lattice beam keeps ~every arc (measured 1.1M arcs/lattice)
    — nothing like a real decode; emission-sampled features produce peaked
    loglikes and realistic lattice density while the dense forward cost is
    identical."""
    means = am.means()[:, 0, :]  # [P, D]
    sigma = 1.0 / np.sqrt(am.inv_vars[:, 0, :])
    p, d = means.shape
    # persistent walk: expected dwell ~5 frames (HMM-ish)
    jump = rng.random((b, t)) < 0.2
    jump[:, 0] = True
    draws = rng.integers(0, p, size=(b, t))
    idx = np.where(jump, draws, 0)
    path = np.maximum.accumulate(np.where(jump, np.arange(t)[None, :], 0),
                                 axis=1)
    pdfs = np.take_along_axis(idx, path, axis=1)  # last jump's draw
    eps = rng.standard_normal((b, t, d)).astype(np.float32)
    return (means[pdfs] + 0.7 * sigma[pdfs] * eps).astype(np.float32)


def graph_walk_feats(graph, am, b: int, t: int, rng) -> np.ndarray:
    """Corpus-realistic features: emitted along ACTUAL paths through the
    compiled eps-free decode graph (random walk over outgoing arcs from a
    start state).  Acoustics consistent with one graph path give peaked
    posteriors concentrated on lattice-beam-plausible alternatives — the
    density a real decode sees — unlike `model_feats`, whose pdf walk
    ignores the graph and yields worst-case ~200k-arc lattices."""
    order = np.argsort(graph.arc_src, kind="stable")
    src_sorted = graph.arc_src[order]
    out_start = np.searchsorted(src_sorted, np.arange(graph.num_states + 1))
    starts = np.flatnonzero(graph.alpha0 > -1e29)
    means = am.means()[:, 0, :]
    sigma = 1.0 / np.sqrt(am.inv_vars[:, 0, :])
    pdfs = np.zeros((b, t), np.int64)
    for i in range(b):
        s = int(starts[rng.integers(len(starts))])
        for j in range(t):
            lo, hi = int(out_start[s]), int(out_start[s + 1])
            if hi == lo:  # final dead-end: restart the walk
                s = int(starts[rng.integers(len(starts))])
                lo, hi = int(out_start[s]), int(out_start[s + 1])
            a = int(order[lo + rng.integers(hi - lo)])
            pdfs[i, j] = graph.arc_pdf[a]
            s = int(graph.arc_dst[a])
    eps = rng.standard_normal((b, t, means.shape[1])).astype(np.float32)
    return (means[pdfs] + 0.7 * sigma[pdfs] * eps).astype(np.float32)


def bench(decoder, dim: int, b: int, t: int, mode: str, iters: int = 3,
          am=None):
    """-> audio-s/s for `mode` in {best_path, lattice, lattice_real}."""
    rng = np.random.default_rng(2)
    if mode == "lattice_real":
        feats = graph_walk_feats(decoder.graph, am, b, t, rng)
    elif am is not None:
        feats = model_feats(am, b, t, rng)
    else:
        feats = rng.standard_normal((b, t, dim)).astype(np.float32)
    nf = np.full(b, t, np.int32)
    utts = [f"u{i}" for i in range(b)]

    def run():
        if mode == "best_path":
            out = decoder.decode_batch(utts, feats, nf)
            assert len(out) == b
        else:
            lats = decoder.decode_lattice(utts, feats, nf)
            assert len(lats) == b
        return True

    run()  # compile
    start = time.perf_counter()
    for _ in range(iters):
        run()
    wall = (time.perf_counter() - start) / iters
    return b * t * 0.01 / wall


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--lattice-batch", type=int, default=128)
    ap.add_argument("--lattice-frames", type=int, default=1000)
    ap.add_argument("--mem-budget", type=float, default=None,
                    help="lattice_mem_budget override (bytes)")
    ap.add_argument("--sentences", type=int, default=1200)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--modes", default="best_path,lattice")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache
    setdefault_compilation_cache()

    t0 = time.time()
    hclg, tm, tree, lang = load_or_build(args.sentences)
    print(f"graph ready in {time.time() - t0:.0f}s", flush=True)
    decoder, am, dim = make_decoder(hclg, tm, tree,
                                    mem_budget=args.mem_budget)
    rec = {
        "graph": {"states": hclg.num_states,
                  "arcs_eps_free": decoder.graph.num_arcs,
                  "rows": decoder.plan.num_rows, "d": decoder.plan.d,
                  "packed_bp": decoder.plan.packed,
                  "num_pdfs": tree.num_pdfs},
    }
    print(json.dumps(rec["graph"]), flush=True)
    for mode in args.modes.split(","):
        b = args.batch if mode == "best_path" else args.lattice_batch
        t = args.frames if mode == "best_path" else args.lattice_frames
        v = bench(decoder, dim, b, t, mode, args.iters, am=am)
        rec[mode] = {"audio_s_per_s": round(v, 1), "batch": b, "frames": t}
        print(json.dumps({mode: rec[mode]}), flush=True)
    if args.json_out:
        Path(args.json_out).write_text(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
