"""Synthetic decode and training graphs at benchmark scale.

Shared by ``bench.py`` and ``chip_smoke.py``: an HCLG-shaped decode graph
(locally branching, one self-loop per state, dst-pure pdfs) and left-to-right
training-alignment graphs shaped like compiled utterance graphs.
"""

from __future__ import annotations

import numpy as np

from ..ops.viterbi import NEG_INF, DenseGraph


def synth_decode_graph(num_states: int = 60_000, arcs_per_state: int = 8,
                       num_pdfs: int = 2000, seed: int = 0) -> DenseGraph:
    """Synthetic HCLG-shaped arc arrays: locally-branching transition
    structure with self-loops (like a real decode graph after self-loop
    expansion)."""
    rng = np.random.default_rng(seed)
    a = num_states * arcs_per_state
    arc_src = np.repeat(np.arange(num_states, dtype=np.int32), arcs_per_state)
    # mostly-local destinations, wrap-around
    jumps = rng.integers(1, 64, size=a).astype(np.int32)
    arc_dst = ((arc_src + jumps) % num_states).astype(np.int32)
    # one self-loop per state
    arc_dst[::arcs_per_state] = arc_src[::arcs_per_state]
    # reordered-HCLG property (fst/hmm_graph.py add_self_loops): all arcs
    # entering a state share that state's pdf
    pdf_state = rng.integers(0, num_pdfs, size=num_states).astype(np.int32)
    arc_pdf = pdf_state[arc_dst]
    arc_score = (-rng.exponential(1.0, size=a)).astype(np.float32)
    alpha0 = np.full(num_states, NEG_INF, np.float32)
    alpha0[0] = 0.0
    return DenseGraph(
        num_states=num_states, arc_src=arc_src, arc_dst=arc_dst,
        arc_tid=arc_pdf, arc_pdf=arc_pdf, arc_score=arc_score,
        arc_oseq=np.zeros_like(arc_src),
        alpha0=alpha0, start_oseq=np.zeros(num_states, np.int32),
        final_score=np.zeros(num_states, np.float32),
        final_oseq=np.zeros(num_states, np.int32), oseqs=[()])


def synth_train_graph(num_states: int, num_pdfs: int, rng) -> DenseGraph:
    """Synthetic training-alignment graph shaped like a real compiled
    LG-level utterance graph (fst/hclg.py TrainingGraphCompiler): a left-to-
    right chain of 3-state HMMs with self-loops and skip arcs."""
    # dst-pure pdfs (all arcs entering a state share its pdf) — the property
    # real compiled training graphs have after reordered self-loop insertion
    # (fst/hmm_graph.py add_self_loops), which the banded alignment kernel
    # (ops/align_band.py) exploits
    pdf_of = rng.integers(0, num_pdfs, size=num_states)
    src, dst, score = [], [], []
    for s in range(num_states):
        src += [s, s]
        dst += [s, min(s + 1, num_states - 1)]
        score += [float(-rng.exponential(0.3)), float(-rng.exponential(0.3))]
        if s + 2 < num_states and rng.random() < 0.25:  # optional-sil skip
            src.append(s)
            dst.append(s + 2)
            score.append(float(-rng.exponential(0.5)))
    pdf = [int(pdf_of[d]) for d in dst]
    alpha0 = np.full(num_states, NEG_INF, np.float32)
    alpha0[0] = 0.0
    final = np.full(num_states, NEG_INF, np.float32)
    final[num_states - 1] = 0.0
    a = len(src)
    return DenseGraph(
        num_states=num_states, arc_src=np.asarray(src, np.int32),
        arc_dst=np.asarray(dst, np.int32), arc_tid=np.asarray(pdf, np.int32),
        arc_pdf=np.asarray(pdf, np.int32),
        arc_score=np.asarray(score, np.float32),
        arc_oseq=np.zeros(a, np.int32), alpha0=alpha0,
        start_oseq=np.zeros(num_states, np.int32), final_score=final,
        final_oseq=np.zeros(num_states, np.int32), oseqs=[()])
