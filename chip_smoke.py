"""Smoke run of the recognizer's main path on one NVIDIA GPU.

Usage:
    python chip_smoke.py           # phases 0-5 on one GPU
    python chip_smoke.py --four    # the multi-device path on four GPUs

Phases, in order, each printing one JSON line whose numbers name the device
they ran on:

0. device     -- platform, device kind and count, ``nvidia-smi`` name and
                 power limit, ``XLA_FLAGS``, compile-cache directory, and
                 whether the native WFST/pitch library loaded.
1. loglik     -- ``ops/gmm_kernels.loglikes_batch`` at the DELTA+SAT width
                 (2000 pdfs x 5 mixtures x 39 dims), B=128, T=1024, against a
                 float64 numpy reference; then ``MfccExtractor.batched`` at
                 131072 and 262144 frames per dispatch, against the same
                 function on the host CPU device.
2. decode     -- synthetic 60k-state graph, B=128, T=1000, through
                 ``ops/decode_core.decode_best_path``.
3. real_hclg  -- the ~90k-state compiled HCLG of ``tools/bench_real_graph``
                 through ``steps/decode.Decoder``: ``decode_batch`` and
                 ``decode_lattice``, against the plain reference Viterbi.
4. train      -- one EM iteration, B=192, T=400, 384-state training graphs,
                 through ``steps/align.AlignmentSet`` (banded kernel) and
                 ``acc_gmm_stats_aligned``, against the generic aligner and a
                 float64 numpy accumulation.
5. pipeline   -- the ``Project`` entry points on a seeded synthetic corpus:
                 features, mono training, HCLG, lattice decode + LMWT x WIP
                 sweep, WER.

With ``--four`` only phase 0 and ``__graft_entry__.dryrun_multichip(4)`` run.
The last line is ``{"ok": true, "device": {...}}`` when every phase passed.
Without a GPU, or when any phase fails, the script exits non-zero and prints
no such line.  Everything runs in this one process, so one JAX process holds
the card.  Each phase is a function that takes its sizes as arguments.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

FRAME_S = 0.01  # 10 ms frame shift


def _kind() -> str:
    import jax

    return jax.devices()[0].device_kind


def _peak_bytes():
    """Peak device bytes in use since the process started (None where the
    backend keeps no such statistic)."""
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _timed(fn, iters: int):
    """(first-call seconds, median of ``iters`` later calls, last result).
    ``fn`` must block until its device work is done."""
    t0 = time.perf_counter()
    out = fn()
    first = time.perf_counter() - t0
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn()
        walls.append(time.perf_counter() - t0)
    return first, float(np.median(walls)), out


def _random_am(num_pdfs: int, num_mix: int, dim: int, seed: int):
    from voicebridge_tpu.models.gmm import AmDiagGmm

    rng = np.random.default_rng(seed)
    return AmDiagGmm(
        rng.standard_normal((num_pdfs, num_mix, dim)).astype(np.float32),
        (np.abs(rng.standard_normal((num_pdfs, num_mix, dim))) + 0.5
         ).astype(np.float32),
        np.full((num_pdfs, num_mix), 1.0 / num_mix, np.float32))


def loglik_reference(am, x: np.ndarray, pdf_ids=None) -> np.ndarray:
    """float64 per-pdf log-likelihoods ``[N, D] -> [N, P]`` (or ``[N]`` for
    one pdf per frame): logsumexp over mixtures of
    ``gconst + miv.x - 0.5 iv.x^2`` (models/gmm.py AmDiagGmm.loglike)."""
    x = np.asarray(x, np.float64)
    gc = am.gconsts.astype(np.float64)
    miv = am.means_invvars.astype(np.float64)
    iv = am.inv_vars.astype(np.float64)
    if pdf_ids is None:
        comp = (gc[None] + np.einsum("nd,pmd->npm", x, miv)
                - 0.5 * np.einsum("nd,pmd->npm", x * x, iv))
    else:
        comp = (gc[pdf_ids] + np.einsum("nd,nmd->nm", x, miv[pdf_ids])
                - 0.5 * np.einsum("nd,nmd->nm", x * x, iv[pdf_ids]))
    m = comp.max(axis=-1, keepdims=True)
    return (m + np.log(np.exp(comp - m).sum(axis=-1, keepdims=True)))[..., 0]


# ---------------------------------------------------------------------------
# phase 0: device
# ---------------------------------------------------------------------------


def nvidia_smi() -> list[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


def phase_device(cache_dir: str, smi: list[str]) -> dict:
    import jax

    from voicebridge_tpu.native import load_library

    devs = jax.devices()
    return {"phase": "device", "platform": devs[0].platform,
            "device_kind": devs[0].device_kind, "device_count": len(devs),
            "nvidia_smi": smi, "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "compile_cache_dir": cache_dir,
            "native_library_loaded": load_library() is not None}


# ---------------------------------------------------------------------------
# phase 1: loglik and features
# ---------------------------------------------------------------------------


def phase_loglik(num_pdfs: int = 2000, num_mix: int = 5, dim: int = 39,
                 batch: int = 128, frames: int = 1024, n_check: int = 4096,
                 iters: int = 3, seed: int = 0) -> dict:
    """XLA loglik at Precision.HIGHEST against float64 numpy.  cuBLAS sums
    in another order than the host and the values are O(100), hence
    ``rtol=2e-5, atol=1e-3``."""
    import jax
    import jax.numpy as jnp

    from voicebridge_tpu.ops import gmm_kernels as K

    am = _random_am(num_pdfs, num_mix, dim, seed)
    params = K.pack_gmm(am)
    rng = np.random.default_rng(seed + 1)
    feats_np = rng.standard_normal((batch, frames, dim)).astype(np.float32)
    feats = jnp.asarray(feats_np)
    t0 = time.perf_counter()
    compiled = K.loglikes_batch.lower(params, feats).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    _first, wall, ll = _timed(
        lambda: jax.block_until_ready(compiled(params, feats)), iters)

    n = min(n_check, batch * frames)
    flat = rng.choice(batch * frames, size=n, replace=False)
    bi, ti = flat // frames, flat % frames
    got = np.asarray(ll[jnp.asarray(bi), jnp.asarray(ti)])
    want = loglik_reference(am, feats_np[bi, ti])
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-3)
    return {
        "phase": "loglik", "device": _kind(),
        "shape": {"batch": batch, "frames": frames, "pdfs": num_pdfs,
                  "mix": num_mix, "dim": dim},
        "compile_s": compile_s, "op_ms": wall * 1e3,
        "frames_per_s": batch * frames / wall,
        "max_abs_err_vs_f64": err, "checked_frames": int(n),
        "memory_analysis": {
            k: getattr(mem, k, None) for k in
            ("argument_size_in_bytes", "output_size_in_bytes",
             "temp_size_in_bytes", "generated_code_size_in_bytes")},
    }


def phase_features(frames_per_dispatch=(131072, 262144),
                   frames_per_utt: int = 1024, n_check: int = 8,
                   iters: int = 3, seed: int = 0) -> dict:
    """``MfccExtractor.batched`` throughput at each dispatch size, and
    ``n_check`` utterances against the same function on the host CPU
    device.  cuFFT and the CPU FFT round differently: ``rtol=1e-4,
    atol=1e-3``."""
    import jax

    from voicebridge_tpu.config import FrameOptions, MfccOptions
    from voicebridge_tpu.ops.features import MfccExtractor

    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=16000.0, dither=0.0))
    fo = opts.frame_opts
    samples = fo.window_size + (frames_per_utt - 1) * fo.window_shift
    rng = np.random.default_rng(seed)
    ext = MfccExtractor(opts)
    out = {"phase": "features", "device": _kind(),
           "frames_per_utt": frames_per_utt, "dispatch": []}
    waves = None
    for total in frames_per_dispatch:
        b = max(1, total // frames_per_utt)
        waves = (rng.standard_normal((b, samples)) * 1000).astype(np.float32)
        ns = np.full(b, samples, np.int64)
        first, wall, (feats, counts) = _timed(
            lambda: jax.block_until_ready(
                ext.batched(waves, ns, frames_per_utt)), iters)
        out["dispatch"].append({"frames": b * frames_per_utt,
                                "first_call_s": first, "ms": wall * 1e3,
                                "frames_per_s": b * frames_per_utt / wall})
    k = min(n_check, waves.shape[0])
    got = np.asarray(feats[:k])
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(MfccExtractor(opts).batched(
            waves[:k], np.full(k, samples, np.int64), frames_per_utt)[0])
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    assert (np.asarray(counts) == frames_per_utt).all()
    out["max_abs_err_vs_cpu"] = err
    return out


# ---------------------------------------------------------------------------
# phase 2: decode over the synthetic flagship graph
# ---------------------------------------------------------------------------


def phase_decode(num_states: int = 60_000, num_pdfs: int = 2000,
                 num_mix: int = 5, dim: int = 39, batch: int = 128,
                 frames: int = 1000, chunk: int = 500, iters: int = 3,
                 seed: int = 1) -> dict:
    import jax.numpy as jnp

    from voicebridge_tpu.ops import decode_core as DC
    from voicebridge_tpu.ops import gmm_kernels as K
    from voicebridge_tpu.testing.graphs import synth_decode_graph

    am = _random_am(num_pdfs, num_mix, dim, seed)
    params = K.pack_gmm(am)
    graph = synth_decode_graph(num_states=num_states, num_pdfs=num_pdfs)
    plan = DC.build_emit_plan(graph, d=8)
    dev = DC.plan_to_device(plan)
    rng = np.random.default_rng(seed + 1)
    feats = jnp.asarray(rng.standard_normal((batch, frames, dim)),
                        jnp.float32)
    nf = np.full(batch, frames, np.int32)

    def run():  # ends in a host fetch of the best paths
        ll = K.loglikes_batch(params, feats)
        return DC.decode_best_path(graph, plan, dev, ll, nf,
                                   acoustic_scale=1.0 / 13.0, chunk=chunk)

    first, wall, out = _timed(run, iters)
    assert all(len(r["arcs"]) == frames for r in out), "no full path"
    assert all(np.isfinite(r["score"]) for r in out)
    return {"phase": "decode", "device": _kind(),
            "shape": {"states": num_states, "rows": plan.num_rows,
                      "batch": batch, "frames": frames, "pdfs": num_pdfs,
                      "mix": num_mix},
            "compile_and_first_call_s": first, "wall_s": wall,
            "audio_s_per_s": batch * frames * FRAME_S / wall,
            "peak_bytes_in_use": _peak_bytes()}


# ---------------------------------------------------------------------------
# phase 3: the production Decoder over a real compiled HCLG
# ---------------------------------------------------------------------------


def reference_best_paths(graph, ll, num_frames, acoustic_scale: float):
    """Plain arc-parallel Viterbi (ops/viterbi.viterbi_forward_shared +
    backtrace_shared): the reference the production decoder must equal."""
    import jax.numpy as jnp

    from voicebridge_tpu.ops import viterbi as V

    levels = tuple(jnp.asarray(x) for x in V.build_reduction_plan(
        graph.arc_dst, graph.num_states).levels)
    alpha_end, bps = V.viterbi_forward_shared(
        jnp.asarray(graph.arc_src), levels, jnp.asarray(graph.arc_pdf),
        jnp.asarray(graph.arc_score), jnp.asarray(graph.alpha0),
        jnp.asarray(ll), jnp.asarray(num_frames),
        np.float32(acoustic_scale), np.float32(1e9), graph.num_states)
    return V.backtrace_shared(graph, np.asarray(alpha_end), np.asarray(bps),
                              np.asarray(num_frames))


def phase_real_hclg(num_sentences: int = 1200, batch: int = 128,
                    frames: int = 1000, n_check: int = 8, iters: int = 3,
                    lattice_iters: int = 3, seed: int = 2) -> dict:
    """Best path and lattice through ``Decoder``.  ``n_check`` utterances'
    best paths equal the plain reference (words, score at ``rtol=1e-5``),
    and each of their lattices contains that best path."""
    import jax.numpy as jnp

    from tools.bench_real_graph import (graph_walk_feats, load_or_build,
                                        make_decoder)
    from voicebridge_tpu.lat import lattice_best_path

    t0 = time.perf_counter()
    hclg, tm, tree, _lang = load_or_build(num_sentences)
    decoder, am, _dim = make_decoder(hclg, tm, tree)
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    feats = graph_walk_feats(decoder.graph, am, batch, frames, rng)
    nf = np.full(batch, frames, np.int32)
    utts = [f"u{i:04d}" for i in range(batch)]
    acwt = decoder.opts.acoustic_scale

    first_bp, wall_bp, best = _timed(
        lambda: decoder.decode_batch(utts, feats, nf), iters)
    first_lat, wall_lat, lats = _timed(
        lambda: decoder.decode_lattice(utts, feats, nf), lattice_iters)

    k = min(n_check, batch)
    ll = decoder._loglikes(jnp.asarray(feats[:k]))
    ref = reference_best_paths(decoder.graph, ll, nf[:k], acwt)
    for r, want in zip(best[:k], ref):
        assert r.words == want["words"], (r.utt, r.words, want["words"])
        np.testing.assert_allclose(r.score, want["score"], rtol=1e-5)
        lat_words = lattice_best_path(lats[r.utt], 1.0, acwt)["words"]
        assert lat_words == want["words"], (r.utt, lat_words)
    arcs = [lats[u].num_arcs for u in utts]
    audio = batch * frames * FRAME_S
    return {"phase": "real_hclg", "device": _kind(),
            "shape": {"states": decoder.graph.num_states,
                      "rows": decoder.plan.num_rows, "pdfs": tree.num_pdfs,
                      "batch": batch, "frames": frames},
            "graph_and_decoder_setup_s": setup_s,
            "best_path": {"compile_and_first_call_s": first_bp,
                          "wall_s": wall_bp,
                          "audio_s_per_s": audio / wall_bp},
            "lattice": {"compile_and_first_call_s": first_lat,
                        "wall_s": wall_lat,
                        "audio_s_per_s": audio / wall_lat,
                        "mean_arcs": float(np.mean(arcs))},
            "checked_utts": k, "peak_bytes_in_use": _peak_bytes()}


# ---------------------------------------------------------------------------
# phase 4: one EM training iteration
# ---------------------------------------------------------------------------


def generic_alignment(graphs, ll, num_frames, acoustic_scale: float):
    """Alignment through the generic per-utterance kernel
    (ops/viterbi.viterbi_forward_batched), the banded kernel's reference."""
    import jax.numpy as jnp

    from voicebridge_tpu.ops import viterbi as V

    p = V.pad_graphs(graphs)
    nf = jnp.asarray(num_frames)
    alpha_end, bps = V.viterbi_forward_batched(
        p["arc_src"], p["levels"], p["arc_pdf"], p["arc_score"],
        p["alpha0"], jnp.asarray(ll), nf, np.float32(acoustic_scale),
        np.float32(1e9), p["num_states"])
    arcs, ok, end_state, score = V.backtrace_batched_device(
        jnp.asarray(p["arc_src"]), alpha_end,
        jnp.asarray(p["final_score"]), bps, nf)
    return V.assemble_batched_results(
        graphs, np.asarray(arcs), np.asarray(ok), np.asarray(end_state),
        np.asarray(score), np.asarray(num_frames))


def stats_reference(am, x: np.ndarray, pdf_ids: np.ndarray):
    """float64 (occupancy [P, M], mean statistics [P, M, D]) for frames
    ``x`` aligned to ``pdf_ids``."""
    x = np.asarray(x, np.float64)
    gc = am.gconsts.astype(np.float64)[pdf_ids]
    comp = (gc + np.einsum("nd,nmd->nm", x, am.means_invvars[pdf_ids])
            - 0.5 * np.einsum("nd,nmd->nm", x * x, am.inv_vars[pdf_ids]))
    gamma = np.exp(comp - comp.max(axis=1, keepdims=True))
    gamma /= gamma.sum(axis=1, keepdims=True)
    occ = np.zeros(am.gconsts.shape)
    mean = np.zeros(am.means_invvars.shape)
    np.add.at(occ, pdf_ids, gamma)
    np.add.at(mean, pdf_ids, gamma[:, :, None] * x[:, None, :])
    return occ, mean


def phase_train(batch: int = 192, frames: int = 400, graph_states: int = 384,
                num_pdfs: int = 2000, num_mix: int = 5, dim: int = 39,
                n_check: int = 8, iters: int = 3, seed: int = 3) -> dict:
    """The banded alignment must be chosen and equal the generic one on
    ``n_check`` utterances (arcs; score at ``rtol=1e-5``); the device
    statistics over those utterances equal a float64 numpy accumulation at
    ``rtol=1e-4`` (atol 1e-4 of the largest entry).  Segment sums run as
    scatter-adds in no fixed order on the GPU."""
    import jax
    import jax.numpy as jnp

    from voicebridge_tpu.ops import gmm_kernels as K
    from voicebridge_tpu.steps.align import AlignmentSet
    from voicebridge_tpu.testing.graphs import synth_train_graph

    rng = np.random.default_rng(seed)
    am = _random_am(num_pdfs, num_mix, dim, seed)
    params = K.pack_gmm(am)
    graphs = [synth_train_graph(graph_states, num_pdfs, rng)
              for _ in range(batch)]
    aset = AlignmentSet(graphs)
    assert aset.band is not None, "banded alignment kernel not chosen"
    feats_np = rng.standard_normal((batch, frames, dim)).astype(np.float32)
    feats = jnp.asarray(feats_np)
    nf = np.full(batch, frames, np.int32)
    ones = jnp.ones((batch * frames,), jnp.float32)
    acwt = 0.1

    def em_iter():
        ll = K.loglikes_batch(params, feats)
        alis = aset.align(ll, nf, acoustic_scale=acwt)
        pdf_ids = np.stack([graphs[i].arc_pdf[r["arcs"]]
                            for i, r in enumerate(alis)])
        stats = K.acc_gmm_stats_aligned(
            params, feats.reshape(-1, dim), jnp.asarray(pdf_ids).reshape(-1),
            num_pdfs, ones)
        return ll, alis, pdf_ids, jax.block_until_ready(stats)

    first, wall, (ll, alis, pdf_ids, _stats) = _timed(em_iter, iters)
    assert all(len(r["arcs"]) == frames for r in alis), "alignment failed"

    k = min(n_check, batch)
    want = generic_alignment(graphs[:k], ll[:k], nf[:k], acwt)
    for got, ref in zip(alis[:k], want):
        assert got["arcs"] == ref["arcs"]
        np.testing.assert_allclose(got["score"], ref["score"], rtol=1e-5)
    x_k = feats_np[:k].reshape(-1, dim)
    p_k = pdf_ids[:k].reshape(-1)
    occ, macc, _vacc, _ll = K.acc_gmm_stats_aligned(
        params, jnp.asarray(x_k), jnp.asarray(p_k), num_pdfs,
        jnp.ones(len(p_k), jnp.float32))
    occ_ref, macc_ref = stats_reference(am, x_k, p_k)
    for got, ref in ((occ, occ_ref), (macc, macc_ref)):
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    return {"phase": "train", "device": _kind(),
            "shape": {"batch": batch, "frames": frames,
                      "graph_states": graph_states, "pdfs": num_pdfs,
                      "mix": num_mix},
            "kernel": "banded", "compile_and_first_call_s": first,
            "wall_s": wall,
            "audio_s_per_s": batch * frames * FRAME_S / wall,
            "checked_utts": k, "peak_bytes_in_use": _peak_bytes()}


# ---------------------------------------------------------------------------
# phase 5: the Project pipeline
# ---------------------------------------------------------------------------


def phase_pipeline(num_speakers: int = 8, train_per_speaker: int = 4,
                   test_per_speaker: int = 2, mono_iters: int = 4,
                   totgauss: int = 300, seed: int = 0) -> dict:
    """prepare_data -> dict+lang -> features -> train_mono -> mkgraph ->
    lattice decode + LMWT x WIP sweep -> WER, as
    examples/librispeech_shaped.py runs them."""
    from voicebridge_tpu.config import (FrameOptions, MfccOptions,
                                        MonoTrainOptions)
    from voicebridge_tpu.project import Project
    from voicebridge_tpu.testing import LEXICON, make_corpus
    from voicebridge_tpu.testing.corpus import write_corpus
    from voicebridge_tpu.utils.profiling import StageTimer

    timer = StageTimer()
    with tempfile.TemporaryDirectory(prefix="vb_smoke_") as tmp:
        work = Path(tmp)
        with timer.stage("synthesize"):
            train, test, utt2spk = make_corpus(
                num_speakers=num_speakers,
                utts_per_speaker=train_per_speaker,
                num_test_per=test_per_speaker, seed=seed)
            write_corpus(work / "waves", train, test, utt2spk)
        ref_dict = work / "ref_dict.txt"
        ref_dict.write_text("".join(
            f"{w} {' '.join(prons[0][1])}\n"
            for w, prons in sorted(LEXICON.items())))
        proj = Project(work, waves_dir=work / "waves", ref_dict=ref_dict,
                       name="smoke")
        pct = round(100 * train_per_speaker
                    / (train_per_speaker + test_per_speaker))
        with timer.stage("prepare_data"):
            proj.prepare_data(percentage_train=pct, order_ngram=3, idtype=0)
        with timer.stage("prepare_dict_lang"):
            proj.prepare_dict_and_lang()
        with timer.stage("mfcc_cmvn"):
            proj.make_features(MfccOptions(frame_opts=FrameOptions(
                samp_freq=16000.0, dither=1.0)))
        with timer.stage("train_mono"):
            mono = proj.train_mono(MonoTrainOptions(
                num_iters=mono_iters, totgauss=totgauss,
                max_iter_inc=max(1, mono_iters - 1),
                realign_iters=tuple(range(1, mono_iters, 2))))
        with timer.stage("mkgraph"):
            hclg = proj.mkgraph(mono, "mono")
        with timer.stage("decode"):
            res = proj.decode(mono, hclg, out_name="mono")
        test_utts = set(proj.test_data.utts)
        lines = (proj.exp_dir / "mono" / "decode" / "transcription.txt"
                 ).read_text().splitlines()
        decoded = {line.split()[0] for line in lines if line.strip()}
        assert decoded == test_utts, \
            f"decoded {len(decoded)} of {len(test_utts)} test utterances"
        wer = float(res.best_wer.wer)
        assert np.isfinite(wer), wer
    return {"phase": "pipeline", "device": _kind(),
            "corpus": {"speakers": num_speakers,
                       "test_utts": len(test_utts)},
            "wer": wer, "best_lmwt": res.best_lmwt,
            "hclg_states": hclg.num_states,
            "stage_wall_s": {k: v["wall_s"]
                             for k, v in timer.report().items()}}


# ---------------------------------------------------------------------------


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device path on four GPUs")
    args = ap.parse_args(argv)

    from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache

    cache_dir = setdefault_compilation_cache()
    import jax

    devs = jax.devices()
    need = 4 if args.four else 1
    if devs[0].platform != "gpu" or len(devs) < need:
        print(f"chip_smoke: needs {need} NVIDIA GPU(s); JAX found "
              f"{len(devs)} {devs[0].platform} device(s)", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    for line in smi:
        print(line, flush=True)
    _emit(phase_device(cache_dir, smi))
    if args.four:
        from __graft_entry__ import dryrun_multichip

        _emit({"phase": "four", "device": devs[0].device_kind,
               **dryrun_multichip(4)})
    else:
        for phase in (phase_loglik, phase_features, phase_decode,
                      phase_real_hclg, phase_train, phase_pipeline):
            t0 = time.perf_counter()
            rec = phase()
            rec["phase_wall_s"] = time.perf_counter() - t0
            _emit(rec)
    _emit({"ok": True, "device": {"platform": devs[0].platform,
                                  "kind": devs[0].device_kind,
                                  "count": len(devs)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
