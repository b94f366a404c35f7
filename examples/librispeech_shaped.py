"""LibriSpeech-shaped end-to-end example: the counterpart of the reference's
``TestLibriSpeech`` (``TestDll/TestDll/LibriSpeech.cpp:40-560``: data prep ->
dict+G2P -> lang -> LM -> MFCC+CMVN -> mono -> tri1 (deltas) -> tri2b
(LDA+MLLT) -> tri3b (LDA+MLLT+SAT) -> tri3c (DELTA+SAT) -> HCLG -> decode
-> WER, oracle 5.92% WER; model names follow ``LibriSpeech.cpp:93-94``).

The reference's corpus is real LibriSpeech audio shipped in a separate data
repository (unavailable offline); this uses the formant-synthesized
LibriSpeech-shaped corpus (voicebridge_tpu/testing/) at full scale:
60 speakers x 23 utts ~= 1.4k utts / ~1 h of 16 kHz audio, ~200-word
vocabulary, trigram LM.  Per-stage wall time and audio-s/s are recorded with
StageTimer and written to <workdir>/report.json.

Usage: python examples/librispeech_shaped.py [workdir] [--speakers N]
           [--utts N] [--test-per N] [--seed N]
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("workdir", nargs="?", default="/tmp/librispeech_shaped")
    ap.add_argument("--speakers", type=int, default=60)
    ap.add_argument("--utts", type=int, default=20, help="train utts/speaker")
    ap.add_argument("--test-per", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--snr-db", type=float, default=30.0,
                    help="corpus SNR; 30 = clean (near-zero WER at full "
                         "scale), ~0-5 = noisy condition where the model "
                         "ladder has room to separate")
    ap.add_argument("--mono-iters", type=int, default=20)
    ap.add_argument("--mono-gauss", type=int, default=700)
    ap.add_argument("--leaves", type=int, default=900)
    ap.add_argument("--gauss", type=int, default=5000)
    ap.add_argument("--tri-iters", type=int, default=14)
    args = ap.parse_args(argv)

    from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache
    setdefault_compilation_cache()

    from voicebridge_tpu.config import (DecodeOptions, FmllrDecodeOptions,
                                        FrameOptions, MfccOptions,
                                        MonoTrainOptions, TriTrainOptions)
    from voicebridge_tpu.project import Project
    from voicebridge_tpu.testing import LEXICON, make_corpus
    from voicebridge_tpu.testing.corpus import write_corpus
    from voicebridge_tpu.utils.profiling import StageTimer

    t_start = time.time()
    work = Path(args.workdir)
    waves = work / "waves"
    timer = StageTimer()

    if not (waves / ".done").exists():
        print(f"synthesizing corpus: {args.speakers} speakers x "
              f"{args.utts + args.test_per} utts ...", flush=True)
        with timer.stage("synthesize"):
            train, test, utt2spk = make_corpus(
                num_speakers=args.speakers, utts_per_speaker=args.utts,
                num_test_per=args.test_per, seed=args.seed,
                snr_db=args.snr_db)
            write_corpus(waves, train, test, utt2spk)
            (waves / ".done").write_text("ok")

    # reference-dictionary file so PrepareDict (+G2P fallback) is exercised
    ref_dict = work / "ref_dict.txt"
    if not ref_dict.exists():
        ref_dict.write_text("".join(
            f"{w} {' '.join(prons[0][1])}\n" for w, prons in
            sorted(LEXICON.items())))

    proj = Project(work, waves_dir=waves, ref_dict=ref_dict,
                   name="librispeech_shaped")
    pct_train = round(100 * args.utts / (args.utts + args.test_per))
    with timer.stage("prepare_data"):
        proj.prepare_data(percentage_train=pct_train, order_ngram=3, idtype=0)
    with timer.stage("prepare_dict_lang"):
        proj.prepare_dict_and_lang()

    total_audio = 0.0
    for split in ("train", "test"):
        data = proj.train_data if split == "train" else proj.test_data
        for u, p in data.wav_paths.items():
            total_audio += p.stat().st_size / (2 * 16000.0)
    train_audio = total_audio * pct_train / 100.0
    print(f"corpus: {total_audio:.0f}s audio "
          f"({len(proj.train_data.utts)} train / "
          f"{len(proj.test_data.utts)} test utts)", flush=True)

    with timer.stage("mfcc_cmvn", audio_s=total_audio):
        proj.make_features(MfccOptions(frame_opts=FrameOptions(
            samp_freq=16000.0, dither=1.0)))

    results = {}

    # --- mono ----------------------------------------------------------------
    with timer.stage("train_mono", audio_s=train_audio):
        mono = proj.train_mono(MonoTrainOptions(
            num_iters=args.mono_iters, totgauss=args.mono_gauss,
            max_iter_inc=args.mono_iters - 4,
            realign_iters=tuple(range(1, args.mono_iters, 2))))
    with timer.stage("mkgraph"):
        hclg = proj.mkgraph(mono, "mono")
    print(f"HCLG(mono): {hclg.num_states} states", flush=True)
    test_audio = total_audio - train_audio
    with timer.stage("decode_mono", audio_s=test_audio):
        results["mono"] = proj.decode(mono, hclg, out_name="mono")
    print(f"[mono]      {results['mono'].best_wer}", flush=True)

    # --- tri1 (delta+delta-delta) -------------------------------------------
    tri_opts = TriTrainOptions(
        num_iters=args.tri_iters, num_leaves=args.leaves,
        totgauss=args.gauss, max_iter_inc=args.tri_iters - 4,
        realign_iters=(2, 4, 6, 9, 12), mllt_iters=(2, 4, 6),
        fmllr_iters=(2, 4, 6, 9))
    with timer.stage("align_mono", audio_s=train_audio):
        ali = proj.align(mono)
    with timer.stage("train_tri1", audio_s=train_audio):
        tri1 = proj.train_tri(mono, ali, tri_opts, name="tri1")
    with timer.stage("mkgraph"):
        hclg1 = proj.mkgraph(tri1, "tri1")
    print(f"HCLG(tri1): {hclg1.num_states} states", flush=True)
    with timer.stage("decode_tri1", audio_s=test_audio):
        results["tri1"] = proj.decode(tri1, hclg1, out_name="tri1")
    print(f"[tri1]      {results['tri1'].best_wer}", flush=True)

    # --- tri2b (LDA+MLLT) ----------------------------------------------------
    with timer.stage("align_tri1", audio_s=train_audio):
        ali1 = proj.align(tri1)
    with timer.stage("train_tri2b", audio_s=train_audio):
        tri2b, final_mat = proj.train_lda_mllt(tri1, ali1, tri_opts,
                                               name="tri2b")
    with timer.stage("mkgraph"):
        hclg2 = proj.mkgraph(tri2b, "tri2b")
    with timer.stage("decode_tri2b", audio_s=test_audio):
        results["tri2b"] = proj.decode(tri2b, hclg2, final_mat=final_mat,
                                       out_name="tri2b")
    print(f"[tri2b lda] {results['tri2b'].best_wer}", flush=True)

    # --- tri3b (LDA+MLLT+SAT, the reference's best-accuracy config) ---------
    with timer.stage("align_tri2b", audio_s=train_audio):
        ali2 = proj.align(tri2b, final_mat=final_mat)
    with timer.stage("train_tri3b", audio_s=train_audio):
        sat_lda = proj.train_sat(tri2b, ali2, tri_opts, name="tri3b",
                                 final_mat=final_mat)
    with timer.stage("mkgraph"):
        hclg3 = proj.mkgraph(sat_lda.model, "tri3b")
    with timer.stage("decode_tri3b", audio_s=test_audio):
        results["tri3b"] = proj.decode_fmllr(
            sat_lda, hclg3, FmllrDecodeOptions(fmllr_min_count=100.0),
            final_mat=final_mat)
    print(f"[tri3b lda+sat] {results['tri3b'].best_wer}", flush=True)

    # --- tri3c (DELTA+SAT, the reference's fast config) ---------------------
    with timer.stage("train_tri3c", audio_s=train_audio):
        sat = proj.train_sat(tri1, ali1, tri_opts, name="tri3c")
    with timer.stage("mkgraph"):
        hclg3c = proj.mkgraph(sat.model, "tri3c")
    with timer.stage("decode_tri3c", audio_s=test_audio):
        results["tri3c"] = proj.decode_fmllr(
            sat, hclg3c, FmllrDecodeOptions(fmllr_min_count=100.0))
    print(f"[tri3c sat] {results['tri3c'].best_wer}", flush=True)

    report = {
        "snr_db": args.snr_db,
        "corpus": {"speakers": args.speakers,
                   "train_utts": len(proj.train_data.utts),
                   "test_utts": len(proj.test_data.utts),
                   "audio_s": round(total_audio, 1)},
        "wer": {k: {"wer": round(r.best_wer.wer, 2),
                    "ins": r.best_wer.num_ins, "del": r.best_wer.num_del,
                    "sub": r.best_wer.num_sub, "lmwt": r.best_lmwt}
                for k, r in results.items()},
        "stages": timer.report(),
        "wall_s": round(time.time() - t_start, 1),
    }
    (work / "report.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report["wer"], indent=1))
    print(f"=== total {report['wall_s']}s ===")
    return report


if __name__ == "__main__":
    main()
