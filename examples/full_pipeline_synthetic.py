"""Full pipeline example: mono -> triphone -> LDA+MLLT -> SAT/fMLLR, the
counterpart of the reference's ``TestLibriSpeech``
(``TestDll/TestDll/LibriSpeech.cpp:40-560``: mono -> tri1 -> tri3c DELTA+SAT,
plus the LDA+MLLT variant), on a synthetic multi-speaker corpus.

Usage: python examples/full_pipeline_synthetic.py [workdir]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))


def main(workdir: str = "/tmp/full_pipeline_project"):
    from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache
    setdefault_compilation_cache()
    from synth import LEXICON, make_speaker_corpus
    from voicebridge_tpu.config import (DecodeOptions, FmllrDecodeOptions,
                                        FrameOptions, MfccOptions,
                                        MonoTrainOptions, TriTrainOptions)
    from voicebridge_tpu.project import Project
    from voicebridge_tpu.utils.wave import write_wave

    t0 = time.time()
    work = Path(workdir)
    waves = work / "waves"
    if not waves.exists():
        train, test, utt2spk = make_speaker_corpus(
            num_speakers=6, utts_per_speaker=6, num_test_per=2, seed=5)
        for utt, (wave, words) in {**train, **test}.items():
            spk = utt2spk[utt]
            write_wave(waves / spk / f"{utt}.wav", 8000, wave)
            (waves / spk / f"{utt}.txt").write_text(" ".join(words))

    proj = Project(work, waves_dir=waves, name="full")
    proj.prepare_data(percentage_train=75, order_ngram=2, idtype=0)
    proj.set_lexicon(LEXICON)
    proj.make_features(MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0,
                                                           dither=0.0)))

    # --- mono ---------------------------------------------------------------
    mono = proj.train_mono(MonoTrainOptions(
        num_iters=12, totgauss=180, max_iter_inc=9,
        realign_iters=tuple(range(1, 12))))
    hclg = proj.mkgraph(mono, "mono")
    r_mono = proj.decode(mono, hclg, opts=DecodeOptions(beam=1e9))
    print(f"[mono]      {r_mono.best_wer}")

    # --- tri1 (delta+delta-delta) ------------------------------------------
    ali = proj.align(mono)
    tri_opts = TriTrainOptions(num_iters=10, num_leaves=150, totgauss=400,
                               max_iter_inc=8, realign_iters=(2, 4, 6, 8),
                               mllt_iters=(2, 4), fmllr_iters=(2, 4, 6))
    tri1 = proj.train_tri(mono, ali, tri_opts, name="tri1")
    hclg1 = proj.mkgraph(tri1, "tri1")
    r_tri = proj.decode(tri1, hclg1, opts=DecodeOptions(beam=1e9))
    print(f"[tri1]      {r_tri.best_wer}")

    # --- tri2b (LDA+MLLT) ---------------------------------------------------
    ali1 = proj.align(tri1)
    tri2b, final_mat = proj.train_lda_mllt(tri1, ali1, tri_opts, name="tri2b")
    hclg2 = proj.mkgraph(tri2b, "tri2b")
    r_lda = proj.decode(tri2b, hclg2, final_mat=final_mat,
                        opts=DecodeOptions(beam=1e9))
    print(f"[tri2b lda] {r_lda.best_wer}")

    # --- tri3b (DELTA+SAT) --------------------------------------------------
    sat = proj.train_sat(tri1, ali1, tri_opts, name="tri3b")
    hclg3 = proj.mkgraph(sat.model, "tri3b")
    r_sat = proj.decode_fmllr(sat, hclg3,
                              FmllrDecodeOptions(beam=1e9, first_beam=1e9,
                                                 fmllr_min_count=100.0))
    print(f"[tri3b sat] {r_sat.best_wer}")
    print(f"\n=== full pipeline in {time.time()-t0:.1f}s ===")
    return dict(mono=r_mono, tri1=r_tri, tri2b=r_lda, tri3b=r_sat)


if __name__ == "__main__":
    main(*sys.argv[1:])
