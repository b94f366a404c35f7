"""Yes-No example: the full pipeline through the Project API, from wav files
on disk to WER — the counterpart of the reference's ``TestYesNo``
(``TestDll/TestDll/YesNo.cpp:32-260``).

The reference's Yes-No audio ships separately; this example synthesizes an
equivalent corpus (two tone-words + silence; see ``tests/synth.py``) into a
waves directory, then runs:

    PrepareData -> (lexicon) -> PrepareLang -> MakeMfcc+CMVN ->
    TrainGmmMono -> MkGraph -> Decode (LMWT sweep) -> WER

Usage:  python examples/yesno_synthetic.py [workdir]
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))

import numpy as np


def main(workdir: str = "/tmp/yesno_project"):
    from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache
    setdefault_compilation_cache()
    from synth import LEXICON, make_corpus
    from voicebridge_tpu.config import (DecodeOptions, FrameOptions,
                                        MfccOptions, MonoTrainOptions)
    from voicebridge_tpu.project import Project
    from voicebridge_tpu.utils.wave import write_wave

    t0 = time.time()
    work = Path(workdir)
    waves = work / "waves"
    if not waves.exists():
        train, test, = make_corpus(num_train=24, num_test=8, seed=7)
        for utt, (wave, words) in {**train, **test}.items():
            spk = "global"
            write_wave(waves / spk / f"{utt}.wav", 8000, wave)
            (waves / spk / f"{utt}.txt").write_text(" ".join(words))

    proj = Project(work, waves_dir=waves, name="yesno")
    proj.prepare_data(percentage_train=75, order_ngram=2, idtype=1)
    proj.set_lexicon(LEXICON)
    proj.make_features(MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0,
                                                           dither=0.0)))
    mono = proj.train_mono(MonoTrainOptions(
        num_iters=14, totgauss=200, max_iter_inc=10,
        realign_iters=tuple(range(1, 14))))
    hclg = proj.mkgraph(mono, "mono")
    result = proj.decode(mono, hclg, opts=DecodeOptions(beam=1e9))
    print(f"\n=== Yes-No synthetic: {result.best_wer} "
          f"(LMWT {result.best_lmwt}) in {time.time()-t0:.1f}s ===")
    return result


if __name__ == "__main__":
    main(*sys.argv[1:])
