"""chip_smoke phase 5 (the Project pipeline) at a tiny corpus on the CPU."""

import numpy as np

import chip_smoke as cs


def test_phase_pipeline_tiny():
    rec = cs.phase_pipeline(num_speakers=2, train_per_speaker=2,
                            test_per_speaker=1, mono_iters=2, totgauss=100)
    assert rec["corpus"]["test_utts"] == 2
    assert np.isfinite(rec["wer"])
    assert set(rec["stage_wall_s"]) >= {"mfcc_cmvn", "train_mono", "decode"}
