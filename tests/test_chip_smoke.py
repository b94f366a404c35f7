"""chip_smoke.py off the card: main() refuses a non-GPU device, the script
fails alone outside the repo, and every phase runs at tiny sizes on the CPU
(the chip run uses the same functions at full width)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import chip_smoke as cs
from voicebridge_tpu.utils import jax_cache

REPO = Path(__file__).resolve().parent.parent


def test_main_refuses_cpu(monkeypatch, capsys):
    monkeypatch.setattr(jax_cache, "setdefault_compilation_cache",
                        lambda: "unused")
    assert cs.main([]) != 0
    assert cs.main(["--four"]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_fails_alone_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_loglik_tiny():
    rec = cs.phase_loglik(num_pdfs=20, num_mix=3, dim=5, batch=2, frames=16,
                          n_check=20, iters=1)
    assert rec["max_abs_err_vs_f64"] < 1e-3 and rec["device"]
    json.dumps(rec)


def test_loglik_reference_matches_model():
    am = cs._random_am(6, 3, 4, seed=5)
    x = np.random.default_rng(6).standard_normal((5, 4))
    ref = cs.loglik_reference(am, x)
    want = [[am.loglike(p, xi) for p in range(6)] for xi in x]
    np.testing.assert_allclose(ref, want, rtol=1e-12)
    one = cs.loglik_reference(am, x, np.arange(5) % 6)
    np.testing.assert_allclose(one, ref[np.arange(5), np.arange(5) % 6])


def test_phase_features_tiny():
    rec = cs.phase_features(frames_per_dispatch=(64, 128), frames_per_utt=32,
                            n_check=2, iters=1)
    assert [d["frames"] for d in rec["dispatch"]] == [64, 128]
    assert rec["max_abs_err_vs_cpu"] == 0.0


def test_phase_decode_tiny():
    rec = cs.phase_decode(num_states=200, num_pdfs=20, dim=5, batch=2,
                          frames=20, chunk=10, iters=1)
    assert rec["audio_s_per_s"] > 0


def test_phase_real_hclg_tiny():
    rec = cs.phase_real_hclg(num_sentences=5, batch=2, frames=50, n_check=2,
                             iters=1, lattice_iters=1)
    assert rec["checked_utts"] == 2 and rec["lattice"]["mean_arcs"] > 0


def test_phase_train_tiny():
    rec = cs.phase_train(batch=3, frames=40, graph_states=12, num_pdfs=11,
                         dim=5, n_check=2, iters=1)
    assert rec["kernel"] == "banded" and rec["checked_utts"] == 2


@pytest.mark.gpu
def test_phase_loglik_on_gpu(gpu_device):
    import jax

    with jax.default_device(gpu_device):
        rec = cs.phase_loglik(num_pdfs=200, batch=4, frames=128,
                              n_check=256, iters=1)
    assert rec["max_abs_err_vs_f64"] < 1e-2
