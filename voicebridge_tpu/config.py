"""Configuration system: typed option groups + Kaldi-style ``--key=value`` conf files.

Plays the role of the reference's ``ParseOptions`` registry
(``kaldi-master/src/util/parse-options.h:36``) and the per-step ``conf/*.conf``
files (``--config=<file>`` of ``--key=value`` lines, documented in
``TestDll/TestDll/YesNo.cpp:172-180``).  Each option group is a frozen-ish
dataclass; ``load_conf``/``apply_conf`` map conf lines onto dataclass fields
(``--num-mel-bins=23`` -> ``num_mel_bins``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


def _coerce(value: str, typ: Any) -> Any:
    if typ is bool or typ == "bool":
        return value.strip().lower() in ("true", "1", "yes", "t")
    if typ is int or typ == "int":
        return int(value)
    if typ is float or typ == "float":
        return float(value)
    return value


def parse_conf_lines(lines) -> dict[str, str]:
    """Parse ``--key=value`` lines (comments with ``#``, blank lines ignored)."""
    out: dict[str, str] = {}
    for raw in lines:
        line = raw.split("#", 1)[0].strip()
        if not line:
            continue
        if not line.startswith("--"):
            raise ValueError(f"bad conf line (expected --key=value): {raw!r}")
        key, _, val = line[2:].partition("=")
        out[key.strip()] = val.strip()
    return out


def load_conf(path: str | Path) -> dict[str, str]:
    return parse_conf_lines(Path(path).read_text().splitlines())


def apply_conf(opts: Any, conf: dict[str, str], strict: bool = False) -> Any:
    """Return a copy of dataclass ``opts`` with conf overrides applied.

    Conf keys use dashes (``--frame-length``); fields use underscores.
    Unknown keys are ignored unless ``strict`` (they may belong to another
    option group, mirroring how Kaldi steps pass one conf file to several
    binaries).
    """
    fields = {f.name: f for f in dataclasses.fields(opts)}
    updates = {}
    for key, val in conf.items():
        name = key.replace("-", "_")
        if name in fields:
            updates[name] = _coerce(val, fields[name].type)
        elif strict:
            raise KeyError(f"unknown option --{key} for {type(opts).__name__}")
    return dataclasses.replace(opts, **updates) if updates else opts


# ---------------------------------------------------------------------------
# Feature options (reference: feat/feature-window.h:53-61, mel-computations.h:56,
# feature-mfcc.h:61-76)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FrameOptions:
    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    dither: float = 1.0
    preemph_coeff: float = 0.97
    remove_dc_offset: bool = True
    window_type: str = "povey"  # povey|hamming|hanning|rectangular|blackman
    round_to_power_of_two: bool = True
    blackman_coeff: float = 0.42
    snip_edges: bool = True

    @property
    def window_size(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_length_ms)

    @property
    def window_shift(self) -> int:
        return int(self.samp_freq * 0.001 * self.frame_shift_ms)

    @property
    def padded_window_size(self) -> int:
        n = self.window_size
        if not self.round_to_power_of_two:
            return n
        p = 1
        while p < n:
            p *= 2
        return p

    def num_frames(self, num_samples: int) -> int:
        if self.snip_edges:
            if num_samples < self.window_size:
                return 0
            return 1 + (num_samples - self.window_size) // self.window_shift
        return (num_samples + self.window_shift // 2) // self.window_shift


@dataclass(frozen=True)
class MelOptions:
    num_bins: int = 23  # MFCC default (MfccOptions ctor uses 23)
    low_freq: float = 20.0
    high_freq: float = 0.0  # 0 => Nyquist; negative => Nyquist + high_freq
    vtln_low: float = 100.0
    vtln_high: float = -500.0
    # HTK-exact mode (reference: mel-computations.h:52-55, a "hidden" config):
    # floors mel energies at 1.0 before the log and replicates HTK's first-bin
    # quirk; used by the golden-file tests against the shipped HTK features.
    htk_mode: bool = False


@dataclass(frozen=True)
class MfccOptions:
    frame_opts: FrameOptions = field(default_factory=FrameOptions)
    mel_opts: MelOptions = field(default_factory=MelOptions)
    num_ceps: int = 13
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    cepstral_lifter: float = 22.0
    # put energy/C0 last and scale C0 by sqrt(2) when use_energy=False
    # (reference: feature-mfcc.h:47, feature-mfcc.cc:70-80)
    htk_compat: bool = False


@dataclass(frozen=True)
class PlpOptions:
    """PLP feature options (reference: feat/feature-plp.h:42-69)."""

    frame_opts: FrameOptions = field(default_factory=FrameOptions)
    mel_opts: MelOptions = field(default_factory=MelOptions)
    lpc_order: int = 12
    num_ceps: int = 13  # including C0
    use_energy: bool = True
    energy_floor: float = 0.0
    raw_energy: bool = True
    compress_factor: float = 0.33333
    cepstral_lifter: float = 22.0
    cepstral_scale: float = 1.0
    htk_compat: bool = False  # reorder: energy/C0 last (feature-plp.cc:182)


@dataclass(frozen=True)
class DeltaOptions:
    order: int = 2
    window: int = 2


@dataclass(frozen=True)
class SpliceOptions:
    left_context: int = 3
    right_context: int = 3


@dataclass(frozen=True)
class CmvnOptions:
    norm_means: bool = True
    norm_vars: bool = False


# ---------------------------------------------------------------------------
# Training options (reference: scr/steps/train_gmm_mono.cpp:69-148 defaults)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MonoTrainOptions:
    num_iters: int = 40
    max_iter_inc: int = 30
    totgauss: int = 1000
    boost_silence: float = 1.0
    realign_iters: tuple = tuple(
        [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 12, 14, 16, 18, 20, 23, 26, 29, 32, 35, 38]
    )
    power: float = 0.25  # exponent to determine number of gaussians from occurrence counts
    # NOTE: the reference's alignment beam/retry_beam/careful knobs
    # (gmm-align-compiled, decoder-wrappers.cc:424) bound CPU token-passing
    # cost and recover from over-pruning; alignment here is EXACT device
    # Viterbi (beam=inf), which cannot over-prune, so those knobs have no
    # semantics and are intentionally absent.
    transition_scale: float = 1.0
    acoustic_scale: float = 0.1
    self_loop_scale: float = 0.1
    min_gaussian_occupancy: float = 10.0
    min_variance: float = 0.001
    perturb_factor: float = 0.01


@dataclass(frozen=True)
class TriTrainOptions:
    """Shared by train_deltas / train_lda_mllt / train_sat
    (reference: train_deltas.cpp, train_lda_mllt.cpp, train_sat.cpp defaults)."""

    num_iters: int = 35
    max_iter_inc: int = 25
    num_leaves: int = 2000
    totgauss: int = 10000
    realign_iters: tuple = (10, 20, 30)
    mllt_iters: tuple = (2, 4, 6, 12)  # train_lda_mllt.cpp:122
    fmllr_iters: tuple = (2, 4, 6, 12)  # train_sat.cpp
    boost_silence: float = 1.0
    # beam/retry_beam/careful intentionally absent: exact device alignment
    # (see MonoTrainOptions)
    transition_scale: float = 1.0
    acoustic_scale: float = 0.1
    self_loop_scale: float = 0.1
    power: float = 0.25
    cluster_thresh: float = -1.0
    min_gaussian_occupancy: float = 10.0
    min_variance: float = 0.001
    context_width: int = 3
    central_position: int = 1
    fmllr_update_type: str = "full"
    silence_weight: float = 0.0  # weight-silence-post for LDA/MLLT/fMLLR stats


@dataclass(frozen=True)
class LdaOptions:
    dim: int = 40
    within_class_factor: float = 1.0e-4  # reference lda-estimate default
    allow_large_dim: bool = False


# ---------------------------------------------------------------------------
# Decode / scoring options (reference: decode_gmm.cpp, score_kaldi_wer.cpp)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DecodeOptions:
    # beam/max_active prune the device lattice forward-backward pass
    # (ops/lattice.py); best-path decoding is exact and ignores them.
    # min_active (adaptive beam growth, lattice-faster-decoder.cc GetCutoff)
    # is intentionally absent: the dense relaxation cannot starve the
    # frontier, so there is nothing to grow the beam for.
    beam: float = 13.0
    max_active: int = 7000
    lattice_beam: float = 6.0
    acoustic_scale: float = 0.083333
    # Scoring sweep (score_kaldi_wer.cpp: LMWT 7..17 x WIP {0.0,0.5,1.0})
    min_lmwt: int = 7
    max_lmwt: int = 17
    word_ins_penalties: tuple = (0.0, 0.5, 1.0)
    # Device-memory budget (bytes) for the lattice FB working set: bounds
    # the per-dispatch sub-batch (steps/decode.py counts the beta slab,
    # window snapshots, loglikes and the sparse-fetch [K, B] buffers per
    # utterance).  4.6e9 gives sub-batch 128 on the 90k-state bench graph
    # at T=1000.
    lattice_mem_budget: float = 4.6e9


@dataclass(frozen=True)
class FmllrDecodeOptions:
    fmllr_update_type: str = "full"
    fmllr_min_count: float = 500.0  # gmm-est-fmllr --fmllr-min-count
    silence_weight: float = 0.01
    max_active: int = 7000
    beam: float = 13.0
    lattice_beam: float = 6.0
    acoustic_scale: float = 0.083333
    first_beam: float = 10.0  # SI pass
    first_max_active: int = 2000


# ---------------------------------------------------------------------------
# Language / lexicon options (reference: prepare_lang.cpp:53-58)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LangOptions:
    num_sil_states: int = 5
    num_nonsil_states: int = 3
    position_dependent_phones: bool = True
    share_silence_phones: bool = False
    sil_prob: float = 0.5
    oov_word: str = "<UNK>"


@dataclass(frozen=True)
class LmOptions:
    order: int = 3
    smoothing: str = "modkn"  # modified Kneser-Ney (MITLM's ModKN default)


@dataclass(frozen=True)
class MeshOptions:
    """Device-mesh layout for pjit/shard_map execution."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = 0  # 0 => all devices
    model_parallel: int = 1
