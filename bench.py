"""Benchmark: decode and train throughput (audio-seconds per second).

Workloads, each at the DELTA+SAT model width (2000 pdfs x 5 mixtures x 39
dims, 10k Gaussians, ops/gmm_kernels.loglikes_batch at Precision.HIGHEST):

* ``decode``: loglikes + the 1-best Viterbi decode (forward scan + device
  backtrace + host word assembly) over an HCLG-shaped synthetic graph (60k
  states / 480k arcs), B=128, T=1000.
* ``real_hclg_best_path`` / ``real_hclg_lattice`` /
  ``real_hclg_lattice_realistic``: the production ``steps/decode.Decoder``
  over a real compiled ~90k-state HCLG (tools/bench_real_graph.py): best
  path, lattice at worst-case density, lattice at realistic density.
* ``train``: one EM iteration (loglikes + banded alignment + aligned E-step
  statistics), B=192, T=400, 384-state training graphs.

10 ms frame shift => 1 frame = 0.01 audio seconds.

Each workload runs in its own child process, one after another, so only one
JAX process holds the device at a time.  Every record names the device it
ran on.  A workload that fails or times out makes the run exit non-zero.
Prints one JSON line per workload and a merged JSON line last.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from voicebridge_tpu.testing.graphs import (  # noqa: E402
    synth_decode_graph, synth_train_graph)
from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache  # noqa: E402


def run_config(num_states: int, b: int, t: int):
    """Runs inside the subprocess: full decode, prints one JSON line."""
    import jax.numpy as jnp

    from voicebridge_tpu.models.gmm import AmDiagGmm
    from voicebridge_tpu.ops import decode_core as DC
    from voicebridge_tpu.ops import gmm_kernels as K

    rng = np.random.default_rng(1)
    num_pdfs, max_mix, dim = 2000, 5, 39  # ~10k Gaussians (DELTA+SAT scale)
    am = AmDiagGmm(
        rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32),
        np.abs(rng.standard_normal((num_pdfs, max_mix, dim))).astype(np.float32) + 0.5,
        np.full((num_pdfs, max_mix), 1.0 / max_mix, np.float32),
    )
    params = K.pack_gmm(am)
    graph = synth_decode_graph(num_states=num_states, num_pdfs=num_pdfs)
    plan = DC.build_emit_plan(graph, d=8)
    dev = DC.plan_to_device(plan)
    feats = jnp.asarray(rng.standard_normal((b, t, dim)), jnp.float32)
    num_frames = np.full((b,), t, np.int32)

    def decode_full():
        ll = K.loglikes_batch(params, feats)
        return DC.decode_best_path(graph, plan, dev, ll, num_frames,
                                   acoustic_scale=1.0 / 13.0, chunk=500)

    out = decode_full()  # compile + run
    assert all(len(r["arcs"]) == t for r in out), "no path found"
    iters = 3
    start = time.perf_counter()
    for _ in range(iters):
        out = decode_full()
    wall = (time.perf_counter() - start) / iters
    value = b * t * 0.01 / wall
    print(json.dumps({
        "metric": "decode_audio_seconds_per_sec",
        "value": value, "unit": "audio-s/s", "device": _device(),
        "config": {"num_states": num_states, "batch": b, "frames": t},
    }), flush=True)


def run_train_config(b: int, t: int, s: int):
    """One EM training iteration at DELTA+SAT scale: GMM loglikes +
    batched per-utterance banded Viterbi alignment (device backtrace) +
    E-step sufficient statistics (gmm-align-compiled + gmm-acc-stats-ali
    roles).  Prints one JSON line."""
    import jax.numpy as jnp

    from voicebridge_tpu.models.gmm import AmDiagGmm
    from voicebridge_tpu.ops import gmm_kernels as K
    from voicebridge_tpu.steps.align import AlignmentSet

    rng = np.random.default_rng(3)
    num_pdfs, max_mix, dim = 2000, 5, 39
    am = AmDiagGmm(
        rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32),
        np.abs(rng.standard_normal((num_pdfs, max_mix, dim))).astype(
            np.float32) + 0.5,
        np.full((num_pdfs, max_mix), 1.0 / max_mix, np.float32))
    params = K.pack_gmm(am)
    graphs = [synth_train_graph(s, num_pdfs, rng) for _ in range(b)]
    aset = AlignmentSet(graphs)
    feats = jnp.asarray(rng.standard_normal((b, t, dim)), jnp.float32)
    nf = np.full((b,), t, np.int32)

    ones_w = jnp.ones((b * t,), jnp.float32)

    def em_iter():
        ll = K.loglikes_batch(params, feats)
        alis = aset.align(ll, nf, acoustic_scale=0.1)
        pdf_ids = np.zeros((b, t), np.int32)
        for i, r in enumerate(alis):
            assert len(r["arcs"]) == t, "alignment failed"
            pdf_ids[i] = graphs[i].arc_pdf[r["arcs"]]
        # the production E-step path (steps/train_mono.py ->
        # acc_gmm_stats_aligned): gathers only each frame's aligned pdf's
        # components
        stats = K.acc_gmm_stats_aligned(params, feats.reshape(-1, dim),
                                        jnp.asarray(pdf_ids).reshape(-1),
                                        num_pdfs, ones_w)
        jax.block_until_ready(stats)

    import jax

    em_iter()  # compile
    iters = 3
    start = time.perf_counter()
    for _ in range(iters):
        em_iter()
    wall = (time.perf_counter() - start) / iters
    value = b * t * 0.01 / wall
    print(json.dumps({
        "metric": "train_em_audio_seconds_per_sec",
        "value": value, "unit": "audio-s/s", "device": _device(),
        "config": {"batch": b, "frames": t, "graph_states": s},
    }), flush=True)


def run_real_graph_config(mode: str, b: int, t: int, iters: int = 3):
    """Real compiled-HCLG decode bench: the graph the
    flagship example's mono stage decodes with (fst/hclg.py mkgraph over the
    testing lexicon + mod-KN trigram, ~90k states with real epsilon
    structure and non-dst-pure states), through the PRODUCTION
    steps/decode.Decoder — best_path or the lattice-generating path every
    committed WER flows through.  Prints one JSON line."""
    from tools.bench_real_graph import bench, load_or_build, make_decoder

    hclg, tm, tree, _lang = load_or_build()
    decoder, am, dim = make_decoder(hclg, tm, tree)
    v = bench(decoder, dim, b, t, mode, iters=iters, am=am)
    print(json.dumps({
        "metric": f"real_hclg_{mode}_audio_seconds_per_sec",
        "value": v, "unit": "audio-s/s", "device": _device(),
        "config": {"mode": mode, "num_states": hclg.num_states,
                   "rows": decoder.plan.num_rows, "batch": b, "frames": t},
    }), flush=True)


def _device() -> dict:
    import jax

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


# name -> (runner, args, timeout_s).  The real-HCLG graph is built and
# disk-cached once by the "prebuild" child, so later children only load it.
WORKLOADS = {
    "decode": (run_config, (60_000, 128, 1000), 900),
    "prebuild": (None, (), 600),
    "real_hclg_best_path": (run_real_graph_config,
                            ("best_path", 128, 1000, 3), 900),
    # worst-case lattice density: emission-sampled features
    "real_hclg_lattice": (run_real_graph_config,
                          ("lattice", 128, 1000, 2), 900),
    # corpus-realistic density: features emitted along HCLG paths
    "real_hclg_lattice_realistic": (run_real_graph_config,
                                    ("lattice_real", 128, 1000, 2), 900),
    # banded alignment stores one uint8 band slot per state per frame
    "train": (run_train_config, (192, 400, 384), 900),
}


def _run_child(name: str, timeout: float) -> dict:
    """Run one workload in a child process; return its JSON record, or a
    record with an ``error`` field when it failed or timed out."""
    env = dict(os.environ, VB_BENCH_CHILD=name)
    try:
        proc = subprocess.run(
            [sys.executable, "-u", os.path.abspath(__file__)],
            env=env, timeout=timeout, capture_output=True, text=True)
    except subprocess.TimeoutExpired:
        return {"metric": name, "error": f"timed out after {timeout:.0f} s"}
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            return json.loads(line)
    if proc.returncode == 0 and name == "prebuild":
        return {"metric": name}
    tail = proc.stderr.strip().splitlines()[-1:] or [""]
    return {"metric": name,
            "error": f"rc={proc.returncode}: {tail[0]}"}


def main() -> int:
    setdefault_compilation_cache()
    child = os.environ.get("VB_BENCH_CHILD")
    if child == "prebuild":
        from tools.bench_real_graph import load_or_build
        load_or_build()
        return 0
    if child:
        runner, args, _to = WORKLOADS[child]
        runner(*args)
        return 0

    merged = {"utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    failed = []
    for name, (_runner, _args, timeout) in WORKLOADS.items():
        rec = _run_child(name, timeout)
        if "error" in rec:
            failed.append(name)
            print(f"# {name} failed: {rec['error']}", file=sys.stderr)
        if name != "prebuild":
            print(json.dumps(rec), flush=True)
            merged[name] = rec
    merged["failed"] = failed
    print(json.dumps(merged), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
