"""Share of decode device time spent in the acoustic log-likelihoods.

Traces one warm ``decode`` call of each chip_smoke decode shape with
``jax.profiler`` and reduces the trace: device time per XLA module (the
``hlo_module`` of each kernel on the GPU's compute stream), and the share of
the module that computes ``loglikes_batch``.

* ``synthetic``: chip_smoke phase 2 (60k-state graph, 10k Gaussians,
  B=128, T=1000) through ``decode_core.decode_best_path``.
* ``real_hclg``: chip_smoke phase 3 (~90k-state HCLG) through
  ``Decoder.decode_batch``.

Usage: python tools/loglik_share.py [--out DIR]   (on a GPU machine)
Prints one JSON line per shape; the traces go to DIR (default: a temporary
directory removed at exit).
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import tempfile
from collections import defaultdict
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def _device_events(xplane_path: str):
    """(line name, event name, seconds, stats dict) of every event on the
    device planes' stream lines."""
    from jax.profiler import ProfileData

    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                yield (line.name, ev.name, ev.duration_ns * 1e-9,
                       {k: v for k, v in ev.stats})


def module_times(xplane_path: str) -> dict:
    """{XLA module name: device seconds} over the compute streams, from
    each kernel event's ``hlo_module`` stat (the trailing ``(id)`` of a
    module name is dropped)."""
    out: dict = defaultdict(float)
    for line, _name, secs, stats in _device_events(xplane_path):
        if "Compute" in line:
            mod = str(stats.get("hlo_module", "?"))
            out[mod.split("(")[0]] += secs
    return dict(out)


def trace_sample(xplane_path: str, n: int = 3) -> list:
    """A few compute-stream events with their stats, for reading a trace
    by hand."""
    out = []
    for line, name, secs, stats in _device_events(xplane_path):
        if "Compute" in line and len(out) < n:
            out.append({"name": name[:120], "s": secs,
                        "stats": {k: str(v)[:80] for k, v in stats.items()}})
    return out


def loglik_share(times: dict) -> float:
    total = sum(times.values())
    ll = sum(v for k, v in times.items() if "loglikes_batch" in k)
    return ll / total if total else float("nan")


def _trace(fn, logdir: Path) -> dict:
    import jax

    fn()  # warm: compile outside the trace
    with jax.profiler.trace(str(logdir)):
        fn()
    files = sorted(glob.glob(str(logdir / "**" / "*.xplane.pb"),
                             recursive=True))
    return module_times(files[-1]), trace_sample(files[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="vb_trace_") as tmp:
        return _run(Path(args.out or tmp))


def _run(out: Path) -> int:
    from voicebridge_tpu.utils.jax_cache import setdefault_compilation_cache
    setdefault_compilation_cache()
    import jax
    import jax.numpy as jnp

    from chip_smoke import _random_am
    from tools.bench_real_graph import (graph_walk_feats, load_or_build,
                                        make_decoder)
    from voicebridge_tpu.ops import decode_core as DC
    from voicebridge_tpu.ops import gmm_kernels as K
    from voicebridge_tpu.testing.graphs import synth_decode_graph

    kind = jax.devices()[0].device_kind

    am = _random_am(2000, 5, 39, seed=1)
    params = K.pack_gmm(am)
    graph = synth_decode_graph(num_states=60_000, num_pdfs=2000)
    plan = DC.build_emit_plan(graph, d=8)
    dev = DC.plan_to_device(plan)
    feats = jnp.asarray(np.random.default_rng(2).standard_normal(
        (128, 1000, 39)), jnp.float32)
    nf = np.full(128, 1000, np.int32)

    def synthetic():
        return DC.decode_best_path(graph, plan, dev,
                                   K.loglikes_batch(params, feats), nf,
                                   acoustic_scale=1.0 / 13.0, chunk=500)

    hclg, tm, tree, _lang = load_or_build()
    decoder, dam, _d = make_decoder(hclg, tm, tree)
    rfeats = graph_walk_feats(decoder.graph, dam, 128, 1000,
                              np.random.default_rng(2))
    utts = [f"u{i}" for i in range(128)]

    def real():
        return decoder.decode_batch(utts, rfeats, nf)

    for name, fn in (("synthetic", synthetic), ("real_hclg", real)):
        times, sample = _trace(fn, out / name)
        top = sorted(times.items(), key=lambda kv: -kv[1])[:8]
        print(json.dumps({"shape": name, "device": kind,
                          "device_module_s": sum(times.values()),
                          "loglik_share": loglik_share(times),
                          "top_modules_s": dict(top),
                          "sample_events": sample}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
