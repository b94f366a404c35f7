"""Merge a cold-cache and a warm-cache librispeech_shaped report.

The example's decode stages include jit compilation of the per-graph window
programs on their first run (the persistent compile cache keys on the exact
program, which embeds the graph's reduction spec, so a NEW graph always
compiles once).  A second run over the same workdir skips training (mtime
stage-skip) and decodes with every program cached — the production
steady-state.  This tool takes both report.json files and emits one report
whose decode_*/align_* rows come from the WARM run, with the cold run's
walls preserved as ``<stage>_cold`` rows, so a report can show both.

Usage: python tools/merge_reports.py cold.json warm.json out.json
"""

import json
import sys
from pathlib import Path


def main():
    cold = json.loads(Path(sys.argv[1]).read_text())
    warm = json.loads(Path(sys.argv[2]).read_text())
    out = dict(cold)
    stages = dict(cold["stages"])
    for name, row in warm["stages"].items():
        if not (name.startswith("decode") or name.startswith("align")):
            continue
        if name in stages:
            stages[name + "_cold"] = stages[name]
        stages[name] = row
    out["stages"] = stages
    out["wer"] = warm["wer"]  # identical models; warm decode re-scored them
    out["wall_s_cold_run"] = cold.get("wall_s")
    out["wall_s_warm_run"] = warm.get("wall_s")
    Path(sys.argv[3]).write_text(json.dumps(out, indent=1))
    print(f"wrote {sys.argv[3]}")


if __name__ == "__main__":
    main()
