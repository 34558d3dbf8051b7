#!/usr/bin/env python
"""Run bench.py's measurement for several configs in ONE process, so the
configs share the process start-up and the compilation cache. Prints one
JSON line per config.

Config syntax: NAME[:ai] — the ":ai" suffix measures the neural-2x
reconstruction mode for that entry, e.g.

    python scripts/bench_sweep.py spheres1080_1m spheres1080_1m:ai
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402
from trident.core.platform import compile_cache_dir  # noqa: E402


def main(configs) -> int:
    compile_cache_dir()
    info = bench.require_gpu()
    iters = int(os.environ.get("BENCH_ITERS", "30"))
    failed = 0
    for cfg in configs:
        name, _, mode = cfg.partition(":")
        try:
            if name == "interp":
                result = bench.bench_interp(iters)
            else:
                result = bench.run_config(name, iters, use_ai=mode == "ai")
        except SystemExit as exc:          # overflow / bad config
            failed += 1
            result = {"metric": f"bench_error_{cfg}", "value": 0,
                      "unit": "none", "vs_baseline": 0,
                      "extra": {"error": str(exc)}}
        result["extra"]["device"] = info
        print(json.dumps(result), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:] or [
        "cube512", "spheres1080", "spheres1080_1m", "ultra4k",
        "shadows1080"]))
