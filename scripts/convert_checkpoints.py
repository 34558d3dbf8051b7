#!/usr/bin/env python
"""Convert the orbax checkpoints the nets were first saved in to `.npz`.

One-time tool: it needs `orbax-checkpoint`, which the renderer itself no
longer imports. It reads the old layout (`<dir>/params/` for the
upscaler, `<dir>/step_NNNNNN/` + latest.json for the interpolation net),
writes the `.npz` files that ai/upscaler.py and ai/train.py load, points
latest.json at the new file and, with --remove, deletes the old
directories.

    python scripts/convert_checkpoints.py assets_out/upscaler_2x \
        assets_out/frame_generator_128 --remove
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import jax


def _restore(path: str):
    import orbax.checkpoint as ocp

    return jax.device_get(ocp.StandardCheckpointer().restore(
        os.path.abspath(path)))


def convert(directory: str, remove: bool) -> str:
    from trident.ai.nn import save_npz

    latest_path = os.path.join(directory, "latest.json")
    if os.path.exists(latest_path):                 # interpolation net
        with open(latest_path) as f:
            latest = json.load(f)
        old = os.path.join(directory, latest["path"])
        tree = _restore(old)
        name = os.path.basename(old) + ".npz"
        out = save_npz(os.path.join(directory, name),
                       {"params": tree["params"],
                        "batch_stats": tree["batch_stats"]})
        latest["path"] = name
        with open(latest_path, "w") as f:
            json.dump(latest, f)
    else:                                           # upscaler
        old = os.path.join(directory, "params")
        out = save_npz(os.path.join(directory, "params.npz"),
                       {"params": _restore(old)["params"]})
    if remove:
        shutil.rmtree(old)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--remove", action="store_true",
                    help="delete the orbax directories after conversion")
    args = ap.parse_args(argv)
    for d in args.dirs:
        print(convert(d, args.remove))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
