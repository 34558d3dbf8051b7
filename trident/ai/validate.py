"""Checkpoint/asset compatibility validation.

Reference: the one registered CTest — trident_onnx_validator
(Trident/tools/ValidateOnnxAsset.cpp): asset exists → IR version supported
→ runtime can load the graph. The analogue here validates a
checkpoint directory: exists → restores against the current model
definition → produces the contracted output shape/range at the configured
resolution.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ValidationResult:
    ok: bool
    message: str


def validate_checkpoint(directory: str,
                        resolution: Tuple[int, int] = (256, 256),
                        base_channels: int = 32) -> ValidationResult:
    if not os.path.isdir(directory):
        return ValidationResult(False, f"checkpoint dir not found: {directory}")
    if not os.path.exists(os.path.join(directory, "latest.json")):
        return ValidationResult(False, f"no latest.json in {directory} "
                                       "(not a trident checkpoint)")
    try:
        import jax.numpy as jnp

        from trident.ai.train import TrainConfig, load_checkpoint

        model, variables = load_checkpoint(
            directory, TrainConfig(resolution=resolution,
                                   base_channels=base_channels))
    except Exception as exc:
        return ValidationResult(False, f"restore failed: {exc}")
    # the record carries the net width since round 3, so a mismatched
    # expectation restores FINE against the recorded template — compare
    # the actual restored width to the caller's contract explicitly
    got_bc = int(variables["params"]["Conv_0"]["kernel"].shape[-1])
    if got_bc != base_channels:
        return ValidationResult(
            False, f"architecture mismatch: checkpoint is {got_bc}-wide, "
                   f"expected base_channels={base_channels}")
    try:
        import jax

        out = jax.jit(lambda v, x: model.apply(v, x, train=False))(
            variables, jnp.zeros((1, resolution[0], resolution[1], 6)))
    except Exception as exc:
        return ValidationResult(False, f"forward failed: {exc}")
    if out.shape != (1, resolution[0], resolution[1], 3):
        return ValidationResult(False, f"bad output shape {out.shape}")
    lo, hi = float(out.min()), float(out.max())
    if not (0.0 <= lo and hi <= 1.0):
        return ValidationResult(False, f"output outside [0,1]: [{lo},{hi}]")
    return ValidationResult(True, "checkpoint loads and satisfies the "
                                  f"{resolution} NHWC contract")


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint_dir")
    parser.add_argument("--resolution", type=int, default=256)
    parser.add_argument("--base-channels", type=int, default=32)
    args = parser.parse_args(argv)
    result = validate_checkpoint(args.checkpoint_dir,
                                 (args.resolution, args.resolution),
                                 args.base_channels)
    print(("OK: " if result.ok else "FAIL: ") + result.message)
    return 0 if result.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
