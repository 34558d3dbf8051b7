"""Model zoo: the neural networks the framework trains/serves on-chip.

Currently the frame-interpolation family (the reference's only network,
Scripts/train_frame_generator.py). New model families plug in here.
"""

from trident.ai.model import InterpolationUNet, init_model, residual_block
from trident.ai.train import TrainConfig, create_state, train
from trident.ai.validate import validate_checkpoint

__all__ = [
    "InterpolationUNet", "init_model", "residual_block",
    "TrainConfig", "create_state", "train", "validate_checkpoint",
]
