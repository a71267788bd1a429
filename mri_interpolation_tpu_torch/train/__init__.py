"""Training runtime."""

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .losses import get_loss, mse_loss, relative_l2_loss
from .scalars import ScalarLogger, read_scalars
from .trainer import EpochHooks, TrainConfig, Trainer, TrainResult, make_optimizer, make_schedule

__all__ = ["TrainConfig", "TrainResult", "Trainer", "EpochHooks", "make_optimizer", "make_schedule", "get_loss",
           "mse_loss", "relative_l2_loss", "ScalarLogger", "read_scalars", "save_checkpoint", "restore_checkpoint",
           "latest_step"]
