"""Training runtime."""

from .losses import get_loss, mse_loss, relative_l2_loss
from .trainer import TrainConfig, Trainer, TrainResult, make_optimizer

__all__ = ["TrainConfig", "TrainResult", "Trainer", "make_optimizer", "get_loss", "mse_loss",
           "relative_l2_loss"]
