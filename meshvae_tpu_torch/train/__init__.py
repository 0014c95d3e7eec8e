from .joint import JointTrainer
from .loop import (METRIC_NAMES, Trainer, lr_for_epoch, make_optimizer,
                   set_learning_rate, unpack_metrics)

__all__ = ["METRIC_NAMES", "JointTrainer", "Trainer", "lr_for_epoch",
           "make_optimizer", "set_learning_rate", "unpack_metrics"]
