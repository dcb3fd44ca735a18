"""Optimizers and learning-rate schedules of the supervised recipe."""
from bcosification_tpu_torch.optim.lr_scheduler_factory import LRSchedulerFactory
from bcosification_tpu_torch.optim.optimizer_factory import OptimizerFactory

__all__ = ["LRSchedulerFactory", "OptimizerFactory"]
