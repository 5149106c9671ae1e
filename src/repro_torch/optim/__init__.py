"""Optimizers as (init, update) pairs over parameter trees."""
from repro_torch.optim.optimizers import Optimizer, adam, momentum, sgd

__all__ = ["Optimizer", "sgd", "momentum", "adam"]
