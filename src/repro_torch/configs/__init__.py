"""Federated round configuration (PyTorch port)."""
from repro_torch.configs.base import FederatedConfig

__all__ = ["FederatedConfig"]
