"""Federated data pipeline (PyTorch port)."""
from repro_torch.data.batching import FederatedData, pad_to_batches
from repro_torch.data.leaf_like import make_femnist_like
from repro_torch.data.synthetic import generate_synthetic, make_synthetic

__all__ = ["FederatedData", "pad_to_batches", "make_synthetic",
           "generate_synthetic", "make_femnist_like"]
