"""Federated optimization core: FedDANE and its baselines (PyTorch port).

The public names below resolve on first access, so that the data layer
can import ``repro_torch.core.pytree`` without pulling in the trainer
(which imports the data layer).
"""
import importlib

_EXPORTS = {
    "FederatedTrainer": "algorithms", "FederatedState": "algorithms",
    "RoundEngine": "engine", "ScannedDriver": "engine",
    "make_scanned_run": "engine", "BufferedDriver": "async_engine",
    "LocalResult": "client", "make_local_solver": "client",
    "make_grad_fn": "client", "make_batched_solver": "client",
    "make_batched_grad_fn": "client",
    "AlgorithmSpec": "strategies", "register_algorithm": "strategies",
    "algorithm_spec": "strategies", "available_algorithms": "strategies",
    "ClientMesh": "sharding", "run_on_mesh": "sharding",
    "make_exact_solver": "client", "gamma_inexactness": "client",
    "b_dissimilarity": "theory", "rho_convex": "theory",
    "rho_nonconvex": "theory", "rho_device_specific": "theory",
    "corollary4_mu": "theory",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}")
    module = importlib.import_module(f"repro_torch.core.{_EXPORTS[name]}")
    return getattr(module, name)
