"""Federated data pipeline (PyTorch port)."""
from repro_torch.data.batching import FederatedData, pad_to_batches
from repro_torch.data.leaf_like import (make_femnist_like, make_sent140_like,
                                        make_shakespeare_like)
from repro_torch.data.shard_source import (ClientShardSource,
                                           FemnistShardSource,
                                           SyntheticShardSource,
                                           make_femnist_stream,
                                           make_synthetic_stream,
                                           resolve_streaming)
from repro_torch.data.synthetic import (generate_synthetic, make_synthetic,
                                        paper_synthetic_suite)

__all__ = ["FederatedData", "pad_to_batches", "make_synthetic",
           "generate_synthetic", "paper_synthetic_suite",
           "make_femnist_like", "make_sent140_like",
           "make_shakespeare_like", "ClientShardSource",
           "SyntheticShardSource", "FemnistShardSource",
           "make_synthetic_stream", "make_femnist_stream",
           "resolve_streaming"]
