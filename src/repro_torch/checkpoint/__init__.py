"""Checkpointing (msgpack tensor store, the reference's file format)."""
from repro_torch.checkpoint.store import (latest_checkpoint, load_checkpoint,
                                          save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]
