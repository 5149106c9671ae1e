"""PyTorch/CUDA port of the FedDANE reproduction in ``src/repro``.

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``data/``, ``models/``, ``configs/``, ``optim/``) so each counterpart is
easy to find, and it imports neither ``jax`` nor anything of ``repro``.
Parameter trees keep the JAX package's layout: dicts of tensors such as
logistic regression's ``{"w": (d, C), "b": (C,)}``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (``repro_torch.device.resolve_device``); without a card
they raise instead of carrying on on the CPU.  On the card the local
solve runs through the hand-written kernels under ``kernels/csrc``; on
the CPU every kernel wrapper takes its plain PyTorch version
(``kernels/ref.py``).

Float32 matrix products run in full float32: TF32 keeps about three
decimal digits and would break the 1e-5 parity bar against the
reference, so both switches are set off here, once, for the process.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
