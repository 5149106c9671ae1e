"""Msgpack-based tree checkpointing, in the reference's file format.

Counterpart of ``repro/checkpoint/store.py``: the same encoding, so
either package reads the other's files.  An array (a tensor, read back
to the host, or a numpy array) is a map ``{"__nd__": True, "dtype":
<numpy dtype str>, "shape": [...], "data": <raw bytes>}``; a tuple is
``{"__tuple__": [...]}``; dicts and lists are msgpack maps and lists;
ints, floats, strings, bools and None stay as they are.  A save writes a
temporary file and renames it over the target (atomic).
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.device import resolve_device

_ARRAY_KEY = "__nd__"
_TUPLE_KEY = "__tuple__"


def _pack(obj):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        a = (obj.detach().cpu().numpy() if isinstance(obj, torch.Tensor)
             else obj)
        return {_ARRAY_KEY: True, "dtype": a.dtype.str,
                "shape": list(a.shape), "data": a.tobytes()}
    if isinstance(obj, dict):
        # sorted, as the reference's trees come out of jax.device_get, so
        # the two packages write the same bytes
        return {str(k): _pack(obj[k]) for k in sorted(obj)}
    if isinstance(obj, tuple):
        return {_TUPLE_KEY: [_pack(v) for v in obj]}
    if isinstance(obj, list):
        return [_pack(v) for v in obj]
    if isinstance(obj, (int, float, str, bool)) or obj is None:
        return obj
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _unpack(obj, device):
    if isinstance(obj, dict):
        if obj.get(_ARRAY_KEY):
            a = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
            return torch.from_numpy(a.reshape(obj["shape"]).copy()).to(
                device)
        if _TUPLE_KEY in obj:
            return tuple(_unpack(v, device) for v in obj[_TUPLE_KEY])
        return {k: _unpack(v, device) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack(v, device) for v in obj]
    return obj


def save_checkpoint(path: str, tree: Any, step: Optional[int] = None) -> str:
    """Write ``tree`` to ``path`` (or ``path/ckpt_<step>.msgpack``)."""
    if step is not None:
        os.makedirs(path, exist_ok=True)
        path = os.path.join(path, f"ckpt_{step:08d}.msgpack")
    else:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = msgpack.packb(_pack(tree), use_bin_type=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, device=None) -> Any:
    """The tree saved at ``path``, its arrays as tensors on ``device``
    (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        return _unpack(msgpack.unpackb(f.read(), raw=False,
                                       strict_map_key=False), dev)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The ``ckpt_<step>.msgpack`` of the highest step in ``directory``,
    or None."""
    if not os.path.isdir(directory):
        return None
    pat = re.compile(r"ckpt_(\d+)\.msgpack$")
    best, best_step = None, -1
    for name in os.listdir(directory):
        m = pat.match(name)
        if m and int(m.group(1)) > best_step:
            best, best_step = name, int(m.group(1))
    return os.path.join(directory, best) if best else None
