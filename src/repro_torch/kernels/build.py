"""Build the port's CUDA kernels with nvcc and bind them through ctypes.

Each ``csrc/<name>.cu`` compiles, at first use and from the repository's
sources only, into ``build/kernels/lib<name>-<digest>.so`` under the
repository root (a directory ``.gitignore`` lists), for ``sm_90a``.  The
digest covers the source, the headers of ``csrc`` it includes
(``hopper.cuh``, which both K7 sources share) and the flags, so an
edited kernel or header is rebuilt and a built one is reused.  The
libraries export plain C functions that launch on the stream they are
given and return ``cudaGetLastError()``; they include no PyTorch header,
so each builds in seconds.

Every wrapper counts its launches in :data:`launch_counts` (one per
kernel launch, nowhere else), so a run can show that it went through the
kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: Per-source flags.  The update and codec-aggregate kernels are built
#: without FMA contraction so that each multiply and add rounds on its
#: own, exactly as the plain PyTorch version does (bitwise equal on the
#: card); so are the sLSTM scans, whose cells then round each step as
#: the plain version's elementwise ops do (their products' ``fmaf`` stay
#: fused).  Contracted, the sLSTM cells' rounding, compounded over 24
#: layers, moved xlstm-350m's gradient past chip_smoke phase 11d (b)'s
#: bar of 1e-4 of a leaf's max |g| against the plain scans.
EXTRA_FLAGS: Dict[str, Tuple[str, ...]] = {
    "dane_update": ("-fmad=false",),
    "local_solve": (),
    "codec": ("-fmad=false",),
    "flash_attention": (),
    "flash_attention_bwd": (),
    "selective_scan": (),
    "selective_scan_bwd": (),
    "mlstm_scan": (),
    "mlstm_scan_bwd": (),
    "slstm_scan": ("-fmad=false",),
    "slstm_scan_bwd": ("-fmad=false",),
}

#: Launches per kernel since the last :func:`reset_launch_counts`.
launch_counts: Dict[str, int] = dict.fromkeys(
    ("dane_update_flat", "dane_update_2d", "local_epoch",
     "linear_logistic_step", "codec_aggregate", "codec_aggregate_partial",
     "flash_attention", "flash_attention_bwd", "selective_scan",
     "selective_scan_bwd", "mlstm_scan", "mlstm_scan_bwd", "slstm_scan",
     "slstm_scan_bwd"),
    0)

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _flags(name: str) -> Tuple[str, ...]:
    return COMMON_FLAGS + EXTRA_FLAGS[name]


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every header of ``csrc`` it includes with
    quotes, directly or through another, each once, in the order met."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in out:
            continue
        out.append(path)
        todo += [CSRC / m.decode() for m in _INCLUDE.findall(
            path.read_bytes())]
    return out


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "with the CUDA toolkit's nvcc")
    return nvcc


def build_all(names: Iterable[str] = tuple(EXTRA_FLAGS)) -> Dict[str, str]:
    """Compile every named source not built yet, one nvcc per source,
    all started together.  Returns each new build's compiler output
    (register and shared-memory use from ``-Xptxas -v``); raises with
    the output if a compile fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for n, (tmp, t0, p) in procs.items():
        out, _ = p.communicate()
        logs[n] = f"[{time.perf_counter() - t0:.2f} s]\n{out}"
        if p.returncode != 0:
            failed.append(n)
        else:
            os.replace(tmp, library_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def library(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The built library ``name`` (building it first if needed), with
    ``signatures`` (C function -> ctypes argtypes) declared; every
    function returns a C int, the launch's CUDA error code."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = list(argtypes)
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


#: ctypes argument types of the C launchers: pointer, float, int64, int.
P, F, LL, I = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_int


def stream() -> int:
    """The current CUDA stream of the current device, as the raw handle
    the C launchers take (during a CUDA graph's capture, the capturing
    stream).  Read through the private ``torch._C._cuda_getCurrentRawStream``,
    the call PyTorch's own generated kernels launch with
    (``torch._inductor``): the public ``torch.cuda.current_stream()``
    builds a Stream object every call, a few microseconds of a launch path
    that takes tens.  Only the wrappers call it, for tensors already on
    the card (CUDA is initialised)."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


def check_launch(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
