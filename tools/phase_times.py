"""How long ``chip_smoke.py``'s phases 3 (every kernel against its plain
version), 10d (xlstm-350m served) and 11d (xlstm-350m trained) take, on
the card, for one or more checkouts of this repository.

Each checkout (``ROOT``, e.g. an older commit unpacked with ``git
archive`` into a directory that ``.gitignore`` lists) runs in a process
of its own, in the order given, with its own ``chip_smoke.py`` and its
own sources: the kernels built and its CPU pool started first, and phase
11d's CPU path submitted after phase 3, as ``chip_smoke.py`` does.  Every
check of those phases holds as in the whole run.  One JSON line a
checkout: each phase's seconds on the script's clock.  Needs the card and
nvcc::

    PYTHONPATH=src python tools/phase_times.py [--phases 3,10d,11d] [ROOT ...]
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_phases(root: Path, phases) -> dict:
    import torch
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs     # the pool's workers import it by name
    from repro_torch.kernels import build

    out = {"root": str(root), "card": cs.smi(), "s": {}}
    pool, _ = cs.cpu_pool()
    try:
        jobs = None
        t0 = time.perf_counter()
        build.build_all()
        out["s"]["build"] = time.perf_counter() - t0
        counts = build.launch_counts
        if "3" in phases:
            from repro_torch.data import make_femnist_like, make_synthetic
            syn = make_synthetic(1, 1, num_devices=30, seed=0,
                                 batch_size=10)
            fem = make_femnist_like(200, seed=0, batch_size=10)
            t0 = time.perf_counter()
            cs.kernel_checks(torch, syn, fem)
            out["s"]["3"] = time.perf_counter() - t0
        if "11d" in phases:  # its CPU path, as chip_smoke.py submits it
            jobs = cs.xlstm_cpu_jobs(pool)
        if "10d" in phases:
            build.reset_launch_counts()
            t0 = time.perf_counter()
            cs.xlstm_phase(torch, counts)
            out["s"]["10d"] = time.perf_counter() - t0
        if "11d" in phases:
            build.reset_launch_counts()
            t0 = time.perf_counter()
            cs.xlstm_train_phase(torch, counts, jobs)
            out["s"]["11d"] = time.perf_counter() - t0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return out


def main(argv) -> int:
    phases = ["3", "10d", "11d"]
    if argv[:1] == ["--phases"]:
        phases, argv = argv[1].split(","), argv[2:]
    if argv[:1] == ["--of"]:
        out = run_phases(Path(argv[1]).resolve(), phases)
        print(json.dumps(out), flush=True)
        return 0
    for root in argv or [str(REPO)]:
        print(f"{root}: phases {phases}", flush=True)
        p = subprocess.run([sys.executable, __file__, "--phases",
                            ",".join(phases), "--of", root], timeout=1800)
        if p.returncode:
            return p.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
