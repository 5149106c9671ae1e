"""Fresh-interpreter body of the port's population memory gate.

Run by tests/test_torch_population.py in a new interpreter, so that the
high-water RSS measures this workload alone.  The workload is the
reference's acceptance run (tests/_population_child.py): 3 feddane
rounds at N=1,000,000, K=10 on a streaming source, on the python driver
(batched engine) and on the scanned driver's streaming plan, plus 2
SCAFFOLD rounds whose controls live in the sparse store.  Prints one
JSON line of telemetry: ``peak_rss_mb`` (VmHWM) and each run's source
counters and losses.  A dense path would need every client's batch
stack, ~10^2 GB.

Imports torch and repro_torch only, on the CPU.
"""
import json
import resource
import sys

import numpy as np
import torch

from repro_torch.configs.base import FederatedConfig
from repro_torch.core import FederatedTrainer
from repro_torch.data import make_synthetic_stream
from repro_torch.models.param import init_params
from repro_torch.models.small import logreg_loss, logreg_specs

N, K, R = 1_000_000, 10, 3
BASE = dict(num_devices=N, devices_per_round=K, local_epochs=1,
            local_batch_size=10, learning_rate=0.05, mu=0.01, seed=5)


def _source(seed):
    return make_synthetic_stream(1.0, 1.0, num_devices=N, seed=seed,
                                 eval_clients=32, device="cpu")


def _peak_rss_mb():
    """This interpreter's high-water RSS since exec, in MB (``VmHWM``:
    ``ru_maxrss`` would inherit a forking parent's peak)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def main():
    torch.set_num_threads(1)
    params = init_params(logreg_specs(60, 10),
                         torch.Generator().manual_seed(0), device="cpu")
    out = {}
    src = _source(7)
    tr = FederatedTrainer(logreg_loss, src, FederatedConfig(
        algorithm="feddane", engine="batched", round_driver="python",
        **BASE), device="cpu")
    hist, _ = tr.run(params, R, eval_every=R)
    out["feddane_python"] = {"loss": hist["loss"], **src.stats()}

    src2 = _source(7)
    tr2 = FederatedTrainer(logreg_loss, src2, FederatedConfig(
        algorithm="feddane", engine="batched", round_driver="scan",
        client_source="streaming", chunk_rounds=R, **BASE), device="cpu")
    hist2, _ = tr2.run(params, R, eval_every=R)
    out["feddane_scan"] = {"loss": hist2["loss"], **src2.stats()}

    src3 = _source(11)
    tr3 = FederatedTrainer(logreg_loss, src3, FederatedConfig(
        algorithm="scaffold", engine="batched", round_driver="python",
        **BASE), device="cpu")
    st = tr3.init(params)
    for _ in range(2):
        st = tr3.round(st)
    out["scaffold"] = {"stored_controls": len(st.controls),
                       "peak_clients": st.controls.peak_clients,
                       **src3.stats()}
    out["peak_rss_mb"] = _peak_rss_mb()
    json.dump(out, sys.stdout)
    print()


if __name__ == "__main__":
    np.seterr(all="ignore")
    main()
