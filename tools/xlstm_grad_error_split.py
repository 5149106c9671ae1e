"""Which scan kernel moves xlstm-350m's 24-layer gradient off the plain
scans', on the card.

``chip_smoke.py`` phase 11d (b) holds ``loss_fn``'s gradient (B=1, S=256,
remat full, weights drawn on the card from seed 0) through K9/K9-bwd and
K10/K10-bwd to within GRAD_REL of each leaf's max |g| of the plain scans'
route (remat none).  This script computes the plain route once and prints
the worst leaves of each other route against it: both kernels, K10's
alone (the mLSTM plain), K9's alone, and both kernels with the sLSTM
sources built with FMA contraction (``build.EXTRA_FLAGS`` emptied for
them), the build they had before they were built without it.
``--seed N ...`` draws the weights from seed N and the tokens from phase
11d (b)'s seed plus N (0, the default: phase 11d (b)'s own), each seed
in turn.  Needs the card and nvcc::

    PYTHONPATH=src python tools/xlstm_grad_error_split.py [--seed N ...]
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from repro_torch.configs import get_arch
from repro_torch.kernels import build, ref
from repro_torch.launch import steps
from repro_torch.models import model_specs, transformer, xlstm

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402


def main(seed: int = 0) -> None:
    cfg = get_arch("xlstm-350m")
    params = cs.init_on_card(torch, model_specs(cfg), seed)
    B, S = cs.XLSTM_GRAD_CMP
    batch = cs.card_batch(torch, S + 7 + seed, cfg.vocab_size, B, S)
    names = cs.leaf_names(params)

    def grad(remat, mlstm_plain=False, slstm_plain=False):
        with cs.swapped(xlstm, "mlstm_scan", ref.mlstm_scan_ref
                        if mlstm_plain else xlstm.mlstm_scan), \
                cs.swapped(xlstm, "slstm_scan", ref.slstm_scan_ref
                           if slstm_plain else xlstm.slstm_scan):
            return steps.value_and_grad(
                lambda p: transformer.loss_fn(p, batch, cfg, remat=remat),
                params)[1]

    plain = grad("none", True, True)

    def report(what, g):
        rels = cs.leaf_rels(g, plain)
        worst = sorted(range(len(rels)), key=lambda i: -rels[i])[:3]
        print(f"  {what:44s} worst leaf {rels[worst[0]]:.3e} (bar "
              f"{cs.GRAD_REL:g}): "
              + "; ".join(f"{names[i]} {rels[i]:.2e}" for i in worst),
              flush=True)

    print(f"{torch.cuda.get_device_name(0)}; xlstm-350m loss_fn gradient "
          f"B={B} S={S}, seed {seed}, remat full, against the plain scans "
          f"(remat none)")
    report("K9 + K10 and their backward", grad("full"))
    report("K10 + K10-bwd, the mLSTM plain", grad("full", mlstm_plain=True))
    report("K9 + K9-bwd, the sLSTM plain", grad("full", slstm_plain=True))
    sources = ("slstm_scan", "slstm_scan_bwd")
    kept = {name: build.EXTRA_FLAGS[name] for name in sources}
    for name in sources:
        build.EXTRA_FLAGS[name] = ()
        build._LIBS.pop(name, None)
    report("K9 + K10, the sLSTM sources contracted", grad("full"))
    report("K10 + K10-bwd contracted, the mLSTM plain",
           grad("full", mlstm_plain=True))
    for name in sources:  # the next seed's first routes as built
        build.EXTRA_FLAGS[name] = kept[name]
        build._LIBS.pop(name, None)


if __name__ == "__main__":
    for seed in ([int(a) for a in sys.argv[2:]]
                 if sys.argv[1:2] == ["--seed"] else [0]):
        main(seed)
