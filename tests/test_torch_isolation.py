"""The port stands alone: no JAX, nothing of ``repro``, no silent CPU.

``repro_torch`` must import neither ``jax`` nor any module of the JAX
package (only the parity tests import both), and its entry points run on
the card unless the caller passes ``device="cpu"``: without a card they
raise instead of carrying on on the CPU.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "src" / "repro_torch"


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_pulls_in_no_jax_and_no_reference():
    """Import every module of the port in a fresh interpreter."""
    code = (
        "import importlib, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr


def test_sources_import_no_jax_and_no_reference():
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), \
                    f"{path}: imports {name}"


def _entry_points(tmp):
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.data import (make_femnist_stream, make_sent140_like,
                                  make_shakespeare_like, make_synthetic,
                                  make_synthetic_stream)
    from repro_torch.data.batching import FederatedData, pad_to_batches
    from repro_torch.launch import serve
    from repro_torch.models import model_specs
    from repro_torch.models.param import init_params, params_from_numpy
    from repro_torch.models.small import logreg_loss, logreg_specs

    arrays = {"x": np.zeros((4, 3), np.float32),
              "y": np.zeros(4, np.int32)}
    ckpt = save_checkpoint(str(tmp / "c.msgpack"), arrays)
    cpu_data = FederatedData([arrays] * 2, batch_size=2, device="cpu")
    return {
        "FederatedData": lambda: FederatedData([arrays], batch_size=2),
        "pad_to_batches": lambda: pad_to_batches(arrays, 2),
        "make_synthetic": lambda: make_synthetic(1, 1, num_devices=2),
        "init_params": lambda: init_params(logreg_specs(3, 2),
                                           torch.Generator()),
        "params_from_numpy": lambda: params_from_numpy(arrays),
        "FederatedTrainer": lambda: FederatedTrainer(
            logreg_loss, cpu_data, FederatedConfig(num_devices=2,
                                                   devices_per_round=1)),
        "init_params(LM)": lambda: init_params(
            model_specs(get_arch("qwen1.5-0.5b").reduced()),
            torch.Generator()),
        "serve.main": lambda: serve.main(["--tokens", "1"]),
        "make_sent140_like": lambda: make_sent140_like(2),
        "make_shakespeare_like": lambda: make_shakespeare_like(
            2, sample_cap=32),
        "load_checkpoint": lambda: load_checkpoint(ckpt),
        "make_synthetic_stream": lambda: make_synthetic_stream(
            num_devices=10**6),
        "make_femnist_stream": lambda: make_femnist_stream(10**6),
    }


@pytest.mark.parametrize("name", ["FederatedData", "pad_to_batches",
                                  "make_synthetic", "init_params",
                                  "params_from_numpy", "FederatedTrainer",
                                  "init_params(LM)", "serve.main",
                                  "make_sent140_like",
                                  "make_shakespeare_like",
                                  "load_checkpoint", "make_synthetic_stream",
                                  "make_femnist_stream"])
def test_entry_points_need_the_card_unless_told(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card path is moot")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points(tmp_path)[name]()


def test_trainer_rejects_data_on_another_device():
    from repro_torch.configs.base import FederatedConfig
    from repro_torch.core import FederatedTrainer
    from repro_torch.models.small import logreg_loss

    class Data:
        device = torch.device("meta")
        num_devices = 2

    with pytest.raises(ValueError, match="dataset lives on"):
        FederatedTrainer(logreg_loss, Data(),
                         FederatedConfig(num_devices=2,
                                         devices_per_round=1),
                         device="cpu")
