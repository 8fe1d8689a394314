"""Import hygiene of the PyTorch package: it and ``chip_smoke.py`` import
nothing of JAX (jax, flax, optax) and nothing of the JAX package
``pytorch_distributed_train_tpu``, which they may only copy from. Plus the
CPU behaviour of the kernel wrapper and the CLI."""

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

from pytorch_distributed_train_tpu_torch import generate_cli
from pytorch_distributed_train_tpu_torch.ops import flash_attention as tfa

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "pytorch_distributed_train_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pytorch_distributed_train_tpu")
TINY = ["model.num_layers=2", "model.hidden_size=128", "model.num_heads=2",
        "model.num_kv_heads=1", "model.mlp_dim=256", "model.vocab_size=300",
        "model.max_seq_len=64", "precision.compute_dtype=float32"]


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


_PROBE = r"""
import json, sys
from pytorch_distributed_train_tpu_torch import generate_cli, interop, kernels
from pytorch_distributed_train_tpu_torch.config import get_preset
from pytorch_distributed_train_tpu_torch.generate import build_decode_model, generate
from pytorch_distributed_train_tpu_torch.serving import ContinuousBatcher
cfg = get_preset("llama2_7b")
cfg.apply_overrides(json.loads(sys.argv[1]))
m = build_decode_model(cfg.model, cfg.precision, device="cpu", seed=0)
generate(m, [[1, 2, 3]], 3)
b = ContinuousBatcher(cfg.model, cfg.precision, device="cpu", slots=2)
b.submit([4, 5, 6], 2)
b.step()
from pytorch_distributed_train_tpu_torch.trainer import Trainer
cfg.apply_overrides(["data.seq_len=16", "data.batch_size=2",
                     "data.synthetic_size=4", "obs.log_every_steps=1"])
Trainer(cfg, device="cpu").fit(1)
print(json.dumps(sorted(sys.modules)))
"""


def test_port_runs_without_importing_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _PROBE, json.dumps(TINY)],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    mods = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "pytorch_distributed_train_tpu_torch.serving" in mods
    assert "pytorch_distributed_train_tpu_torch.trainer" in mods
    bad = [m for m in mods if _forbidden(m)]
    assert not bad, f"JAX-side modules imported: {bad[:10]}"


def _py_files():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            found.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                _forbidden(str(node.args[0].value)):
            found.append(node.args[0].value)
    assert not found, f"{path} imports {found}"


TRAINING_MODULES = ("trainer.py", "steps.py", "optim.py", "losses.py",
                    "train_state.py", "train_cli.py", "data/datasets.py",
                    "data/sampler.py", "data/pipeline.py", "models/remat.py",
                    "ops/flash_attention.py")


def test_scan_covers_the_training_modules():
    scanned = {os.path.relpath(p, PORT) for p in _py_files()}
    missing = [m for m in TRAINING_MODULES if m not in scanned]
    assert not missing, f"the AST scan misses {missing}"


def test_cpu_tensors_count_no_kernel_launch():
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 48, 2, 64, generator=g) for _ in range(3))
    before = tfa.flash_attention_fwd.launches
    o, lse = tfa.flash_attention_fwd(q, k, v, causal=True)
    assert tfa.flash_attention_fwd.launches == before
    ro, rlse = tfa.flash_attention_reference(q, k, v, causal=True)
    torch.testing.assert_close(o, ro, atol=0, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=0, rtol=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention_fwd(q.to("meta"), k.to("meta"), v.to("meta"),
                                causal=True)


@pytest.mark.parametrize("slots", [0, 2])
def test_generate_cli_runs_on_cpu(slots, capsys):
    argv = ["--prompt", "hi there", "--prompt", "ok", "--max-new-tokens",
            "4", "--device", "cpu", "--serve-slots", str(slots)]
    for s in TINY:
        argv += ["--set", s]
    assert generate_cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "=== prompt 0: 'hi there'" in out
    assert "=== prompt 1: 'ok'" in out


def test_generate_cli_rejects_bad_override(capsys):
    assert generate_cli.main(["--prompt", "x", "--device", "cpu", "--set",
                              "model.nope=1"]) == 2
    assert "generate_cli: error" in capsys.readouterr().err
