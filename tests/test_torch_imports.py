"""The port stands alone: no file of `src/repro_torch/`, `chip_smoke.py` or
the port's examples (`examples/torch_*.py`) imports JAX or the JAX
reference package, and every module of the port imports here, where
there is no CUDA toolkit and no card."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
         + sorted((ROOT / "examples").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = sorted(n for n in _imported(path) if n.split(".")[0] in FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.is_relative_to(PORT)],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_without_cuda(path):
    rel = path.relative_to(PORT.parent).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    importlib.import_module(".".join(parts))


# The modules of the continuous-batching and lifetime slice: each is
# among the files checked above (a deleted or renamed one fails here).
SLICE_MODULES = (
    "serving/scheduler.py", "serving/engine.py", "models/decoding.py",
    "lifetime/__init__.py", "lifetime/drift.py", "lifetime/refresh.py",
    "lifetime/service.py", "obs/__init__.py", "obs/digest.py", "obs/trace.py",
    "obs/ledger.py", "obs/health.py", "obs/metrics.py", "convert.py",
)


# The modules of the faulty-silicon slice (fault maps, give-up, spare
# columns and placement, converter calibration).
FAULT_SLICE_MODULES = (
    "core/device.py", "core/wv.py", "core/pipeline.py", "core/remap.py",
    "core/programmer.py", "cim/tile.py", "readout/calibrate.py",
)


# The modules of the training slice (data, optimizer, train and eval
# steps, checkpoints) and its example.
TRAIN_SLICE_MODULES = (
    "data/synthetic.py", "optim/adamw.py", "optim/schedule.py", "training.py",
    "checkpoint/checkpoint.py",
)


# The modules of the model-family slice (MoE, RWKV6, the SSM branch,
# cross-attention, sinusoidal positions, multi-codebook heads).
FAMILY_SLICE_MODULES = (
    "models/moe.py", "models/rwkv6.py", "models/ssm.py", "models/attention.py",
    "models/layers.py", "models/transformer.py",
)


@pytest.mark.parametrize("rel", SLICE_MODULES + FAULT_SLICE_MODULES + TRAIN_SLICE_MODULES
                         + FAMILY_SLICE_MODULES)
def test_slice_module_is_checked(rel):
    assert PORT / rel in FILES


def test_port_example_is_checked():
    assert ROOT / "examples" / "torch_deploy_rram.py" in FILES
