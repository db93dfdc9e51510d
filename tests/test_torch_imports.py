"""The port stands alone: no file of `src/repro_torch/`, `chip_smoke.py` or
the port's examples (`examples/torch_*.py`) imports JAX or the JAX
reference package, and every module of the port imports here, where
there is no CUDA toolkit and no card.  And the port is whole: every
public name of each reference module is in the port's module of the same
name, which both files' syntax trees show (neither is imported)."""

import ast
import importlib
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
REFERENCE = ROOT / "src" / "repro"
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


# The modules of the mesh-training slice (meshes and sharding rules, the
# sharded train step's collectives, int8 cross-pod gradients, fault
# tolerance and the launcher).
MESH_SLICE_MODULES = (
    "launch/__init__.py", "launch/mesh.py", "launch/shardings.py", "launch/train.py",
    "distributed/__init__.py", "distributed/sharding.py", "distributed/collectives.py",
    "distributed/fault.py", "distributed/straggler.py", "models/act_sharding.py",
    "optim/compression.py",
)


# The modules of the launch-tools slice (the dry run counted on the meta
# device, the roofline terms, their report, `program.py --dryrun`).
LAUNCH_SLICE_MODULES = (
    "launch/dryrun.py", "launch/roofline.py", "launch/report.py", "launch/program.py",
    "obs/work.py",
)


# The rematerialisation slice (the reference's `jax.checkpoint` places).
REMAT_SLICE_MODULES = ("models/remat.py",)


@pytest.mark.parametrize("rel", SLICE_MODULES + FAULT_SLICE_MODULES + TRAIN_SLICE_MODULES
                         + FAMILY_SLICE_MODULES + MESH_SLICE_MODULES
                         + LAUNCH_SLICE_MODULES + REMAT_SLICE_MODULES)
def test_slice_module_is_checked(rel):
    assert PORT / rel in FILES


def test_port_example_is_checked():
    assert ROOT / "examples" / "torch_deploy_rram.py" in FILES


def test_train_example_is_checked():
    assert ROOT / "examples" / "torch_train_lm.py" in FILES


# Reference files and names with no counterpart in the port, and why.
# The Pallas kernels: a CUDA kernel replaces each, behind the `ops.py` /
# `ref.py` pair of its package.
NOT_PORTED_FILES = {
    "kernels/fwht/fwht.py": "kernels/csrc/fwht.cu",
    "kernels/wv_step/wv_step.py": "kernels/csrc/wv_step.cu",
    "kernels/acim_vmm/acim_vmm.py": "kernels/csrc/acim_vmm.cu",
}
NOT_PORTED_NAMES = {
    # They read XLA's artifacts (the HLO text, `cost_analysis()`), which
    # PyTorch does not make: the port counts its ops instead.
    "launch/roofline.py": {"collective_bytes_from_hlo", "summarize_cost_analysis"},
}
REFERENCE_FILES = sorted(p.relative_to(REFERENCE).as_posix()
                         for p in REFERENCE.rglob("*.py"))


def _public_names(path: pathlib.Path) -> set[str]:
    """Public top-level defs, classes and assigned names; for a package's
    `__init__.py`, also the names it re-exports from its own modules."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif (isinstance(node, ast.ImportFrom) and path.name == "__init__.py"
              and (node.level > 0 or (node.module or "").startswith("repro"))):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("rel", REFERENCE_FILES)
def test_port_has_every_public_name_of_the_reference(rel):
    if rel in NOT_PORTED_FILES:
        assert (PORT / NOT_PORTED_FILES[rel]).exists()
        return
    assert (PORT / rel).exists(), f"the port has no {rel}"
    missing = (_public_names(REFERENCE / rel) - _public_names(PORT / rel)
               - NOT_PORTED_NAMES.get(rel, set()))
    assert not missing, f"{rel}: the port lacks {sorted(missing)}"


def test_not_ported_names_are_the_references():
    for rel, names in NOT_PORTED_NAMES.items():
        assert names <= _public_names(REFERENCE / rel)
        assert not names & _public_names(PORT / rel)


# Reference class members with no counterpart in the port, and why.
NOT_PORTED_MEMBERS = {
    # JAX pytree hooks: the port's trees are walked by `repro_torch.pytree`.
    ("obs/digest.py", "StreamingDigest"): {"tree_flatten", "tree_unflatten"},
    ("obs/metrics.py", "MetricAccumulator"): {"tree_flatten", "tree_unflatten"},
    # The JAX pytree layout of the deployed tree; the port keeps the
    # tree's structure as named leaves (`names`, `digital`).
    ("core/programmer.py", "DeployedModel"): {"leaves", "slots", "treedef"},
    # Read from XLA's HLO text, which PyTorch does not make.
    ("launch/roofline.py", "RooflineTerms"): {"hlo_bytes", "hlo_flops"},
}
# The reference's WV loop carry for `lax.while_loop`; the port's loop is
# a Python loop over plain tensors.
NOT_PORTED_CLASSES = {("core/wv.py", "_LoopState")}


def _class_members(path: pathlib.Path) -> dict[str, set[str]]:
    """Each top-level class's public methods, properties and class
    attributes (dataclass and named-tuple fields included)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    out = {}
    for node in tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        names = set()
        for b in node.body:
            if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.add(b.name)
            elif isinstance(b, ast.Assign):
                names.update(t.id for t in b.targets if isinstance(t, ast.Name))
            elif isinstance(b, ast.AnnAssign) and isinstance(b.target, ast.Name):
                names.add(b.target.id)
        out[node.name] = {n for n in names if not n.startswith("_")}
    return out


CLASS_FILES = [rel for rel in REFERENCE_FILES
               if rel not in NOT_PORTED_FILES and _class_members(REFERENCE / rel)]


@pytest.mark.parametrize("rel", CLASS_FILES)
def test_port_classes_have_every_member_of_the_reference(rel):
    port = _class_members(PORT / rel)
    for cls, names in _class_members(REFERENCE / rel).items():
        if (rel, cls) in NOT_PORTED_CLASSES:
            assert cls not in port
            continue
        assert cls in port, f"{rel}: the port has no class {cls}"
        missing = names - port[cls] - NOT_PORTED_MEMBERS.get((rel, cls), set())
        assert not missing, f"{rel}: the port's {cls} lacks {sorted(missing)}"


def test_not_ported_members_are_the_references():
    for (rel, cls), names in NOT_PORTED_MEMBERS.items():
        ref, port = _class_members(REFERENCE / rel), _class_members(PORT / rel)
        assert names <= ref[cls]
        assert not names & port[cls]
    for rel, cls in NOT_PORTED_CLASSES:
        assert cls in _class_members(REFERENCE / rel)
