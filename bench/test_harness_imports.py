"""What the harness and the reference load: no module whose top-level
name is `jax`, `jaxlib`, `flax` or `repro` (the JAX package), compared
whole, and, for the reference, nothing of the port either; and no file
of the benchmark reads the JAX package's `benchmarks/` folder."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent

_PROBE = """
import sys
sys.path[:0] = [{src!r}, {bench!r}]
{imports}
print(",".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _loaded(imports: str) -> set[str]:
    code = _PROBE.format(src=str(BENCH.parent / "src"), bench=str(BENCH), imports=imports)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    return set(out.stdout.strip().split(","))


def test_harness_loads_no_jax():
    mods = _loaded("import run, calibrate\n"
                   "from harness import spec, trace, weights, driver_deploy, driver_serve_closed\n"
                   "for m in ['fwht_roofline', 'mfu.deploy', 'idle.serve']:\n"
                   "    spec.reader(m)\n"
                   "import repro_torch.serving, repro_torch.cim, repro_torch.core.programmer")
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_programs():
    mods = _loaded("from reference import rng, wv, analog_lm\nimport work, work.kernels")
    assert not mods & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_no_file_reads_benchmarks_folder():
    for path in BENCH.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        assert "benchmarks/" not in path.read_text(), path
