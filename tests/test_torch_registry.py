"""The port's model registry (`repro_torch.configs`) against the JAX
package's `repro.configs`: every configuration and smoke configuration,
the runnable cells, the input specs and the materialized inputs.

Every JAX random call runs inside a scoped
``jax.threefry_partitionable(False)`` block (the port keeps the legacy
layout, ROADMAP.md C1).

Tolerances:
* configurations: field for field equal, the reference's `jnp` dtypes
  read as the port's `torch` dtypes of the same name;
* `runnable_cells`, `ARCHS`, `SHAPES`: equal;
* `input_specs`: the same tree paths, shapes and dtype names (meta
  tensors against `ShapeDtypeStruct`s) for every arch x shape, the
  decode caches of every family included;
* the decode spec of each non-dense family: its cache matches the
  reference's, and `decode_step` of the family's smoke model takes the
  materialized decode inputs (logits finite, of the reference's shape);
* `materialize_inputs` on every smoke config: integers bitwise; normals
  (``0.01 * normal``) within 4 ulp: a draw is within 3 ulp of the
  reference's (ROADMAP.md P2) and the product with 0.01 rounds once
  more.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch import configs, pytree
from repro_torch.models import decode_step, init_params

ARCH_NAMES = sorted(jconfigs.ARCHS)
SMALL = [configs.ShapeSpec(f"{k}_small", k, 16, 2) for k in ("train", "prefill", "decode")]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two torch threads for the module, restored after it (the suite
    runs files side by side in worker processes)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _dtype_name(dt) -> str:
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _fields(cfg) -> dict:
    return {f.name: (_dtype_name(v) if f.name in ("dtype", "opt_state_dtype") else v)
            for f in dataclasses.fields(cfg) for v in [getattr(cfg, f.name)]}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_configs_match_reference(arch):
    assert _fields(configs.get_config(arch)) == _fields(jconfigs.get_config(arch))
    assert _fields(configs.get_smoke_config(arch)) == _fields(jconfigs.get_smoke_config(arch))
    assert configs.get_config(arch).param_count() == jconfigs.get_config(arch).param_count()


def test_registry_tables_match_reference():
    assert configs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jconfigs.SHAPES.items()}
    assert configs.runnable_cells() == jconfigs.runnable_cells()
    assert set(configs.DENSE_ARCHS) <= set(configs.ARCHS)
    with pytest.raises(KeyError):
        configs.get_config("gpt-2")


def _spec_leaves(specs, port: bool):
    if port:
        return [(path, tuple(t.shape), _dtype_name(t.dtype))
                for path, t in pytree.leaves_with_path(specs)]
    flat, _ = jax.tree_util.tree_flatten_with_path(specs)
    return [(jax.tree_util.keystr(path), tuple(s.shape), _dtype_name(s.dtype))
            for path, s in flat]


SPEC_CASES = [(a, s) for a in ARCH_NAMES for s in jconfigs.SHAPES]


@pytest.mark.parametrize("arch,shape", SPEC_CASES)
def test_input_specs_match_reference(arch, shape):
    want = jconfigs.input_specs(jconfigs.get_config(arch), jconfigs.SHAPES[shape])
    got = configs.input_specs(configs.get_config(arch), configs.SHAPES[shape])
    assert all(t.device.type == "meta" for t in pytree.leaves(got))
    assert _spec_leaves(got, True) == _spec_leaves(want, False)


@pytest.mark.parametrize("arch", [a for a in ARCH_NAMES if a not in configs.DENSE_ARCHS])
def test_decode_spec_of_unported_family_raises(arch):
    """Before these families were ported their decode spec raised; now
    its cache is the reference's and drives the port's decode step."""
    want = jconfigs.input_specs(jconfigs.get_config(arch), jconfigs.SHAPES["decode_32k"])
    got = configs.input_specs(configs.get_config(arch), configs.SHAPES["decode_32k"])
    assert _spec_leaves(got["cache"], True) == _spec_leaves(want["cache"], False)
    cfg = configs.get_smoke_config(arch)
    spec = next(s for s in SMALL if s.kind == "decode")
    inputs = configs.materialize_inputs(cfg, spec, seed=5, device="cpu")
    logits, cache = decode_step(init_params(0, cfg, device="cpu"), inputs["cache"],
                                inputs["batch"], cfg)
    head = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    assert tuple(logits.shape) == (spec.global_batch, 1, *head, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert sorted(cache) == sorted(inputs["cache"])


def _ulp(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.max(np.abs(ia - ib))) if ia.size else 0


@pytest.mark.parametrize("kind", [s.kind for s in SMALL])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_materialize_inputs_match_reference(arch, kind):
    spec = next(s for s in SMALL if s.kind == kind)
    jspec = jconfigs.ShapeSpec(*dataclasses.astuple(spec))
    with jax.threefry_partitionable(False):
        want = jconfigs.materialize_inputs(jconfigs.get_smoke_config(arch), jspec, seed=5)
    got = configs.materialize_inputs(configs.get_smoke_config(arch), spec, seed=5,
                                     device="cpu")
    flat, _ = jax.tree_util.tree_flatten_with_path(want)
    pairs = dict(pytree.leaves_with_path(got))
    assert sorted(pairs) == sorted(jax.tree_util.keystr(p) for p, _ in flat)
    for path, w in flat:
        g = pairs[jax.tree_util.keystr(path)]
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and _dtype_name(g.dtype) == w.dtype.name
        if g.dtype.is_floating_point:
            assert _ulp(g.numpy(), w) <= 4, jax.tree_util.keystr(path)
        else:
            np.testing.assert_array_equal(g.numpy(), w)
