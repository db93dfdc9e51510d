"""Serving on a device mesh in one process: the port's counterparts of the
reference's single-device mesh tests, on a world-of-one gloo (1, 1)
("data", "model") mesh, and the serving factories' parameter order.

* `deploy_arrays(mesh=)` on a (1, 1) mesh takes the split path (each
  bucket's block sliced, g and the stats packed and gathered over the
  mesh's groups of one) and returns the plain deploy bit for bit, with
  one host fetch.
* `CIMExecutor(mesh=)` stores each tile plane's output channels over
  "model" (`launch.shardings.cim_weight_specs`); on a (1, 1) mesh the
  placement changes no value (the reference's
  `test_cim_weight_sharding_single_device`).
* `ContinuousScheduler(batch_mesh=)` serves the tokens of the meshless
  run with one host sync per decode step and no step function built
  after warmup (`test_sharded_decode_bit_identity_single_device`).
* `make_prefill_step`, `make_prefill_chunk_step`, `make_decode_step` and
  `ServeEngine` take every argument at the reference's position, so a
  positional `mesh` lands on the mesh in both packages.

Arithmetic across ranks is held by the 8-rank job of
`tests/test_torch_sharding.py`.
"""

import inspect

import pytest
import torch

from repro.serving import engine as j_engine
from repro_torch.cim import CIMConfig, CIMExecutor
from repro_torch.core import WVConfig, WVMethod, pipeline, rng
from repro_torch.core.programmer import deploy_arrays
from repro_torch.distributed.collectives import all_gather_axes
from repro_torch.distributed.sharding import is_dtensor
from repro_torch.launch.shardings import cim_weight_specs
from repro_torch.models import ModelConfig, init_params
from repro_torch.serving import ContinuousScheduler, ServeEngine, poisson_requests
from repro_torch.serving import engine as t_engine
from torch_families import one_rank_mesh
from torch_mesh_worker import _deploy_digest

# tests/test_serving_scheduler.py's `_tiny_cfg`.
CFG = ModelConfig(name="sched-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
                  head_dim=16, d_ff=64, vocab_size=64, dtype=torch.float32,
                  attn_chunk_q=16, attn_chunk_kv=16, remat=False, tie_embeddings=False)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """Two torch threads for this module's deploy (a thread per core
    makes its small dispatches many times slower), restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def mesh():
    with one_rank_mesh() as m:
        yield m


@pytest.fixture(scope="module")
def params():
    return init_params(0, CFG, device="cpu")


WV = WVConfig(method=WVMethod.HARP, max_fine_iters=12, max_coarse_iters=4)


def _deploy(params, mesh=None):
    """(model, report, host fetches) of the tiny config's HARP deploy."""
    before = pipeline.host_sync_count()
    model, report = deploy_arrays(rng.PRNGKey(1, device="cpu"), params, WV,
                                  device="cpu", mesh=mesh)
    return model, report, pipeline.host_sync_count() - before


@pytest.fixture(scope="module")
def deployed(params):
    return _deploy(params)


@pytest.mark.parametrize("name", ["make_prefill_step", "make_prefill_chunk_step",
                                  "make_decode_step", "ServeEngine"])
def test_factories_bind_positionally_as_the_reference(name):
    """Each positional argument binds to the same parameter in both
    packages (ROADMAP.md O1: the port once dropped `mesh`, so
    ``ServeEngine(cfg, params, 0.7)`` set the temperature)."""
    ref = inspect.signature(getattr(j_engine, name))
    port = inspect.signature(getattr(t_engine, name))
    positional = [p.name for p in ref.parameters.values()
                  if p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD]
    assert len(positional) >= 2 and "mesh" in positional
    args = [object() for _ in positional]
    got = port.bind_partial(*args).arguments
    want = ref.bind_partial(*args).arguments
    assert list(got) == list(want) == positional
    assert all(got[k] is want[k] for k in positional)
    keyword = [p.name for p in ref.parameters.values()
               if p.kind is inspect.Parameter.KEYWORD_ONLY]
    assert keyword == [p.name for p in port.parameters.values()
                       if p.kind is inspect.Parameter.KEYWORD_ONLY]


def test_mesh_deploy_single_device(mesh, params, deployed, monkeypatch):
    gathers = []

    def counting(x, m, axes, dim=0):
        gathers.append(tuple(axes))
        return all_gather_axes(x, m, axes, dim)

    monkeypatch.setattr(pipeline, "all_gather_axes", counting)
    model, report, syncs = _deploy(params, mesh)
    assert gathers and set(gathers) == {("data", "model")}
    assert syncs == deployed[2] == 1
    assert _deploy_digest(model, report) == _deploy_digest(*deployed[:2])


def test_cim_weight_sharding_single_device(mesh, deployed):
    deployed = deployed[0]
    cim = CIMConfig(dac_bits=4, adc_bits=10, sigma_read_lsb=0.0)
    plain = CIMExecutor(deployed, cim, rng.PRNGKey(7, device="cpu"))
    sharded = CIMExecutor(deployed, cim, rng.PRNGKey(7, device="cpu"), mesh=mesh)
    name = next(iter(sharded._analog))
    w = sharded._analog[name]
    specs = cim_weight_specs(mesh, w)
    assert specs["g_pos"].spec[-1] == "model"
    assert specs["scale"].spec[-1] == "model"
    assert tuple(specs["key"].spec) == ()
    for field in ("g_pos", "g_neg", "scale", "key", "layer_id"):
        a, b = getattr(plain._analog[name], field), getattr(w, field)
        assert is_dtensor(b), field
        assert torch.equal(a, b.full_tensor()), field


def test_sharded_decode_bit_identity_single_device(mesh, params):
    reqs = poisson_requests(11, 8, rate=0.7, vocab=CFG.vocab_size,
                            prompt_lens=(3, 12), max_new=(3, 6))

    def scheduler(batch_mesh):
        return ContinuousScheduler(ServeEngine(CFG, params, temperature=0.7),
                                   n_slots=3, max_len=64, key=rng.PRNGKey(5, device="cpu"),
                                   batch_mesh=batch_mesh, device="cpu")

    plain = scheduler(None)
    plain.warmup(prompt_range=(3, 12))
    base = {r.rid: r.tokens for r in plain.run(reqs)}
    sh = scheduler(mesh)
    sh.warmup(prompt_range=(3, 12))
    warm = dict(sh.trace_counts)
    recs = sh.run(reqs)
    assert {r.rid: r.tokens for r in recs} == base
    assert sh.trace_counts == warm
    assert sh.host_syncs == sh.decode_steps
    assert is_dtensor(sh.cache["k"])
