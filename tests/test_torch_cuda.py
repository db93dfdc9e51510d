"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `requires_cuda`; without a card each test skips (decided inside
the fixture, at run time).  This file imports no JAX, so it also runs on
the machine with the card, which has none:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Tolerances: `fwht` bitwise (same butterfly, same operand order);
`wv_step` streak / frozen / n_p / direction exactly and g within 1e-5
(`powf` in the kernel vs `torch.pow`); `acim_vmm` rtol 1e-4 / atol 1e-2
with the ADC off, and with it on every element outside that tolerance a
sum of whole code flips, under 1% of them (`tests/acim_flips.py`: the
kernel sums each partial sum in another order than cuBLAS).  The
`acim_vmm` cases reach both grid plans (split over tiles at B = 40 with
T = 8, 16 and 24; one block per B- and M-block at B = 1280 and at one
tile; B = 160 and 320, a continuous-batching admission or prefill chunk
of 16 or 32 tokens at 10 DAC planes, split over tiles), both product routes (binary DAC planes through the bf16 x 3
tensor-core products, raw activations through f32 FMAs, and a leaf that
mixes them), ragged B, R and M (M % 4 != 0 and planes at an unaligned
offset take the 4-byte copies), and a captured CUDA graph, whose replay
must equal the eager call bitwise.  Faulty silicon: `wv_step` with a
fault-scaled efficiency operand (weak cells at 0.05, a tile spread), the
fault sampler on the card against the CPU (equal but on threshold ties),
and the spare-candidate ranking on tied gave-up counts against the CPU's
stable sort.  The continuous-batching scheduler
serves a tiny deployment on the card with its dispatches under
`torch.cuda.set_sync_debug_mode("error")`: one host sync per decode
step, no hidden one, and the mode restored.  Training and the paper's
loop: `rng.randint` and `SyntheticLM` batches on the card equal to the
CPU's bitwise; three train steps on the card against the CPU on the same
state (gradients within 1e-4 of each leaf's max, losses within 1e-5,
params within 5e-4 where the gradient is not tiny); the eval loss served
through `acim_vmm_tiled` against the same loss with the wrapper replaced
by its plain version (1e-5 with ideal converters, 1e-3 with the ADC and
read noise on).  The model families: each non-dense smoke config's
forward, prefill and decode on the card against the CPU on the same
float32 params (within 1e-4 of the largest logit: float32 sums in
another order; MoE routing, capacity drops included, the same on both),
and hymba's smoke model deployed on the card and served through
`acim_vmm_tiled` (7 launches per layer and access, in the forward and in
`ServeEngine.generate`) against the same forward with the wrapper
replaced by its plain version (within 1e-5 of the largest logit, ideal
converters).
"""

import numpy as np
import pytest
import torch

from acim_flips import assert_flip_rule
from repro_torch.kernels.acim_vmm import ops as vmm_ops, ref as vmm_ref
from repro_torch.kernels.fwht import ops as fwht_ops, ref as fwht_ref
from repro_torch.kernels.wv_step import ops as wv_ops, ref as wv_ref
from repro_torch.kernels.wv_step.ref import WVCellParams


@pytest.fixture
def cuda():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,n", [(1, 32), (1000, 32), (777, 64), (64, 1024), (5, 8)])
def test_fwht_kernel_bitwise_vs_plain(cuda, c, n):
    gen = torch.Generator(cuda).manual_seed(n)
    x = torch.randn(c, n, device=cuda, generator=gen)
    before = fwht_ops.launches
    got = fwht_ops.fwht(x)
    torch.cuda.synchronize()
    assert fwht_ops.launches == before + 1
    torch.testing.assert_close(got, fwht_ref.fwht(x), rtol=0, atol=0)


@pytest.mark.requires_cuda
def test_fwht_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError):
        fwht_ops.fwht(torch.zeros(4, 32, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        fwht_ops.fwht(torch.zeros(32, 4, device=cuda).t())
    with pytest.raises(ValueError):
        fwht_ops.fwht(torch.zeros(4, 2048, device=cuda))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,n", [(300, 32), (128, 64), (3, 1024)])
@pytest.mark.parametrize("ternary", [True, False])
@pytest.mark.parametrize("can_freeze", [True, False])
def test_wv_step_kernel_vs_plain(cuda, c, n, ternary, can_freeze):
    rs = np.random.RandomState(c + n)
    frozen = rs.rand(c, n) < 0.3
    frozen[: max(1, c // 8)] = True
    args = [
        (rs.randn(c, n) * 8).astype(np.float32),
        np.abs(rs.randn(c, n) * 2).astype(np.float32),
        rs.uniform(0, 7, (c, n)).astype(np.float32),
        rs.randint(0, 3, (c, n)).astype(np.int32),
        frozen,
        (1 + 0.15 * rs.randn(c, n)).astype(np.float32),
        (0.05 * rs.randn(c, n)).astype(np.float32),
        (1 + 0.1 * rs.randn(c, n)).astype(np.float32),
    ]
    targs = [torch.from_numpy(a).to(cuda) for a in args]
    p = WVCellParams(
        threshold=4.0 if ternary else 0.5, k_streak=2, can_freeze=can_freeze,
        ternary=ternary, fine_step=0.25, max_pulses=16.0, g_max=7.0,
        nonlinearity=0.35, reset_asymmetry=0.85, nmap_sqrt_pulses=True,
    )
    before = wv_ops.launches
    got = wv_ops.wv_cell_update(*targs, p)
    torch.cuda.synchronize()
    assert wv_ops.launches == before + 1
    want = wv_ref.wv_cell_update(*targs, p)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _acim_inputs(cuda, seed, b, n_tiles, s, r, m, noise):
    gen = torch.Generator(cuda).manual_seed(seed)
    x = (torch.rand(b, n_tiles * r, device=cuda, generator=gen) < 0.5).float()
    gp = torch.rand(n_tiles, s, r, m, device=cuda, generator=gen) * 7.0
    gn = torch.rand(n_tiles, s, r, m, device=cuda, generator=gen) * 7.0
    nz = (0.3 * torch.randn(n_tiles, s, b, m, device=cuda, generator=gen)
          if noise else None)
    return x, gp, gn, nz


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,n_tiles,r,m", [(40, 8, 128, 200), (33, 3, 70, 65),
                                           (1, 2, 16, 7), (130, 1, 200, 129),
                                           (40, 16, 128, 1024), (40, 24, 128, 1024),
                                           (40, 8, 128, 3072), (1280, 8, 128, 3072),
                                           (40, 8, 128, 201), (97, 5, 36, 130),
                                           (10, 8, 128, 256), (20, 16, 128, 192),
                                           (160, 8, 128, 3072), (320, 8, 128, 3072)])
@pytest.mark.parametrize("adc_bits", [None, 10])
@pytest.mark.parametrize("noise", [False, True])
def test_acim_vmm_tiled_kernel_vs_plain(cuda, b, n_tiles, r, m, adc_bits, noise):
    s, bc = 2, 3
    x, gp, gn, nz = _acim_inputs(cuda, b + m, b, n_tiles, s, r, m, noise)
    fs = 2.0 * r * 7.0
    before = vmm_ops.launches
    got = vmm_ops.acim_vmm_tiled(x, gp, gn, bc=bc, adc_bits=adc_bits,
                                 full_scale=fs, noise=nz)
    torch.cuda.synchronize()
    assert vmm_ops.launches == before + 1
    want = vmm_ref.acim_vmm_tiled(x, gp, gn, bc, adc_bits, fs, nz)
    assert got.shape == (b, m) and got.dtype == torch.float32
    w = fs / (1 << adc_bits) if adc_bits else 1.0
    assert_flip_rule(got.cpu().numpy(), want.cpu().numpy(), w=w, n_tiles=n_tiles,
                     s=s, bc=bc, adc=adc_bits is not None)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("adc_bits", [None, 10])
def test_acim_vmm_single_tile_kernel_vs_plain(cuda, adc_bits):
    b, s, k, m, bc = 45, 2, 96, 77, 3
    x, gp, gn, nz = _acim_inputs(cuda, 5, b, 1, s, k, m, True)
    gp, gn, nz = gp[0], gn[0], nz[0]
    fs = 2.0 * k * 7.0
    before = vmm_ops.launches_single
    got = vmm_ops.acim_vmm(x, gp, gn, bc=bc, adc_bits=adc_bits, full_scale=fs,
                           noise=nz)
    torch.cuda.synchronize()
    assert vmm_ops.launches_single == before + 1
    want = vmm_ref.acim_vmm(x, gp, gn, bc, adc_bits, fs, nz)
    w = fs / (1 << adc_bits) if adc_bits else 1.0
    assert_flip_rule(got.cpu().numpy(), want.cpu().numpy(), w=w, n_tiles=1, s=s,
                     bc=bc, adc=adc_bits is not None)


@pytest.mark.requires_cuda
def test_acim_vmm_kernel_rejects_what_it_does_not_take(cuda):
    x, gp, gn, nz = _acim_inputs(cuda, 1, 4, 2, 2, 16, 8, True)
    kw = dict(bc=3, adc_bits=10, full_scale=224.0)
    with pytest.raises(TypeError):
        vmm_ops.acim_vmm_tiled(x.double(), gp, gn, **kw)
    with pytest.raises(ValueError):
        vmm_ops.acim_vmm_tiled(x[:, :16], gp, gn, **kw)
    with pytest.raises(ValueError):
        vmm_ops.acim_vmm_tiled(x, gp, gn, noise=nz[:, :, :2], **kw)
    with pytest.raises(ValueError):
        vmm_ops.acim_vmm_tiled(x, gp.transpose(2, 3), gn.transpose(2, 3), **kw)


def _raw_inputs(cuda, seed, b, n_tiles, s, r, m, x_kind):
    """Raw (randn) or part-binary x, and planes sliced out of a stacked
    two-layer leaf as `CIMWeight.layer(1)` slices them (unaligned for
    M % 4 != 0)."""
    gen = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(b, n_tiles * r, device=cuda, generator=gen)
    if x_kind == "mixed":       # even tiles binary, odd tiles raw
        bits = (torch.rand(b, n_tiles * r, device=cuda, generator=gen) < 0.5).float()
        even = (torch.arange(n_tiles * r, device=cuda) // r) % 2 == 0
        x = torch.where(even, bits, x)
    gp = torch.rand(2, n_tiles, s, r, m, device=cuda, generator=gen)[1] * 7.0
    gn = torch.rand(2, n_tiles, s, r, m, device=cuda, generator=gen)[1] * 7.0
    nz = 0.3 * torch.randn(n_tiles, s, b, m, device=cuda, generator=gen)
    return x, gp, gn, nz


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,n_tiles,r,m,x_kind", [
    (40, 8, 128, 3072, "raw"), (1280, 8, 128, 3072, "raw"), (40, 24, 128, 1024, "raw"),
    (33, 3, 70, 65, "raw"), (40, 8, 128, 201, "mixed"), (130, 4, 100, 67, "mixed"),
    (45, 1, 96, 77, "raw")])
@pytest.mark.parametrize("adc_bits", [None, 10])
def test_acim_vmm_kernel_raw_x_vs_plain(cuda, b, n_tiles, r, m, x_kind, adc_bits):
    s, bc = 2, 3
    x, gp, gn, nz = _raw_inputs(cuda, b * m + r, b, n_tiles, s, r, m, x_kind)
    fs = 2.0 * r * 7.0
    if n_tiles == 1:            # the one-tile form
        before = vmm_ops.launches_single
        got = vmm_ops.acim_vmm(x, gp[0], gn[0], bc=bc, adc_bits=adc_bits,
                               full_scale=fs, noise=nz[0])
        want = vmm_ref.acim_vmm(x, gp[0], gn[0], bc, adc_bits, fs, nz[0])
        torch.cuda.synchronize()
        assert vmm_ops.launches_single == before + 1
    else:
        before = vmm_ops.launches
        got = vmm_ops.acim_vmm_tiled(x, gp, gn, bc=bc, adc_bits=adc_bits,
                                     full_scale=fs, noise=nz)
        want = vmm_ref.acim_vmm_tiled(x, gp, gn, bc, adc_bits, fs, nz)
        torch.cuda.synchronize()
        assert vmm_ops.launches == before + 1
    w = fs / (1 << adc_bits) if adc_bits else 1.0
    assert_flip_rule(got.cpu().numpy(), want.cpu().numpy(), w=w, n_tiles=n_tiles,
                     s=s, bc=bc, adc=adc_bits is not None)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("b,n_tiles", [(40, 8), (1280, 8)])
def test_acim_vmm_kernel_replays_in_cuda_graph(cuda, b, n_tiles):
    r, m, s = 128, 3072, 2
    assert vmm_ops._plan(b, n_tiles, m, vmm_ops._sm_count(cuda)) is (b == 40)
    x, gp, gn, nz = _acim_inputs(cuda, 3, b, n_tiles, s, r, m, True)
    kw = dict(bc=3, adc_bits=10, full_scale=2.0 * r * 7.0, noise=nz)
    eager = vmm_ops.acim_vmm_tiled(x, gp, gn, **kw)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = vmm_ops.acim_vmm_tiled(x, gp, gn, **kw)
    captured.fill_(float("nan"))
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(captured, eager, rtol=0, atol=0)


@pytest.mark.requires_cuda
def test_scheduler_dispatch_has_no_hidden_sync(cuda):
    """Analog continuous batching with a lifetime scrub between decode
    steps, on the card: every dispatch runs with sync debugging set to
    "error", so a hidden device->host sync would raise here."""
    from repro_torch.cim import CIMConfig, CIMExecutor
    from repro_torch.configs.qwen3_0_6b import SMOKE_CONFIG
    from repro_torch.core import WVConfig, WVMethod, rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.lifetime import LifetimeSimulator
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousScheduler, ServeEngine, poisson_requests

    cfg = SMOKE_CONFIG
    params = init_params(0, cfg, device="cuda")
    model, _ = deploy_arrays(rng.PRNGKey(1, device="cuda"), params,
                             WVConfig(method=WVMethod.HARP, max_fine_iters=8,
                                      max_coarse_iters=4), device="cuda")
    ex = CIMExecutor(model, CIMConfig(dac_bits=6, adc_bits=10, sigma_read_lsb=0.2),
                     rng.PRNGKey(2, device="cuda"))
    sim = LifetimeSimulator(rng.PRNGKey(3, device="cuda"), model,
                            traffic_fn=ex.drain_reads)
    epochs = []
    sched = ContinuousScheduler(
        ServeEngine(cfg, executor=ex, temperature=0.7), n_slots=3, max_len=64,
        key=rng.PRNGKey(4, device="cuda"), prefill_chunk_tokens=16,
        maintenance_fn=lambda: epochs.append(sim.step_epoch(3600.0, max_leaves=2)),
        maintenance_every=2)
    sched.warmup(prompt_range=(3, 40))
    warm = dict(sched.trace_counts)
    recs = sched.run(poisson_requests(0, 6, rate=1.0, vocab=cfg.vocab_size,
                                      prompt_lens=(3, 40), max_new=(3, 8)))
    assert len(recs) == 6 and sched.trace_counts == warm
    assert sched.host_syncs == sched.decode_steps > 0 and len(epochs) > 0
    assert torch.cuda.get_sync_debug_mode() == 0
    x = torch.ones(1, device=cuda)
    with pytest.raises(RuntimeError):
        with sched._no_sync():
            x.item()
    assert torch.cuda.get_sync_debug_mode() == 0


# Faulty silicon: the fault population of `benchmarks/fault_tolerance.py`
# at its highest rate, with a tile-level efficiency spread on top.
_FAULTS = dict(p_stuck_hrs=0.01, p_stuck_lrs=0.005, p_weak=0.005,
               sigma_tile_fault_dec=0.5, sigma_tile_eff_frac=0.1,
               columns_per_tile=64, tiles_per_chip=16)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c", [4096, 37])
def test_wv_step_kernel_with_fault_scaled_efficiency(cuda, c):
    """The deploy under faults hands `wv_step` ``d2d * fault.efficiency``
    (weak cells at 0.05, tile spread) and re-pins stuck cells after it."""
    from repro_torch.core import device as dev_mod, rng
    from repro_torch.core.types import DeviceConfig, FaultConfig

    n = 32
    uids = torch.arange(c, device=cuda, dtype=torch.int64) * 3 + 1000
    key = rng.PRNGKey(9, device=cuda)
    fault = dev_mod.sample_fault_map(key, uids, (c, n), FaultConfig(**_FAULTS),
                                     DeviceConfig())
    assert bool((fault.efficiency < 0.1).any()) and bool(fault.stuck.any())
    gen = torch.Generator(cuda).manual_seed(c)
    r = lambda: torch.randn(c, n, device=cuda, generator=gen)  # noqa: E731
    d2d = (1.0 + 0.1 * r()) * fault.efficiency
    args = (r() * 8.0, r().abs() * 2.0, torch.rand(c, n, device=cuda, generator=gen) * 7.0,
            torch.randint(0, 3, (c, n), device=cuda, generator=gen, dtype=torch.int32),
            torch.rand(c, n, device=cuda, generator=gen) < 0.3,
            1.0 + 0.15 * r(), 0.05 * r(), d2d)
    p = WVCellParams(threshold=4.0, k_streak=2, can_freeze=True, ternary=True,
                     fine_step=0.25, max_pulses=16.0, g_max=7.0, nonlinearity=0.35,
                     reset_asymmetry=0.85, nmap_sqrt_pulses=True)
    got = wv_ops.wv_cell_update(*args, p)
    want = wv_ref.wv_cell_update(*args, p)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    pinned = dev_mod.clamp_stuck(got[0], fault)
    assert bool((pinned[fault.stuck] == fault.stuck_g[fault.stuck]).all())


def _near_threshold(key, uids, shape, fc, dev) -> torch.Tensor:
    """Cells whose classifying uniform lies within 1e-6 (relative) of one
    of `sample_fault_map`'s thresholds, recomputed on the CPU."""
    from repro_torch.core import device as dev_mod, rng

    fkey = rng.fold_in(key, dev_mod._FAULT_SALT)
    k_kind, _ = rng.split(rng.fold_col_keys(fkey, uids))
    u = rng.uniform(k_kind, shape)
    mult = dev_mod.tile_quality(key, dev_mod.tile_ids(uids, fc), fc)[:, None]
    near = torch.zeros(shape, dtype=torch.bool)
    p = torch.zeros_like(mult)
    for rate in (fc.p_stuck_hrs, fc.p_stuck_lrs, fc.p_weak, fc.p_exhausted):
        p = p + rate * mult
        near |= (u - p).abs() <= 1e-6 * p
    return near


@pytest.mark.requires_cuda
def test_sample_fault_map_on_card_matches_cpu(cuda):
    """The fault map drawn on the card equals the CPU's: stuck / stuck_g
    except on threshold ties (the tile multiplier is an `exp` of a normal
    draw, whose ulps may differ), efficiency within rtol 1e-6."""
    from repro_torch.core import device as dev_mod, rng
    from repro_torch.core.types import DeviceConfig, FaultConfig

    fc, dev = FaultConfig(**_FAULTS, sigma_chip_eff_frac=0.05), DeviceConfig()
    uids = torch.from_numpy(np.random.RandomState(0).choice(
        21_000_000, 1 << 14, replace=False).astype(np.int64))
    shape = (uids.shape[0], 32)
    cpu = dev_mod.sample_fault_map(rng.PRNGKey(7, device="cpu"), uids, shape, fc, dev)
    card = dev_mod.sample_fault_map(rng.PRNGKey(7, device=cuda), uids.to(cuda), shape,
                                    fc, dev)
    differ = (card.stuck.cpu() != cpu.stuck) | (card.stuck_g.cpu() != cpu.stuck_g)
    assert not bool((differ & ~_near_threshold(rng.PRNGKey(7, device="cpu"), uids,
                                               shape, fc, dev)).any())
    torch.testing.assert_close(card.efficiency.cpu(), cpu.efficiency, rtol=1e-6, atol=0)
    assert 0 < int(cpu.stuck.sum()) < cpu.stuck.numel()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("c,s", [(1 << 16, 1 << 14), (1000, 250), (7, 7)])
def test_spare_candidates_on_card_match_cpu(cuda, c, s):
    """Gave-up counts are small integers held in float32, so most columns
    tie: the card's stable sort must pick the CPU's candidates, in order."""
    from repro_torch.core import remap

    counts = torch.from_numpy(np.random.RandomState(c).poisson(0.3, c).astype(np.float32))
    want = remap.spare_candidates(counts, s)
    got = remap.spare_candidates(counts.to(cuda), s)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    spare = torch.from_numpy(np.random.RandomState(s).poisson(0.2, s).astype(np.float32))
    t_cpu = remap.build_table(counts, want, spare)
    t_card = remap.build_table(counts.to(cuda), got, spare.to(cuda))
    for a, b in zip(t_card, t_cpu):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)


# Training and the paper's loop (train, deploy, eval loss) on the card.
_TINY = dict(name="bench-lm", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=64, attn_chunk_q=32,
             attn_chunk_kv=32, remat=False)
_DATA = dict(vocab_size=64, seq_len=64, global_batch=16, seed=3)


def _tiny_cfg():
    from repro_torch.models import ModelConfig

    return ModelConfig(dtype=torch.float32, **_TINY)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("seed,shape,lo,hi", [(0, (8,), 0, 151936), (5, (7, 33), -5, 1000003),
                                              (2, (9,), 10, 3), (3, (16, 64), 0, 16)])
def test_randint_on_card_matches_cpu(cuda, seed, shape, lo, hi):
    from repro_torch.core import rng

    got = rng.randint(rng.PRNGKey(seed, device="cuda"), shape, lo, hi)
    want = rng.randint(rng.PRNGKey(seed, device="cpu"), shape, lo, hi)
    assert got.device.type == "cuda" and torch.equal(got.cpu(), want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("data", [_DATA, dict(vocab_size=151936, seq_len=256, global_batch=8,
                                              seed=0)], ids=["fig10", "qwen3-0.6b"])
def test_synthetic_batches_on_card_match_cpu(cuda, data):
    from repro_torch.data import SyntheticLM

    for step in (0, 1, 10_000):
        got = SyntheticLM(**data, device="cuda").global_batch_at(step)
        want = SyntheticLM(**data, device="cpu").global_batch_at(step)
        for a, b in zip(got, want):
            assert a.device.type == "cuda" and torch.equal(a.cpu(), b)


@pytest.mark.requires_cuda
def test_train_steps_on_card_match_cpu(cuda):
    """The same state and batches through 3 train steps on the card and on
    the CPU: gradients per leaf within 1e-4 of its max, losses within
    1e-5, params within 5e-4 where the gradient exceeds 1e-4 of its
    leaf's max (Adam's first steps are nearly sign(g), see
    tests/test_torch_train.py)."""
    from repro_torch import pytree
    from repro_torch.data import SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.training import _grads_of, init_train_state, make_train_step

    cfg, opt = _tiny_cfg(), AdamWConfig(lr_peak=1e-2)
    cpu_state = init_train_state(0, cfg, opt, device="cpu")
    card_state = pytree.tree_map(lambda t: t.to("cuda"), cpu_state)
    step = make_train_step(cfg, opt, total_steps=20)
    held = None
    for i in range(3):
        bc = SyntheticLM(**_DATA, device="cpu").global_batch_at(i)._asdict()
        bg = SyntheticLM(**_DATA, device="cuda").global_batch_at(i)._asdict()
        _, g_cpu = _grads_of(cpu_state.params, bc, cfg)
        _, g_card = _grads_of(card_state.params, bg, cfg)
        big = []
        for a, b in zip(pytree.leaves(g_cpu), pytree.leaves(g_card)):
            err = float((b.cpu() - a).abs().max() / a.abs().max())
            assert err <= 1e-4, (i, err)
            big.append(a.abs() > 1e-4 * a.abs().max())
        held = big if held is None else [h & n for h, n in zip(held, big)]
        cpu_state, m_cpu = step(cpu_state, bc)
        card_state, m_card = step(card_state, bg)
        assert abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-5
    for a, b, h in zip(pytree.leaves(cpu_state.params), pytree.leaves(card_state.params), held):
        assert b.device.type == "cuda"
        assert float((b.cpu() - a).abs()[h].max()) <= 5e-4


@pytest.mark.requires_cuda
@pytest.mark.parametrize("cim", [dict(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0),
                                 dict(dac_bits=6, adc_bits=10, sigma_read_lsb=0.7)],
                         ids=["ideal", "noisy"])
def test_in_array_eval_loss_kernel_vs_plain(cuda, cim, monkeypatch):
    """The eval loss served through the arrays: with `acim_vmm_tiled`
    launching its kernel, and with the same wrapper replaced by its plain
    version on the same card tensors.  Ideal converters: within 1e-5;
    DAC 6 / ADC 10 bits and 0.7 LSB read noise: within 1e-3 (a few ADC
    codes flip, `tests/acim_flips.py`)."""
    from repro_torch.cim import CIMConfig, CIMExecutor
    from repro_torch.core import NoiseConfig, WVMethod, default_config_for_array, rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.data import SyntheticLM
    from repro_torch.models import init_params
    from repro_torch.models.transformer import loss_fn

    cfg = _tiny_cfg()
    params = init_params(0, cfg, device="cuda")
    wv = default_config_for_array(32).replace(method=WVMethod.HARP,
                                              noise=NoiseConfig(sigma_read_lsb=0.7))
    model, _ = deploy_arrays(rng.PRNGKey(42, device="cuda"), params, wv, device="cuda")
    batch = SyntheticLM(**_DATA, device="cuda").global_batch_at(10_000)._asdict()

    def eval_loss() -> float:
        ex = CIMExecutor(model, CIMConfig(**cim), rng.PRNGKey(7, device="cuda"))
        with torch.no_grad():
            return float(loss_fn(ex.params(), batch, cfg)[0])

    before = vmm_ops.launches
    kernel = eval_loss()
    assert vmm_ops.launches - before == 7 * cfg.n_layers
    monkeypatch.setattr(vmm_ops, "acim_vmm_tiled",
                        lambda x, gp, gn, *, bc, adc_bits, full_scale, noise=None:
                        vmm_ref.acim_vmm_tiled(x, gp, gn, bc, adc_bits, full_scale, noise))
    plain = eval_loss()
    assert np.isfinite(kernel)
    assert abs(kernel - plain) <= (1e-5 if cim["adc_bits"] is None else 1e-3), (kernel, plain)


_FAMILIES = ("olmoe-1b-7b", "qwen3-moe-235b-a22b", "rwkv6-1.6b", "hymba-1.5b",
             "llama-3.2-vision-11b", "musicgen-medium")


def _family_batch(cfg, s: int, device) -> dict:
    gen = torch.Generator().manual_seed(s)
    batch = {}
    if cfg.frontend == "embed_stub":
        batch["embeds"] = torch.randn(2, s, cfg.d_model, generator=gen)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab_size, (2, s), generator=gen,
                                        dtype=torch.int32)
    if cfg.cross_kv_len:
        batch["cond"] = torch.randn(2, cfg.cross_kv_len, cfg.cross_d_cond, generator=gen)
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.requires_cuda
@pytest.mark.parametrize("arch", _FAMILIES)
def test_family_on_card_matches_cpu(cuda, arch):
    from repro_torch import pytree
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import decode_step, forward, init_params, prefill

    cfg = get_smoke_config(arch)
    params = init_params(0, cfg, device="cpu")
    on_card = pytree.tree_map(lambda t: t.to(cuda), params)

    def run(p, device):
        batch = _family_batch(cfg, 19, device)
        logits, _, _ = forward(p, batch, cfg)
        pre = {k: (v[:, :15] if k in ("tokens", "embeds") else v) for k, v in batch.items()}
        _, cache = prefill(p, pre, cfg, max_len=24)
        steps = []
        for t in range(15, 19):
            one = {k: (v[:, t:t + 1] if k in ("tokens", "embeds") else v)
                   for k, v in batch.items()}
            lg, cache = decode_step(p, cache, one, cfg)
            steps.append(lg)
        return [logits] + steps

    for got, want in zip(run(on_card, cuda), run(params, "cpu")):
        err = (got.cpu() - want).abs().max() / want.abs().max()
        assert err <= 1e-4, (arch, float(err))


@pytest.mark.requires_cuda
def test_hymba_served_on_card_kernel_vs_plain(cuda, monkeypatch):
    from repro_torch.cim import CIMConfig, CIMExecutor
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import WVConfig, WVMethod, rng
    from repro_torch.core.programmer import deploy_arrays
    from repro_torch.models import forward, init_params
    from repro_torch.serving import ServeEngine

    cfg = get_smoke_config("hymba-1.5b")
    params = init_params(0, cfg, device="cuda")
    model, _ = deploy_arrays(rng.PRNGKey(1, device="cuda"), params,
                             WVConfig(method=WVMethod.HARP, max_fine_iters=8,
                                      max_coarse_iters=4), device="cuda")
    toks = _family_batch(cfg, 12, cuda)["tokens"]
    ideal = CIMConfig(dac_bits=None, adc_bits=None, sigma_read_lsb=0.0)

    def served_logits():
        ex = CIMExecutor(model, ideal, rng.PRNGKey(7, device="cuda"))
        with torch.no_grad():
            return forward(ex.params(), {"tokens": toks}, cfg)[0], ex

    before = vmm_ops.launches
    kernel, ex = served_logits()
    assert vmm_ops.launches - before == 7 * cfg.n_layers and len(ex._analog) == 7
    before = vmm_ops.launches
    out = ServeEngine(cfg, executor=ex).generate(toks, 5)
    assert vmm_ops.launches - before == 5 * 7 * cfg.n_layers
    assert out.shape == (2, 5) and bool(((out >= 0) & (out < cfg.vocab_size)).all())
    monkeypatch.setattr(vmm_ops, "acim_vmm_tiled",
                        lambda x, gp, gn, *, bc, adc_bits, full_scale, noise=None:
                        vmm_ref.acim_vmm_tiled(x, gp, gn, bc, adc_bits, full_scale, noise))
    plain, _ = served_logits()
    assert float((kernel - plain).abs().max() / plain.abs().max()) <= 1e-5
