"""Roofline terms of the port's programs on H100 SXM cards, from counts.

Three terms per (arch x shape x mesh), in seconds:

    compute    = sum over dtype classes of FLOPs / (chips * rate)
                 [bf16: 989e12 dense tensor cores; f32: 67e12, TF32 off]
    memory     = bytes / (chips * 3.35e12 B/s)              [HBM3]
    collective = sum over mesh axes of bytes / link rate
                 [NVLink 450e9 B/s per direction inside an 8-GPU node;
                  one 400 Gb/s NIC, 50e9 B/s, per GPU across nodes]

The reference lowers its steps with XLA and reads `cost_analysis()` and
the HLO text.  The port runs eager PyTorch, so it counts instead:
`WorkCounter` is a `TorchDispatchMode` that sees every aten op of a
step, on the ``meta`` device (shapes only: no card, no data) or on real
tensors, and adds

* FLOPs of matmuls and attention, by `torch.utils.flop_counter`'s
  formulas, split by the class of their operands' dtype;
* bytes: each op's inputs read once and its outputs written once, which
  is what an eager program moves (a view moves nothing; a broadcast
  operand is read once per distinct element; a gather reads the rows it
  selects; an in-place scatter writes the region it covers);
* the port's own kernels, whose wrappers add their `work()` (the same
  formula `chip_smoke.py` bounds them by) through `obs.work.add_kernel`
  where they launch, and on a meta tensor instead of launching;
* the port's collectives (`distributed.collectives`), which add their
  result-shape bytes through `obs.work.add_collective` per op type and mesh axis, as the reference's HLO
  parser does, on a real mesh and on a `launch.mesh.AbstractMesh`;
* the peak of the bytes that the ops' outputs keep alive at once.

The reference's `collective_bytes_from_hlo` and
`summarize_cost_analysis` read XLA artifacts; PyTorch has no HLO and no
cost analysis, so they have no counterpart here.  MODEL_FLOPS uses
6*N*D (dense) or 6*N_active*D (MoE) for train cells and 2*N*D for
inference cells, as the reference's does.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import json
import math
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.obs import work

__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW", "HBM_BYTES", "NVLINK_BW", "ICI_BW",
           "GPUS_PER_NODE", "RATES", "WorkCounter", "link_bw", "bound_s", "RooflineTerms", "model_flops",
           "summarize_memory_analysis", "save_results"]

PEAK_FLOPS = 989e12        # bf16 dense tensor-core FLOP/s per H100 SXM
PEAK_FLOPS_F32 = 67e12     # float32 FLOP/s per H100 SXM (TF32 off)
HBM_BW = 3.35e12           # bytes/s per card
HBM_BYTES = 80e9           # the card's device memory
NVLINK_BW = 450e9          # bytes/s per direction per GPU inside a node
ICI_BW = 50e9              # bytes/s per GPU between nodes: one 400 Gb/s NIC
GPUS_PER_NODE = 8
RATES = {"bf16": PEAK_FLOPS, "f32": PEAK_FLOPS_F32}

_HALF = (torch.bfloat16, torch.float16)
_A = torch.ops.aten
# Ops that allocate memory without touching it.
_ALLOC = {_A.empty.memory_format, _A.empty_like.default, _A.empty_strided.default,
          _A.new_empty.default, _A.new_empty_strided.default}
# Ops that relabel memory without reading or writing it.
_RELABEL = {_A._unsafe_view.default, _A.lift_fresh.default, _A.detach.default,
            _A.alias.default, _A.set_.source_Storage_storage_offset,
            _A.resize_.default}
# In-place ops that write their first argument without reading it.
_WRITE_ONLY = {_A.fill_.Scalar, _A.fill_.Tensor, _A.zero_.default, _A.copy_.default,
               _A.uniform_.default, _A.normal_.default, _A.random_.default,
               getattr(_A.random_, "from"), _A.random_.to, _A.bernoulli_.float,
               _A.exponential_.default}
# Ops that read only the source elements they select.
_GATHERS = {_A.index.Tensor, _A.index_select.default, _A.gather.default,
            _A.embedding.default, _A.take.default}
# In-place scatters: (index of the argument whose elements are written,
# whether the written region is read too).
_SCATTERS = {_A.index_put_.default: (2, False), _A._index_put_impl_.default: (2, False),
             _A.index_add_.default: (3, True), _A.index_copy_.default: (3, False),
             _A.scatter_.src: (3, False), _A.scatter_.value: (2, False),
             _A.scatter_add_.default: (3, True), _A.scatter_reduce_.two: (3, True)}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")

def _dtype_class(dtype: torch.dtype) -> str:
    return "bf16" if dtype in _HALF else "f32"


def _plain(x) -> bool:
    return type(x) in (torch.Tensor, torch.nn.Parameter)


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements `t` addresses (a stride-0 dim of a
    broadcast is read once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _tensors(obj, out: list) -> list:
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            _tensors(o, out)
    elif isinstance(obj, dict):
        for o in obj.values():
            _tensors(o, out)
    return out


@functools.cache
def _mutated(func) -> tuple[int, ...]:
    return tuple(i for i, a in enumerate(func._schema.arguments)
                 if a.alias_info is not None and a.alias_info.is_write)


@functools.cache
def _fresh(func) -> bool:
    """Whether `func`'s outputs are new tensors: it neither mutates nor
    returns a view of its arguments."""
    return not (func in _RELABEL or func.is_view or _mutated(func)
                or any(r.alias_info is not None for r in func._schema.returns))


def _meta_key(obj):
    """A hashable key of an op's arguments when every tensor among them is
    a meta tensor (tensors by shape, strides and dtype), else None."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "meta" or not _plain(obj):
            return None
        return ("t", tuple(obj.shape), obj.stride(), obj.dtype)
    if isinstance(obj, (list, tuple)):
        parts = tuple(_meta_key(o) for o in obj)
        return None if any(p is None for p in parts) else (type(obj).__name__, parts)
    if isinstance(obj, dict):
        return _meta_key(tuple(sorted(obj.items(), key=lambda kv: kv[0])))
    try:
        hash(obj)
    except TypeError:
        return None
    return (type(obj).__name__, obj)


def _op_bytes(func, args, kwargs, out) -> float:
    """Bytes one aten op reads and writes (see the module docstring)."""
    if func in _ALLOC or func in _RELABEL or func.is_view:
        return 0.0
    outs = [t for t in _tensors(out, []) if _plain(t)]
    if func in _WRITE_ONLY:
        written = _nbytes(args[0])
        src = [t for t in _tensors(args[1:], []) if _plain(t)]
        return written + sum(_nbytes(t) for t in src)
    if func in _SCATTERS:
        at, rmw = _SCATTERS[func]
        region = args[at] if at < len(args) and isinstance(args[at], torch.Tensor) else None
        reads = [t for t in _tensors(args[1:], []) if _plain(t)]
        written = (region.numel() if region is not None else
                   max((t.numel() for t in reads), default=0)) * args[0].element_size()
        return sum(_nbytes(t) for t in reads) + written * (2 if rmw else 1)
    if func in _GATHERS:
        src = args[0]
        ins = [t for t in _tensors((args, kwargs), []) if _plain(t) and t is not src]
        return 2.0 * sum(_nbytes(t) for t in outs) + sum(_nbytes(t) for t in ins)
    ins = [t for t in _tensors((args, kwargs), []) if _plain(t)]
    mut = _mutated(func)
    if mut:      # in place: the mutated argument is read and written
        outs = [args[i] for i in mut if i < len(args)]
    return float(sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs))


class WorkCounter(TorchDispatchMode):
    """Counts the work of the ops run inside it (see the module
    docstring); every count is of this process, one device.

    `flops` maps a dtype class ("bf16", "f32") to FLOPs; `bytes` is the
    bytes moved; `kernels` maps a kernel's name to its calls, bytes and
    FLOPs (included in `flops` and `bytes`); `collectives` maps an op
    type ("all-gather", "all-reduce") to its result bytes and count, and
    `collective_axes` a mesh axis to its bytes; `ops` counts each aten
    op; `peak_bytes` is the most that the outputs of the ops kept alive
    at once (tensors made before the counter opened are not included).
    """

    def __init__(self):
        super().__init__()
        self.flops: dict[str, float] = collections.defaultdict(float)
        self.bytes = 0.0
        self.ops: collections.Counter = collections.Counter()
        self.kernels: dict[str, dict] = {}
        self.collectives: dict[str, dict] = {}
        self.collective_axes: dict[str, float] = collections.defaultdict(float)
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}
        # Meta ops are pure functions of their arguments' shapes: each
        # (op, arguments) key's output layouts, bytes and FLOPs, so that
        # a repeated op is not run again through PyTorch's slow meta
        # kernels (a dry run repeats each layer's ops thousands of times).
        self._memo: dict = {}

    def __enter__(self):
        work.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        work.pop(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return func(*args, **kwargs)   # counted by `add_collective`
        fresh = _fresh(func)
        key = _meta_key((func, args, kwargs)) if fresh else None
        hit = self._memo.get(key) if key is not None else None
        if hit is not None:
            layouts, nbytes, flops = hit
            out = [torch.empty_strided(s, st, dtype=dt, device="meta")
                   for s, st, dt in layouts]
            out = out[0] if len(out) == 1 else tuple(out)
        else:
            out = func(*args, **kwargs)
            nbytes = _op_bytes(func, args, kwargs, out)
            formula = flop_registry.get(func._overloadpacket)
            flops = (_dtype_class(args[0].dtype),
                     formula(*args, **kwargs, out_val=out)) if formula else None
            outs = out if isinstance(out, (list, tuple)) else (out,)
            if key is not None and outs and all(
                    _plain(t) and t.device.type == "meta" for t in outs):
                self._memo[key] = ([(t.shape, t.stride(), t.dtype) for t in outs],
                                   nbytes, flops)
        self.ops[str(func)] += 1
        self.bytes += nbytes
        if flops is not None:
            self.flops[flops[0]] += flops[1]
        if fresh:
            for t in _tensors(out, []):
                if _plain(t):
                    self._track(t)
        return out

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = id(storage)
        if key in self._live:
            return
        n = storage.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(storage, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def add_kernel(self, name: str, nbytes: float, flops: dict[str, float]) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0.0, "flops": 0.0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += sum(flops.values())
        self.bytes += nbytes
        for cls, f in flops.items():
            self.flops[cls] += f

    def add_collective(self, op: str, axis: str, nbytes: float) -> None:
        c = self.collectives.setdefault(op, {"bytes": 0.0, "count": 0})
        c["bytes"] += nbytes
        c["count"] += 1
        self.collective_axes[axis] += nbytes

    @property
    def collective_bytes(self) -> float:
        return sum(c["bytes"] for c in self.collectives.values())

    def summary(self) -> dict[str, Any]:
        """The counts as plain JSON-safe values."""
        return {"flops": dict(self.flops), "bytes": self.bytes,
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "collectives": {k: dict(v) for k, v in self.collectives.items()},
                "collective_axes": dict(self.collective_axes),
                "peak_bytes": self.peak_bytes}


def link_bw(mesh, axis: str) -> float:
    """Bytes/s per GPU on `axis`'s group, ranks numbered in mesh order (the
    last axis fastest) and `GPUS_PER_NODE` to a node: NVLink when the
    group lies in one node, else the NIC."""
    names, shape = tuple(mesh.mesh_dim_names), tuple(mesh.shape)
    i = names.index(axis)
    stride = math.prod(shape[i + 1:])
    span = (shape[i] - 1) * stride + 1
    return NVLINK_BW if span <= GPUS_PER_NODE else ICI_BW


def bound_s(nbytes: float, flops: dict[str, float]) -> tuple[float, str]:
    """Least seconds for the work on one card: its bytes at the HBM rate or
    its FLOPs at each class's rate, whichever is larger, and which."""
    t_bytes = nbytes / HBM_BW
    t_ops = sum(f / RATES[c] for c, f in flops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: dict                 # whole-job FLOPs by dtype class (per device x chips)
    hbm_bytes: float            # whole-job HBM bytes
    collective_bytes: float     # per-device collective result bytes
    model_flops: float
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    bottleneck: str = ""
    useful_ratio: float = 0.0
    per_device_bytes: float = 0.0
    link_bw: dict = dataclasses.field(default_factory=dict)   # axis -> bytes/s
    collective_detail: dict = dataclasses.field(default_factory=dict)
    memory_analysis: dict = dataclasses.field(default_factory=dict)

    def finalize(self) -> "RooflineTerms":
        self.compute_s = sum(f / (self.chips * RATES[c]) for c, f in self.flops.items())
        self.memory_s = self.hbm_bytes / (self.chips * HBM_BW)
        # Per-device bytes: each device drives its own links, each axis
        # at its link's rate; without a per-axis split, the NIC's.
        by_axis = self.collective_detail.get("bytes_by_axis")
        if by_axis:
            self.collective_s = sum(b / self.link_bw.get(a, ICI_BW)
                                    for a, b in by_axis.items())
        else:
            self.collective_s = self.collective_bytes / ICI_BW
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.bottleneck = max(terms, key=terms.get)
        total = sum(self.flops.values())
        self.useful_ratio = self.model_flops / total if total else 0.0
        return self

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops(cfg, spec, tokens: int) -> float:
    """6*N_active*D for training, 2*N_active*D for inference steps."""
    n_active = cfg.active_param_count()
    mult = 6.0 if spec.kind == "train" else 2.0
    return mult * n_active * tokens


def summarize_memory_analysis(mem: Any) -> dict[str, float]:
    """The reference's memory keys of `mem` (a mapping, or an object with
    those attributes) as floats; the others are dropped."""
    if mem is None:
        return {}
    keys = (
        "argument_size_in_bytes",
        "output_size_in_bytes",
        "temp_size_in_bytes",
        "alias_size_in_bytes",
        "generated_code_size_in_bytes",
        "peak_memory_in_bytes",
    )
    out = {}
    for k in keys:
        v = mem.get(k) if isinstance(mem, dict) else getattr(mem, k, None)
        if v is not None:
            try:
                out[k] = float(v)
            except (TypeError, ValueError):
                pass
    return out


def save_results(path: str, rows: list[dict]) -> None:
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
