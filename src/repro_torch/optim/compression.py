"""Int8 gradient compression with error feedback for the cross-pod all-reduce.

On a multi-pod mesh the "pod" axis crosses the slower links between pods,
while "data" / "model" stay inside one.  The reference's trick (the 1-bit
Adam / PowerSGD lineage): reduce in full precision inside the pod and
compress only the cross-pod hop, int8 with error feedback:

    q = quantize_int8(g + e);   e' = (g + e) - dequant(q)
    g_synced = sum_over_pods(dequant(q)) / pods

The residual e is re-injected next round, so the quantisation bias
vanishes over steps.  Quantisation is scaled per leading row.

`compressed_psum` takes this rank's gradients (plain tensors, as the
reference's `shard_map` body sees them) and reduces them over one mesh
axis.  Every pod quantises against the same per-row scale, the largest
|g + e| of any pod: its all-reduce MAX runs on the float32 bit patterns
as int32 (the order of non-negative floats is that of their bits), so
that both collectives on the axis move integers, the int8 codes summed
as int32.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

from repro_torch import pytree
from repro_torch.launch.mesh import axis_sizes

__all__ = ["CompressionState", "init_compression_state", "compress_int8",
           "decompress_int8", "compressed_psum"]


class CompressionState(NamedTuple):
    error: Any  # tree of residuals, shaped as the grads


def init_compression_state(grads: Any) -> CompressionState:
    return CompressionState(error=pytree.tree_map(torch.zeros_like, grads))


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1) if x.ndim > 1 else x.reshape(1, -1)


def _quantize(flat: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Row-block scaled int8 quantisation: returns (q, scale)."""
    flat = _rows(x)
    scale = torch.amax(torch.abs(flat), dim=-1, keepdim=True) / 127.0 + 1e-12
    return _quantize(flat, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def _compress_leaf(g: torch.Tensor, e: torch.Tensor):
    """One error-feedback round for a leaf; returns (q, scale, e')."""
    corrected = g.to(torch.float32) + e
    q, scale = compress_int8(corrected)
    return q, scale, corrected - decompress_int8(q, scale, g.shape)


def compressed_psum(grads: Any, state: CompressionState, mesh,
                    axis_name: str = "pod") -> tuple[Any, CompressionState]:
    """Mean of every rank's grads over the mesh axis `axis_name`, sent as
    int8 codes with error feedback; returns (synced grads, new state)."""
    group = mesh.get_group(axis_name)
    size = axis_sizes(mesh)[axis_name]

    def leaf(g, e):
        corrected = g.to(torch.float32) + e
        flat = _rows(corrected)
        # All pods quantise against the SAME scale: codes of per-pod
        # scales summed would bias the mean.
        shared = torch.amax(torch.abs(flat), dim=-1, keepdim=True).contiguous()
        bits = shared.view(torch.int32)
        dist.all_reduce(bits, op=dist.ReduceOp.MAX, group=group)
        scale = shared / 127.0 + 1e-12
        q = _quantize(flat, scale)
        e_new = corrected - (q.to(torch.float32) * scale).reshape(g.shape)
        q_sum = q.to(torch.int32)
        dist.all_reduce(q_sum, op=dist.ReduceOp.SUM, group=group)
        deq = (q_sum.to(torch.float32) * scale / size).reshape(g.shape)
        return deq.to(g.dtype), e_new

    out = [leaf(g, e) for g, e in zip(pytree.leaves(grads), pytree.leaves(state.error))]
    return (pytree.unflatten(grads, [o[0] for o in out]),
            CompressionState(error=pytree.unflatten(state.error, [o[1] for o in out])))
