"""The model a cell runs: the port's `ModelConfig` at the sizes of the
cell's configuration file, and seeded weights made on the device.

The tree's structure (leaf names, shapes, dtypes) is the one the port
asks for, read on the meta device, where nothing is drawn.  Its values
are the benchmark's: one normal draw from a `torch.Generator` seeded
with `--seed` on the run's device, cut into leaves in name order and
scaled (embeddings 0.02, matrices 1/sqrt(fan_in), other leaves 0.1).
"""

from __future__ import annotations

import math

import torch

# Keys of a configuration file that are `ModelConfig` fields.
MODEL_KEYS = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
              "vocab_size", "block", "qk_norm", "rope_theta", "sliding_window",
              "global_layer_every", "ssm_state", "tie_embeddings", "norm_eps")


def model_config(conf: dict):
    """The port's configuration of `conf["arch"]` with every size the
    file states."""
    from repro_torch.configs import get_config

    fields = {k: conf[k] for k in MODEL_KEYS if k in conf}
    return get_config(conf["arch"]).replace(dtype=getattr(torch, conf["dtype"]), **fields)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _leaves(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def _std(path: tuple, leaf: torch.Tensor) -> float:
    if "embed" in path[-1]:
        return 0.02
    if leaf.ndim >= 2 and leaf.dtype != torch.float32:
        return 1.0 / math.sqrt(leaf.shape[-2])
    return 0.1


def make_params(cfg, seed: int, device) -> dict:
    """Seeded weights in the port's tree layout, made on `device`."""
    from repro_torch.models import init_params

    leaves = _leaves(init_params(0, cfg, device="meta"))
    total = sum(t.numel() for _, t in leaves)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    tree: dict = {}
    off = 0
    for path, meta in leaves:
        n = meta.numel()
        leaf = (flat[off:off + n].view(meta.shape) * _std(path, meta)).to(meta.dtype)
        off += n
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree
