"""Per-(arch x shape x mesh) sharding assignments (DESIGN.md Sec. 4).

The reference's `launch/shardings.py`, rule for rule: parameters FSDP
over "data" on the input dim and TP over "model" on the output dim; MoE
experts EP over "model" with FSDP over "data" on d_model; embeddings
vocab over "model".  Caches: the sequence axis over "model", batch over
("pod", "data").  A dim whose mesh extent does not divide it is stored
replicated (`_sanitize`), as the reference must for jit arguments,
although a DTensor could hold uneven blocks.

Every function returns `NamedSharding`s (mesh + `PartitionSpec`) whose
specs are the reference's; the mesh may be a `DeviceMesh` or an
`AbstractMesh`.  Paths are the reference's `keystr` paths
(`pytree.leaves_with_path`), ``.params`` / ``.opt.m`` included.
"""

from __future__ import annotations

from typing import Any

from repro_torch import pytree
from repro_torch.distributed.sharding import (
    NamedSharding,
    P,
    PartitionSpec,
    ShardingRules,
    shard_tree,
)
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import ModelConfig
from repro_torch.models.act_sharding import batch_axes_for

__all__ = ["param_rules", "batch_axes", "batch_sharding", "shard_batch",
           "cache_sharding", "decode_batch_sharding", "decode_vec_sharding",
           "cim_weight_specs", "shard_cim_weight", "state_sharding"]


def param_rules(cfg: ModelConfig) -> ShardingRules:
    rules = [
        # --- MoE expert stacks: (L, E, din, dout) ---
        (r"moe.*w_gate|moe.*w_up", P(None, "model", "data", None)),
        (r"moe.*w_down", P(None, "model", None, "data")),
        (r"moe.*router", P(None, None, None)),
        # --- embeddings / heads ---
        (r"tok_embed", P("model", "data")),
        (r"lm_head", P(None, "data", "model") if cfg.n_codebooks > 1
         else P("data", "model")),
        # --- rwkv6 ---
        (r"cm_v", P(None, "model", "data")),
        (r"cm_k|cm_r", P(None, "data", "model")),
        (r"w_r\b|w_k\b|w_v\b|w_g\b", P(None, "data", "model")),
        (r"w_o\b", P(None, "model", "data")),
        (r"decay_a|decay_b|decay_base|mix_|bonus_u|ln_x", P()),
        # --- ssm ---
        (r"ssm.*in_x|ssm.*in_z|ssm.*w_dt", P(None, "data", "model")),
        (r"ssm.*w_bc", P(None, "data", None)),
        (r"ssm.*a_log|ssm.*d_skip|ssm.*dt_bias", P()),
        (r"ssm.*out", P(None, "model", "data")),
        # --- attention / dense mlp stacks: (L, din, dout) ---
        (r"wq|wk\b|wv\b|w_gate|w_up", P(None, "data", "model")),
        (r"wo\b|w_down", P(None, "model", "data")),
        # norms, gates, scalars: replicated
    ]
    return ShardingRules(rules=rules, default=P())


def _sanitize(mesh, spec: PartitionSpec, shape) -> PartitionSpec:
    """Drop any axis assignment whose mesh extent does not divide the dim
    (vocab 32001, 1601 image patches): that dim is stored replicated."""
    sizes = axis_sizes(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None if i >= len(shape) else entry)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        extent = 1
        for a in axes:
            extent *= sizes.get(a, 1)
        out.append(entry if shape[i] % extent == 0 else None)
    return P(*out[: len(shape)])


def batch_axes(mesh, global_batch: int):
    """Largest prefix of ("pod", "data") that divides the batch."""
    return batch_axes_for(mesh, global_batch)


def batch_sharding(mesh, tree: Any, global_batch: int) -> Any:
    ba = batch_axes(mesh, global_batch)

    def spec(x):
        nd = len(x.shape)
        if nd == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(ba, *([None] * (nd - 1))))

    return pytree.tree_map(spec, tree)


def shard_batch(mesh, batch: dict, global_batch: int) -> dict:
    """The batch as DTensors laid out by `batch_sharding` (each rank
    keeps its rows of the full batch it holds)."""
    return shard_tree(batch, batch_sharding(mesh, batch, global_batch))


def cache_sharding(mesh, cache_tree: Any, cfg: ModelConfig, global_batch: int) -> Any:
    """KV caches (L, B, S, KV, hd): seq over "model", batch over the data
    axes.  RWKV / SSM states shard their widest feature dim over "model"."""
    ba = batch_axes(mesh, global_batch)
    out = []
    for name, leaf in pytree.leaves_with_path(cache_tree):
        nd = len(leaf.shape)
        if "pos" in name:
            spec = P()
        elif "wkv" in name:           # (L, B, H, hd, hd)
            spec = P(None, ba, "model", None, None)
        elif "shift" in name:         # (L, B, D)
            spec = P(None, ba, "model")
        elif "ssm_h" in name:         # (L, B, d, n)
            spec = P(None, ba, "model", None)
        elif nd == 5:                  # (L, B, S, KV, hd)
            spec = P(None, ba, "model", None, None)
        else:
            spec = P(*([None] * nd))
        out.append(NamedSharding(mesh, _sanitize(mesh, spec, leaf.shape)))
    return pytree.unflatten(cache_tree, out)


def decode_batch_sharding(mesh, cache_tree: Any) -> Any:
    """Continuous-batching decode cache: only the batch axis shards, over
    "data" (DESIGN.md Sec. 18), so that every per-slot reduction stays on
    one device and tokens stay bitwise those of the unsharded run.
    Extent-1 axes are dropped (`_drop_trivial`), as the reference drops
    them to match jit's output shardings."""
    out = []
    for name, leaf in pytree.leaves_with_path(cache_tree):
        nd = len(leaf.shape)
        if "pos" in name:              # (B,)
            spec = P("data")
        elif nd >= 2:                  # stacked (L, B, ...) layouts
            spec = P(None, "data", *([None] * (nd - 2)))
        else:
            spec = P(*([None] * nd))
        spec = _drop_trivial(mesh, _sanitize(mesh, spec, leaf.shape))
        out.append(NamedSharding(mesh, spec))
    return pytree.unflatten(cache_tree, out)


def decode_vec_sharding(mesh, n_slots: int) -> NamedSharding:
    """The scheduler's per-slot (B,) vectors: batch over "data"."""
    return NamedSharding(mesh, _drop_trivial(mesh, _sanitize(mesh, P("data"),
                                                             (n_slots,))))


def _drop_trivial(mesh, spec: PartitionSpec) -> PartitionSpec:
    """Remove mesh axes of extent 1 from a spec."""
    sizes = axis_sizes(mesh)
    out = []
    for entry in spec:
        if entry is None:
            out.append(None)
            continue
        axes = tuple(a for a in (entry if isinstance(entry, tuple) else (entry,))
                     if sizes.get(a, 1) > 1)
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return P(*out)


def cim_weight_specs(mesh, w: Any) -> dict[str, NamedSharding]:
    """Sharding for one `cim.CIMWeight`'s children (analog serving TP):
    the tile planes ([L,] T, S, R, M) and the scale ([L,] M) shard their
    output channels M over "model"; the noise key and `layer_id` are
    replicated."""
    def out_spec(arr):
        spec = P(*([None] * (arr.ndim - 1)), "model")
        return NamedSharding(mesh, _sanitize(mesh, spec, arr.shape))

    specs = {
        "g_pos": out_spec(w.g_pos),
        "g_neg": out_spec(w.g_neg),
        "scale": out_spec(w.scale),
        "key": NamedSharding(mesh, P()),
    }
    if w.layer_id is not None:
        specs["layer_id"] = NamedSharding(mesh, P())
    return specs


def shard_cim_weight(mesh, w: Any) -> Any:
    raise NotImplementedError(
        "shard_cim_weight: serving a deployment on a mesh is the serving half of "
        "ROADMAP.md A5, not ported yet")


def state_sharding(mesh, state_tree: Any, cfg: ModelConfig) -> Any:
    """TrainState sharding: params and AdamW's m / v share the param
    rules; 0-d leaves (the step) are replicated."""
    rules = param_rules(cfg)
    out = []
    for name, leaf in pytree.leaves_with_path(state_tree):
        if leaf.ndim == 0:
            out.append(NamedSharding(mesh, P()))
            continue
        spec = rules.spec(name)
        spec = P(*spec[: leaf.ndim]) if len(spec) > leaf.ndim else spec
        out.append(NamedSharding(mesh, _sanitize(mesh, spec, leaf.shape)))
    return pytree.unflatten(state_tree, out)
