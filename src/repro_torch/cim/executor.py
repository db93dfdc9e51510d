"""CIMExecutor: serve a `DeployedModel` straight off its live arrays.

Instead of collapsing programmed conductances to dense digital weights,
the executor re-views every matmul-consumed RRAM leaf as crossbar macro
tiles (`tile.build_weight`) and hands the serving engine a parameter
tree whose deployed leaves are `CIMWeight`s; `models.layers.matmul`
sends those through the noisy analog forward (`mvm.cim_matmul`).  Every
other leaf (norm scales, embeddings) is served digitally through
`materialize()`.

The `DeployedModel` owns the conductances; the executor only views
them.  When an array's `g` is swapped (`DeployedModel.update_array`),
the next `params()` re-tiles it, so served logits read the live state.

Accounting: every served token drives `planes_per_token` read phases
through every analog macro, i.e. reads each physical verify column
`planes` times.  The executor counts per-array reads (`drain_reads`)
and prices a token with the cost model's inference phase
(`core.cost.inference_token_cost`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core import rng
from repro_torch.core.cost import inference_token_cost
from repro_torch.core.programmer import DeployedModel, fill_names
from repro_torch import obs

from .mvm import CIMConfig, planes_per_token
from .tile import CIMWeight, broadcast_key, build_weight

__all__ = ["CIMExecutor", "analog_eligible"]

# Leaves consumed by `models.layers.matmul` once a layer is sliced out of
# the stack.  Every other deployed leaf (MoE expert stacks and routers,
# RWKV6 projections, the SSM branch, cross-attention projections,
# multi-codebook heads) is served digitally through materialize().
_LAYER_MATMUL_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def analog_eligible(name: str, state) -> bool:
    """Default policy: which deployed leaves run through analog tiles.

    * stacked transformer projections ``['layers']['wq']`` etc., 3-D
      (L, d, M) leaves sliced per layer by the forward;
    * the 2-D LM head (untied embeddings).
    """
    if name == "['lm_head']":
        return len(state.shape) == 2
    return (len(state.shape) == 3
            and any(name == f"['layers']['{k}']" for k in _LAYER_MATMUL_KEYS))


class CIMExecutor:
    """Builds and maintains the analog parameter tree for serving.

    Args:
      deployed: `deploy_arrays` output (owns the live conductances).
      cfg: analog inference configuration.
      key: master read-noise key; every engine access folds a fresh
        sub-stream ``fold_in(key, access)`` into the leaves' key field;
        each leaf's uid and each stacked layer's index fold in at matmul
        time from `CIMWeight.uid` / `layer_id`.  Default: key 0 on the
        device of the deployed arrays.
      predicate: overrides `analog_eligible`.
      mesh: optional `DeviceMesh`; tile planes and scales split their
        output channels over "model" (`launch.shardings.
        cim_weight_specs`), every built or re-viewed tile included, so
        each rank reads its own columns of every leaf.
    """

    def __init__(
        self,
        deployed: DeployedModel,
        cfg: CIMConfig | None = None,
        key: torch.Tensor | None = None,
        predicate: Callable[[str, Any], bool] | None = None,
        mesh: Any = None,
    ):
        self.deployed = deployed
        self.cfg = cfg or CIMConfig()
        if key is None:
            dev = next(iter(deployed.arrays.values())).g.device
            key = rng.PRNGKey(0, device=dev)
        self.key = key
        self.mesh = mesh
        self.access = 0
        self.tokens_served = 0
        predicate = predicate or analog_eligible
        self._analog: dict[str, CIMWeight] = {}
        self._digital: dict[str, torch.Tensor] = {}
        self._g_seen: dict[str, torch.Tensor] = {}
        self._uids = {name: i for i, name in enumerate(sorted(deployed.arrays))}
        self._token_cost: tuple[float, float] | None = None
        self._reads: dict[str, float] = {}
        for name, state in deployed.arrays.items():
            if predicate(name, state):
                self._analog[name] = self._tile(name, state)
                self._reads[name] = 0.0
            else:
                self._digital[name] = state.materialize()
            self._g_seen[name] = state.g

    # ----------------------------------------------------------- tiling
    def _access_key(self) -> torch.Tensor:
        """``fold_in(master, access)``: one fold shared by every leaf."""
        return rng.fold_in(self.key, self.access)

    def _tile(self, name: str, state) -> CIMWeight:
        w = build_weight(state, self.cfg, self._access_key(), name=name,
                         uid=self._uids[name])
        if self.mesh is not None:
            # launch sits above cim: imported only when a mesh is given.
            from repro_torch.launch.shardings import shard_cim_weight

            w = shard_cim_weight(self.mesh, w)
        return w

    def _refresh_views(self) -> None:
        """Re-view any array whose conductances were swapped."""
        for name, state in self.deployed.arrays.items():
            if state.g is self._g_seen[name]:
                continue
            if name in self._analog:
                self._analog[name] = self._tile(name, state)
            else:
                self._digital[name] = state.materialize()
            self._g_seen[name] = state.g

    # ---------------------------------------------------------- serving
    def params(self) -> Any:
        """Current served tree: `CIMWeight` analog leaves + digital rest.

        The tree is rebuilt from `DeployedModel.names`.  With read noise
        on, every analog leaf gets this access's key (one fold, one
        broadcast per distinct layer-stack size).
        """
        self._refresh_views()
        values: dict[str, Any] = dict(self.deployed.digital)
        values.update(self._digital)
        rekey_live = self.cfg.sigma_read_lsb > 0.0  # keys unread when clean
        if rekey_live:
            ak = self._access_key()
            bcast: dict[int | None, torch.Tensor] = {}
        for name, w in self._analog.items():
            if rekey_live:
                n_layers = w.g_pos.shape[0] if w.g_pos.ndim == 5 else None
                if n_layers not in bcast:
                    bcast[n_layers] = broadcast_key(ak, n_layers)
                w = dataclasses.replace(w, key=bcast[n_layers])
            values[name] = w
        return fill_names(self.deployed.names, values)

    def tick(self, n_tokens: int) -> Any:
        """One engine access: fresh noise sub-streams + read accounting.

        Every token reads every analog array's physical columns `planes`
        times (each DAC plane is one read phase of every macro).  Each
        tick also sets the fleet health gauges (tokens served, cumulative
        read-disturb reads) and charges the modeled per-token cost to the
        ``serve.analog`` ledger phase: host floats only (the cached
        `token_cost`), never a sync.
        """
        self.access += 1
        self.tokens_served += n_tokens
        reads = float(n_tokens * self.planes)
        for name in self._reads:
            self._reads[name] += reads
        obs.registry.inc("cim.tokens", n_tokens)
        obs.registry.inc("cim.accesses")
        obs.health_registry.set_gauge("cim.tokens_served", float(self.tokens_served))
        obs.health_registry.set_gauge(
            "cim.read_disturb_reads",
            float(self.tokens_served * self.planes * len(self._analog)))
        lat_ns, en_pj = self.token_cost()
        obs.charge("serve.analog", tokens=n_tokens, energy_pj=en_pj * n_tokens,
                   latency_ns=lat_ns * n_tokens, reads=reads * len(self._analog))
        return self.params()

    # ------------------------------------------------- traffic / costs
    @property
    def planes(self) -> int:
        return planes_per_token(self.cfg)

    def drain_reads(self) -> dict[str, float]:
        """Per-array column reads since the last drain (lifetime traffic)."""
        out = dict(self._reads)
        self._reads = {name: 0.0 for name in self._reads}
        return out

    def _conversion_counts(self) -> tuple[int, int]:
        """(ADC conversions, DAC row drives) per token per plane."""
        conv = drives = 0
        for w in self._analog.values():
            layers = w.stacked_layers
            conv += layers * w.n_tiles * w.n_slices * w.n_outputs
            drives += layers * w.n_tiles * w.tile_rows
        return conv, drives

    def token_cost(self) -> tuple[float, float]:
        """(latency_ns, energy_pj) per served token, from the cost model
        (cached: the tile geometry is fixed for the executor's life)."""
        if self._token_cost is None:
            conv, drives = self._conversion_counts()
            self._token_cost = inference_token_cost(
                n_conversions=conv, n_row_drives=drives, planes=self.planes,
                adc=self.deployed.wv_cfg.adc, cost=self.deployed.cost,
            )
        return self._token_cost

    def summary(self) -> dict[str, float]:
        lat, en = self.token_cost()
        return dict(
            analog_leaves=len(self._analog),
            digital_fallback_leaves=len(self._digital),
            planes_per_token=self.planes,
            tokens_served=self.tokens_served,
            token_latency_ns=lat,
            token_energy_pj=en,
            total_energy_pj=en * self.tokens_served,
        )
