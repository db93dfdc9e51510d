"""Lifetime serving simulation: age, verify, scrub, re-materialize.

`LifetimeSimulator` owns the analog side of a deployment (the
`DeployedModel` array state plus one aging `CellState` per RRAM leaf)
and steps wall-clock epochs interleaved with serving traffic:

    for each epoch:
        1. age every array by `dt_s` under the epoch's read traffic;
        2. run the refresh policy (verify sweeps / re-programming) on the
           scrub window of leaves;
        3. push the new conductances into the `DeployedModel` (a
           `CIMExecutor` re-tiles them on its next access) and, when a
           column was re-programmed, hand materialized params to the
           `on_refresh` hook;
        4. fetch the epoch's health (drift RMS, stuck share, per-tile
           drift map, drift digest) in ONE device->host copy and return
           an `EpochRecord`.

The report carries both sides of the trade: accuracy retained (eval
metric, weight-domain RMS drift) and what retention cost (modeled verify
and re-program energy, write pulses, latency).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import rng
from repro_torch.core.programmer import DeployedModel

from .drift import DriftConfig, advance, init_cell_state
from .refresh import RefreshConfig, apply_refresh

__all__ = ["EpochRecord", "LifetimeReport", "LifetimeSimulator"]


@dataclasses.dataclass
class EpochRecord:
    """One epoch of the lifetime time series (aggregated over leaves)."""

    epoch: int
    t_s: float                       # wall-clock age at end of epoch
    reads_per_column: float          # traffic applied this epoch
    rms_drift_lsb: float             # cell-domain RMS |g - target|
    stuck_frac: float                # fraction of cells stuck
    columns_flagged: int             # VT verify flags this epoch
    columns_reprogrammed: int
    verify_energy_pj: float
    program_energy_pj: float
    maintenance_latency_ns: float
    write_pulses: float
    eval_metric: float | None = None
    gave_up_cells: float = 0.0       # refresh give-ups
    retry_pulses: float = 0.0        # pulses burned on gave-up cells
    refresh_debt_epochs: float = 0.0  # max epochs since any leaf scrubbed


@dataclasses.dataclass
class LifetimeReport:
    """Accuracy-vs-time trajectory with per-epoch maintenance costs."""

    policy: str
    method: str
    records: list[EpochRecord] = dataclasses.field(default_factory=list)

    @property
    def total_maintenance_energy_pj(self) -> float:
        return sum(r.verify_energy_pj + r.program_energy_pj for r in self.records)

    @property
    def total_verify_energy_pj(self) -> float:
        return sum(r.verify_energy_pj for r in self.records)

    @property
    def final_rms_drift_lsb(self) -> float:
        return self.records[-1].rms_drift_lsb if self.records else 0.0

    def to_dict(self) -> dict:
        return {
            "policy": self.policy,
            "method": self.method,
            "total_maintenance_energy_pj": self.total_maintenance_energy_pj,
            "records": [dataclasses.asdict(r) for r in self.records],
        }

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)


class LifetimeSimulator:
    """Owns deployed array state and drives it through aging epochs.

    Args:
      key: key (per-leaf aging randomness derives from it).
      deployed: `deploy_arrays` output; the simulator takes ownership of
        its conductances.
      drift_cfg / refresh_cfg: dynamics and scrub policy.
      on_refresh: hook called with freshly materialized params after an
        epoch that re-programmed a column (e.g. ``engine.swap_params``).
        Analog serving (`CIMExecutor`) needs none: it re-views the live
        arrays.
      traffic_fn: source of REAL per-array read counts for the epoch,
        e.g. ``CIMExecutor.drain_reads``; each leaf's reads are
        ``traffic_fn()[name]`` plus the `reads_per_column` scalar.
      columns_per_tile: tile geometry of the per-tile drift map.
    """

    def __init__(
        self,
        key: torch.Tensor,
        deployed: DeployedModel,
        drift_cfg: DriftConfig | None = None,
        refresh_cfg: RefreshConfig | None = None,
        on_refresh: Callable[[Any], None] | None = None,
        traffic_fn: Callable[[], dict[str, float]] | None = None,
        columns_per_tile: int = 128,
    ):
        dev = next(iter(deployed.arrays.values())).g.device
        self.key = key.to(dev)
        self.deployed = deployed
        self.drift_cfg = drift_cfg or DriftConfig()
        self.refresh_cfg = refresh_cfg or RefreshConfig()
        self.on_refresh = on_refresh
        self.traffic_fn = traffic_fn
        self.columns_per_tile = int(columns_per_tile)
        self.t_s = 0.0
        self.epoch = 0
        self._scrub_cursor = 0
        # Refresh debt: epochs since each leaf last sat in the scrub
        # window (0 = scrubbed by the deploy itself).
        self._last_scrub = {name: 0 for name in deployed.arrays}
        k = self.key
        self.states = {}
        for name, arr in deployed.arrays.items():
            k, sub = rng.split(k)
            self.states[name] = init_cell_state(
                sub, arr.g, arr.d2d, deployed.wv_cfg.device, self.drift_cfg)

    def _sync_deployed(self) -> None:
        for name, st in self.states.items():
            self.deployed.update_array(name, st.g)

    # Drift-digest bucket geometry (static, so every epoch and replica
    # folds into one histogram): per-column RMS drift in cell LSB.
    _DRIFT_DIGEST = ("lifetime.drift_lsb", 0.0, 8.0, 64)

    def _epoch_health(self) -> tuple[float, float]:
        """Global drift RMS and stuck fraction, with the health maps.

        All reductions run on the device; ONE `metrics.fetch` moves the
        scalars, the per-tile sums and the drift digest together.  Tiles
        come from the deploy's physical column uids (`ArrayState.uids`).
        A remapped-away or unused spare row counts neither as drift nor in
        its tile: a parked stuck column is not drift the model sees.
        """
        col_e2, col_cnt, col_uids = [], [], []
        stuck_bad = None
        stuck_tot = 0
        have_uids = all(a.uids is not None for a in self.deployed.arrays.values())
        for name in sorted(self.states):
            st = self.states[name]
            arr = self.deployed.arrays[name]
            err = st.g - arr.targets.to(torch.float32)
            if arr.remap is not None:
                act = arr.remap.active.to(torch.float32)
                col_e2.append(torch.sum(err * err, dim=1) * act)
                col_cnt.append(act * err.shape[1])
            else:
                col_e2.append(torch.sum(err * err, dim=1))
                col_cnt.append(torch.full((err.shape[0],), float(err.shape[1]),
                                          dtype=torch.float32, device=err.device))
            if have_uids:
                col_uids.append(np.asarray(arr.uids, np.int64))
            s = torch.sum(st.stuck).to(torch.float32)
            stuck_bad = s if stuck_bad is None else stuck_bad + s
            stuck_tot += int(st.stuck.numel())
        e2 = torch.cat(col_e2)
        cnt = torch.cat(col_cnt)
        col_rms = torch.sqrt(e2 / torch.clamp_min(cnt, 1.0))
        dig_name, lo, hi, nb = self._DRIFT_DIGEST
        dig = obs.StreamingDigest.zeros(lo, hi, nb, device=e2.device).add_weighted(
            col_rms, (cnt > 0).to(torch.float32))
        tree: dict[str, Any] = {
            "num": torch.sum(e2), "den": torch.sum(cnt), "stuck": stuck_bad,
            "digest": dig.as_tree(),
        }
        tile_ids = None
        if have_uids and col_uids:
            uids = np.concatenate(col_uids)
            tile_ids, inv = np.unique(uids // self.columns_per_tile,
                                      return_inverse=True)
            n_tiles = int(tile_ids.shape[0])
            tree["tile_e2"] = obs.health.tile_reduce(e2, inv, n_tiles)
            tree["tile_cnt"] = obs.health.tile_reduce(cnt, inv, n_tiles)
        # THE per-epoch health sync.
        h = obs.metrics.fetch(tree, counter="lifetime.health_syncs")
        rms = (float(h["num"]) / max(float(h["den"]), 1.0)) ** 0.5
        stuck = float(h["stuck"]) / max(stuck_tot, 1)
        obs.digests.put(dig_name, obs.StreamingDigest.from_tree(lo, hi, h["digest"]))
        if tile_ids is not None:
            tile_rms = np.sqrt(np.asarray(h["tile_e2"])
                               / np.maximum(np.asarray(h["tile_cnt"]), 1.0))
            obs.health_registry.fold_tiles("lifetime.drift_rms_lsb", tile_ids,
                                           tile_rms, mode="last")
        return rms, stuck

    def step_epoch(
        self,
        dt_s: float,
        reads_per_column: float = 0.0,
        eval_fn: Callable[[Any], float] | None = None,
        max_leaves: int | None = None,
    ) -> EpochRecord:
        """Age by `dt_s`, refresh, re-materialize, evaluate.

        `max_leaves` bounds the scrub to a rotating window of at most that
        many leaves per epoch (aging always applies to every leaf): the
        incremental maintenance a continuous-batching scheduler
        interleaves between decode steps.  The cursor visits every leaf
        every ceil(n_leaves / max_leaves) epochs, and each leaf's streams
        depend only on (key, epoch, leaf index).
        """
        wv_cfg, cost = self.deployed.wv_cfg, self.deployed.cost
        flagged = reprogrammed = 0
        en_v = en_p = lat = pulses = gave_up = retry = 0.0
        traffic = self.traffic_fn() if self.traffic_fn is not None else {}
        applied_reads = []
        names = sorted(self.states)
        if max_leaves is not None and max_leaves <= 0:
            chosen = set()  # a zero budget scrubs nothing (aging still runs)
        elif max_leaves is not None and max_leaves < len(names):
            start = self._scrub_cursor % len(names)
            chosen = {names[(start + j) % len(names)] for j in range(max_leaves)}
            self._scrub_cursor = (start + max_leaves) % len(names)
        else:
            chosen = set(names)
        with obs.span("lifetime.scrub", cat="lifetime", epoch=self.epoch,
                      scrubbed_leaves=len(chosen)) as sp:
            for li, name in enumerate(names):
                st = self.states[name]
                k_adv, k_ref = rng.split(
                    rng.fold_in(rng.fold_in(self.key, self.epoch), li))
                leaf_reads = float(reads_per_column) + float(traffic.get(name, 0.0))
                applied_reads.append(leaf_reads)
                st = advance(k_adv, st, dt_s, leaf_reads, wv_cfg.device,
                             self.drift_cfg)
                if name in chosen:
                    arr = self.deployed.arrays[name]
                    st, out = apply_refresh(
                        k_ref, st, arr.targets, wv_cfg, cost, self.drift_cfg,
                        self.refresh_cfg, self.epoch,
                        active=None if arr.remap is None else arr.remap.active,
                        fault=arr.fault)
                    if out.flagged is not None:
                        flagged += int(out.flagged.sum())
                    reprogrammed += out.n_reprogrammed
                    en_v += out.verify_energy_pj
                    en_p += out.program_energy_pj
                    lat = max(lat, out.maintenance_latency_ns)  # in parallel
                    pulses += out.write_pulses
                    gave_up += out.gave_up_cells
                    retry += out.retry_pulses
                    self._last_scrub[name] = self.epoch
                self.states[name] = st
            sp["flagged"] = flagged
            sp["reprogrammed"] = reprogrammed
        obs.registry.inc("lifetime.scrub_epochs")
        obs.registry.inc("lifetime.reprogrammed_columns", reprogrammed)
        obs.registry.inc("lifetime.gave_up_cells", gave_up)
        obs.registry.inc("lifetime.retry_pulses", retry)
        obs.charge("lifetime.scrub", energy_pj=en_v + en_p, latency_ns=lat,
                   epoch=self.epoch, reprogrammed=reprogrammed)

        self.t_s += dt_s
        self.epoch += 1
        self._sync_deployed()
        # Refresh debt (scrub backlog): epochs since each leaf was last
        # in the scrub window.
        debt = max((self.epoch - 1 - e for e in self._last_scrub.values()),
                   default=0.0)
        obs.health_registry.set_gauge("lifetime.refresh_debt_epochs", debt)
        params = None
        if reprogrammed and self.on_refresh is not None:
            params = self.deployed.materialize()
            self.on_refresh(params)
        metric = None
        if eval_fn is not None:
            if params is None:
                params = self.deployed.materialize()
            metric = float(eval_fn(params))
        rms_drift, stuck = self._epoch_health()
        return EpochRecord(
            epoch=self.epoch - 1,
            t_s=self.t_s,
            reads_per_column=(sum(applied_reads) / len(applied_reads)
                              if applied_reads else float(reads_per_column)),
            rms_drift_lsb=rms_drift,
            stuck_frac=stuck,
            columns_flagged=flagged,
            columns_reprogrammed=reprogrammed,
            verify_energy_pj=en_v,
            program_energy_pj=en_p,
            maintenance_latency_ns=lat,
            write_pulses=pulses,
            eval_metric=metric,
            gave_up_cells=gave_up,
            retry_pulses=retry,
            refresh_debt_epochs=float(debt),
        )

    def run(
        self,
        epochs: int,
        dt_s: float,
        reads_per_column: float = 0.0,
        eval_fn: Callable[[Any], float] | None = None,
        max_leaves: int | None = None,
    ) -> LifetimeReport:
        """Step `epochs` fixed-size epochs; returns the full time series."""
        report = LifetimeReport(policy=self.refresh_cfg.policy.value,
                                method=self.deployed.wv_cfg.method.value)
        for _ in range(epochs):
            report.records.append(
                self.step_epoch(dt_s, reads_per_column, eval_fn, max_leaves))
        return report
