"""Fault injection and the checkpoint / restart runner.

`FaultTolerantRunner` wraps a training step with the recovery protocol a
multi-pod job needs (the reference's runner):

  * periodic async checkpoints (`CheckpointManager`);
  * on a failure (an injected `SimulatedFailure`): restore the latest
    checkpoint, rebuild the step from the restored step (the stateless
    data pipeline makes this exact), and continue;
  * bounded retries per step, so that a step that always fails ends the
    run instead of looping;
  * a final blocking save.

A sharded state (DTensor leaves) is restored onto its own layout: the
runner passes the state's sharding to the restore, where the reference
leaves that to `jit`'s `in_shardings`.  The runner works for any
``(state, batch) -> (state, metrics)`` step that returns a new state.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import TYPE_CHECKING, Any, Callable

from repro_torch import obs
from repro_torch.distributed.sharding import sharding_of

if TYPE_CHECKING:
    from repro_torch.checkpoint import CheckpointManager

__all__ = ["SimulatedFailure", "FaultInjector", "FaultTolerantRunner"]

log = logging.getLogger(__name__)


class SimulatedFailure(RuntimeError):
    """Injected node / process failure."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministically fail at given steps (each fires once); every
    injection lands a ``fault.injected`` instant in the obs trace."""

    fail_at_steps: tuple[int, ...] = ()
    _fired: set[int] = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            obs.instant("fault.injected", cat="fault", step=step)
            raise SimulatedFailure(f"injected failure at step {step}")

    def reset(self) -> None:
        """Re-arm every planned failure (for runner reuse across runs)."""
        self._fired.clear()


@dataclasses.dataclass
class FaultTolerantRunner:
    step_fn: Callable[[Any, Any], tuple[Any, dict]]
    batch_fn: Callable[[int], Any]          # step -> batch (stateless pipeline)
    manager: CheckpointManager
    checkpoint_every: int = 50
    max_retries_per_step: int = 3
    injector: FaultInjector | None = None

    restarts: int = 0

    def run(self, state: Any, start_step: int, num_steps: int) -> tuple[Any, list]:
        """Run to start_step + num_steps with recovery; returns (state, metrics)."""
        metrics_log: list = []
        step = start_step
        end = start_step + num_steps
        # Recovery before the first checkpoint needs the true initial
        # state (the step returns new states, so holding it is free).
        initial_state = state
        # Retries are counted per step: a rolling counter would reset
        # while replaying checkpointed steps and loop forever.
        fail_counts: dict[int, int] = {}
        while step < end:
            try:
                if self.injector is not None:
                    self.injector.maybe_fail(step)
                state, metrics = self.step_fn(state, self.batch_fn(step))
                metrics_log.append({"step": step, **metrics})
                step += 1
                if step % self.checkpoint_every == 0:
                    self.manager.save(step, state, blocking=False)
            except SimulatedFailure as e:
                self.restarts += 1
                fail_counts[step] = fail_counts.get(step, 0) + 1
                if fail_counts[step] > self.max_retries_per_step:
                    raise RuntimeError(
                        f"step {step} failed {fail_counts[step]} times; giving up"
                    ) from e
                log.warning("failure at step %d (%s); restoring", step, e)
                try:
                    step, state = self.manager.restore_latest(
                        template=state, sharding_tree=sharding_of(state))
                except FileNotFoundError:
                    step, state = start_step, initial_state
        self.manager.save(step, state, blocking=True)
        return state, metrics_log
