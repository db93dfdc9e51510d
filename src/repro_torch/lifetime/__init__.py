# Post-programming device dynamics and verify-driven refresh: a deployed
# model's conductances are state that ages (relaxation, drift, read
# disturb, endurance wear) and gets scrubbed back by the WV engine.
from .drift import (  # noqa: F401
    CellState,
    DriftConfig,
    advance,
    effective_d2d,
    init_cell_state,
    reset_programmed,
    wear_efficiency,
)
from .refresh import (  # noqa: F401
    RefreshConfig,
    RefreshOutcome,
    RefreshPolicy,
    apply_refresh,
    default_flag_params,
    flag_columns,
)
from .service import EpochRecord, LifetimeReport, LifetimeSimulator  # noqa: F401
