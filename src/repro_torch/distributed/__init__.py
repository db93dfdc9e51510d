from .sharding import ShardingRules, spec_for_path, shard_params_tree  # noqa: F401
from .straggler import StragglerMonitor  # noqa: F401
from .fault import FaultInjector, FaultTolerantRunner, SimulatedFailure  # noqa: F401
