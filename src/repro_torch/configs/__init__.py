from .registry import (  # noqa: F401
    ARCHS,
    DENSE_ARCHS,
    SHAPES,
    ShapeSpec,
    get_config,
    get_smoke_config,
    input_specs,
    materialize_inputs,
    runnable_cells,
)
