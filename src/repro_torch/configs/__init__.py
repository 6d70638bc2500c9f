"""Model and run configurations, copied from the reference's JAX-free
`repro.configs` (same names, same values) so the port imports nothing of it."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, PortModelConfig, RunConfig, ShapeConfig)
from repro_torch.configs.registry import (  # noqa: F401
    ARCHS, PORT_ARCHS, all_cells, get_model, get_run_config, reduced_model,
)
from repro_torch.configs.shapes import ALL_SHAPES, SHAPES_BY_NAME  # noqa: F401
