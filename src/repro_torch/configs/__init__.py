"""Architecture registry: ``get_config(arch)`` / ``get_smoke_config(arch)``.

A copy of ``repro/configs`` for the PyTorch port (which imports nothing of
the JAX package); dtypes resolve to ``torch`` dtypes.
"""

from repro_torch.configs.archs import (ARCHS, get_config, get_smoke_config,  # noqa: F401
                                 shape_cells, skip_reason)
from repro_torch.configs.base import (SHAPES, DistConfig, LRDConfig, ModelConfig,  # noqa: F401
                                ObsConfig, OptimConfig, RunConfig,
                                ShapeConfig)
