"""Model configurations of the port (``repro.configs`` copied): every
architecture of the reference, and the dry-run shapes and cells."""
from repro_torch.configs.registry import (ARCHS, LONG_CONTEXT_ARCHS, PORTED,
                                          SHAPES, canonical, cells,
                                          get_config, get_smoke_config)

__all__ = ["ARCHS", "LONG_CONTEXT_ARCHS", "PORTED", "SHAPES", "canonical",
           "cells", "get_config", "get_smoke_config"]
