"""Model configurations of the port (``repro.configs`` copied): the dense
GQA and MoE architectures whose forward and serving path the port runs."""
from repro_torch.configs.registry import (ARCHS, PORTED, canonical,
                                          get_config, get_smoke_config)

__all__ = ["ARCHS", "PORTED", "canonical", "get_config", "get_smoke_config"]
