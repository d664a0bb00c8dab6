"""The LM stack of the port: decoder blocks of GQA (global and
sliding-window) or MLA attention over the flash attention kernel, with
dense or MoE MLPs."""
from repro_torch.models.config import (MlaConfig, ModelConfig, MoeConfig,
                                       RglruConfig, SsmConfig)
from repro_torch.models.transformer import ModelOutput, Transformer

__all__ = ["MlaConfig", "ModelConfig", "ModelOutput", "MoeConfig",
           "RglruConfig", "SsmConfig", "Transformer"]
