"""The LM stack of the port: dense GQA decoder blocks (global and
sliding-window attention) over the flash attention kernel."""
from repro_torch.models.config import (MlaConfig, ModelConfig, MoeConfig,
                                       RglruConfig, SsmConfig)
from repro_torch.models.transformer import ModelOutput, Transformer

__all__ = ["MlaConfig", "ModelConfig", "ModelOutput", "MoeConfig",
           "RglruConfig", "SsmConfig", "Transformer"]
