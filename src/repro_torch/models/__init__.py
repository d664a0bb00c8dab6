"""The LM stack of the port: decoder blocks of GQA (global and
sliding-window) or MLA attention over the flash attention kernel, with
dense or MoE MLPs; Mamba-2 (SSD) and Griffin (RG-LRU) recurrent blocks;
cross-attention over a conditioning memory and prefix embeddings."""
from repro_torch.models.config import (MlaConfig, ModelConfig, MoeConfig,
                                       RglruConfig, SsmConfig)
from repro_torch.models.transformer import ModelOutput, Transformer

__all__ = ["MlaConfig", "ModelConfig", "ModelOutput", "MoeConfig",
           "RglruConfig", "SsmConfig", "Transformer"]
