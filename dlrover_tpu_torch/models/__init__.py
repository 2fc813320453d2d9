"""Model families: the Llama (and its MoE and pipelined forms), GPT-2 and
the Vision Transformer."""

from dlrover_tpu_torch.models.gpt import GPT, GPTConfig
from dlrover_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from dlrover_tpu_torch.models.moe import MoELlamaConfig, MoELlamaForCausalLM
from dlrover_tpu_torch.models.pipeline_llama import PipelinedLlama
from dlrover_tpu_torch.models.vit import ViTConfig, ViTForImageClassification

__all__ = [
    "GPT", "GPTConfig", "LlamaConfig", "LlamaForCausalLM", "MoELlamaConfig",
    "MoELlamaForCausalLM", "PipelinedLlama", "ViTConfig",
    "ViTForImageClassification",
]
