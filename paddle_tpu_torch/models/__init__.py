from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM, GPTModel,
                  build_unified_step, serving_params)

__all__ = ["GPT_CONFIGS", "GPTConfig", "GPTForCausalLM", "GPTModel",
           "build_unified_step", "serving_params"]
