from .bert import (BERT_CONFIGS, BertConfig, BertForPretraining,
                   BertForSequenceClassification, BertModel)
from .gpt import (GPT_CONFIGS, GPTConfig, GPTForCausalLM, GPTModel,
                  build_unified_step, serving_params)

__all__ = ["BERT_CONFIGS", "BertConfig", "BertForPretraining",
           "BertForSequenceClassification", "BertModel", "GPT_CONFIGS",
           "GPTConfig", "GPTForCausalLM", "GPTModel", "build_unified_step",
           "serving_params"]
