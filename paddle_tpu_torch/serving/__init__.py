"""Continuous-batching GPT serving on the paged KV cache (the port of
paddle_tpu/serving/): dense or int8 KV pools, MHA or GQA."""

from .decode_strategies import SamplingParams
from .engine import (GenerationFuture, GenerationServer, GPTServingModel,
                     NonFiniteError)
from .kv_cache import KV_QMAX, NULL_BLOCK, PagedKVCache, paged_attention
from .scheduler import DeadlineExceeded, GenerationResult, RequestCancelled

__all__ = ["GenerationServer", "GenerationFuture", "GPTServingModel",
           "NonFiniteError", "SamplingParams", "PagedKVCache",
           "paged_attention", "NULL_BLOCK", "KV_QMAX", "DeadlineExceeded",
           "GenerationResult", "RequestCancelled"]
