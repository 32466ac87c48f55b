"""Continuous-batching GPT serving on the paged KV cache (the port of
paddle_tpu/serving/): dense or int8 KV pools, MHA or GQA; the prefix
cache, speculative decoding, fork groups, paged beam search and guided
decoding on the shared, refcounted KV cache; a host KV tier with lazy
admission and preemption; request telemetry, the HBM ledger and chaos
hooks. NonFiniteError is re-exported from robustness.guard."""

from .decode_strategies import (BeamHypothesis, BeamParams, GroupFuture,
                                GroupResult, SamplingParams)
from .engine import (GenerationFuture, GenerationServer, GPTServingModel,
                     NonFiniteError)
from .guided import (CharConstraint, ChoiceConstraint, Constraint,
                     JsonConstraint, RegexConstraint, TokenChoiceConstraint)
from .kv_cache import (KV_QMAX, NULL_BLOCK, HostKVTier, PagedKVCache,
                       paged_attention)
from .prefix_cache import PrefixCacheIndex, chain_hash, prompt_chain_keys
from .scheduler import DeadlineExceeded, GenerationResult, RequestCancelled
from .spec_decode import SpecDecodeConfig

__all__ = ["GenerationServer", "GenerationFuture", "GPTServingModel",
           "NonFiniteError", "SamplingParams", "BeamParams",
           "BeamHypothesis", "GroupFuture", "GroupResult", "PagedKVCache",
           "HostKVTier",
           "paged_attention", "NULL_BLOCK", "KV_QMAX", "DeadlineExceeded",
           "GenerationResult", "RequestCancelled", "PrefixCacheIndex",
           "chain_hash", "prompt_chain_keys", "SpecDecodeConfig",
           "Constraint", "CharConstraint", "TokenChoiceConstraint",
           "ChoiceConstraint", "RegexConstraint", "JsonConstraint"]
