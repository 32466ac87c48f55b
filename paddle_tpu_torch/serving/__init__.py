"""Continuous-batching GPT serving on the paged KV cache (the port of
paddle_tpu/serving/): dense or int8 KV pools, MHA or GQA; the prefix
cache, speculative decoding, fork groups, paged beam search and guided
decoding on the shared, refcounted KV cache; a host KV tier with lazy
admission and preemption; request telemetry, the HBM ledger and chaos
hooks; and the fleet: replicas behind a router (prefix affinity,
SLO admission, failover, the disaggregated prefill/decode KV handoff,
the self-healing supervisor), in-process or as worker processes over
the socket RPC (transport.py, worker.py, remote.py).
NonFiniteError is re-exported from robustness.guard."""

from .decode_strategies import (BeamHypothesis, BeamParams, GroupFuture,
                                GroupResult, SamplingParams)
from .engine import (GenerationFuture, GenerationServer, GPTServingModel,
                     NonFiniteError)
from .guided import (CharConstraint, ChoiceConstraint, Constraint,
                     JsonConstraint, RegexConstraint, TokenChoiceConstraint)
from .kv_cache import (KV_QMAX, NULL_BLOCK, HostKVTier, PagedDecodeLayer,
                       PagedKVCache, build_paged_decode_cache,
                       gather_block_kv, paged_attention,
                       paged_attention_reference)
from .prefix_cache import PrefixCacheIndex, chain_hash, prompt_chain_keys
from .scheduler import (ContinuousBatchingScheduler, DeadlineExceeded,
                        GenerationResult, RequestCancelled)
from .spec_decode import SpecDecodeConfig
from .replica import Replica
from .router import (AdmissionPolicy, AdmissionRejected, FleetFuture,
                     FleetRouter, RouterPolicy)
from .transport import (FrameError, RemoteError, RpcTimeout,
                        TransportError, VersionMismatch)
from .remote import WorkerProxy, make_subprocess_spawn, spawn_worker

__all__ = ["GenerationServer", "GenerationFuture", "GPTServingModel",
           "NonFiniteError", "SamplingParams", "BeamParams",
           "BeamHypothesis", "GroupFuture", "GroupResult", "PagedKVCache",
           "HostKVTier", "paged_attention", "paged_attention_reference",
           "gather_block_kv", "NULL_BLOCK", "KV_QMAX",
           "PagedDecodeLayer", "build_paged_decode_cache",
           "ContinuousBatchingScheduler", "DeadlineExceeded",
           "GenerationResult", "RequestCancelled", "PrefixCacheIndex",
           "chain_hash", "prompt_chain_keys", "SpecDecodeConfig",
           "Constraint", "CharConstraint", "TokenChoiceConstraint",
           "ChoiceConstraint", "RegexConstraint", "JsonConstraint",
           "Replica", "FleetRouter", "FleetFuture", "RouterPolicy",
           "AdmissionPolicy", "AdmissionRejected",
           "WorkerProxy", "make_subprocess_spawn", "spawn_worker",
           "TransportError", "FrameError", "VersionMismatch",
           "RpcTimeout", "RemoteError"]
