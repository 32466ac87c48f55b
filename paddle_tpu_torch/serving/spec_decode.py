"""Speculative decoding: draft proposals verified by the fused step.

Counterpart of ``paddle_tpu/serving/spec_decode.py``. A small draft
model proposes k tokens per iteration, and the target verifies them in
ONE chunked call of its fused step: q = min(k+1, chunk) columns a decode
lane, ``[committed_token, d_1, ..., d_{q-1}]`` at positions
``pos .. pos+q-1``. Column i's output is the target's own next-token
choice after fed column i, so greedy acceptance is a host comparison:
accept the longest prefix with ``d_i == target_choice_i``, then commit
the target's next token after it. Every committed id is the target's
greedy choice under the same context, so the stream equals plain greedy
decode's. Rejected drafts' KV lands at positions past the committed
horizon and is overwritten by the next iteration's feed before anything
attends to it.

The draft step, per iteration:

    draft(pools, tokens (S, C), positions (S, C), valid (S, C),
          tables (S, M), spec_go (S,), limits (S,))
        -> (proposals (S, k), proposal_logps (S, k))

first mirrors the plan's feed (prefill chunks, each decode lane's
committed token) into the DRAFT pools, so the draft's KV tracks the
target's context, then rolls out k-1 single-token micro-steps (C = 1)
per decode lane (`spec_go`). A rollout write past a lane's reserved
horizon (`limits`, prompt + max_new_tokens) goes to the NULL block. Its
pools are written in place. The draft pools are a sibling PagedKVCache
that shares the target's block ids and tables (one host allocation drives
both, and copy-on-write copies both), so every draft attention call
runs the same paged-attention kernel over the same tables, at the
draft's head dim.

``mode="rejection"`` accepts draft i with probability min(1,
p_target(d_i)/p_draft(d_i)) from the fused step's fed-token logps and
the draft's proposal logps, and commits the target's argmax on the
first rejection (the JAX package's greedy correction).
"""

import torch

__all__ = ["SpecDecodeConfig", "build_draft_step"]


class SpecDecodeConfig:
    """Engine-facing settings: the draft model (a GPTServingModel over
    the target's vocab), k proposals per iteration, the acceptance mode,
    and the rejection mode's RNG seed."""

    def __init__(self, draft_model, k=3, mode="greedy", seed=0):
        if k < 1:
            raise ValueError(f"spec k must be >= 1, got {k}")
        if mode not in ("greedy", "rejection"):
            raise ValueError(
                f"spec mode {mode!r}: expected 'greedy' or 'rejection'")
        self.draft_model = draft_model
        self.k = int(k)
        self.mode = mode
        self.seed = int(seed)


def build_draft_step(model, block_size, k):
    """The draft step of the module docstring over `model`'s params: a
    sync pass over the plan's feed + k-1 rollout micro-steps."""
    from .engine import _fused_step_body

    def body(pools, tokens, positions, valid, tables):
        # greedy, last valid column: (next ids (S,), their logps (S,))
        return _fused_step_body(
            model.params, model.cfg, block_size, model.num_heads,
            model.num_kv_heads, model.head_dim, None, pools, tokens,
            positions, valid, tables, model.attention)[:2]

    def draft_step(pools, tokens, positions, valid, tables, spec_go,
                   limits):
        with torch.inference_mode():
            # sync pass: prefill chunks and committed decode tokens write
            # their draft KV; the last-column output is each decode
            # lane's first proposal d_1
            cur, cur_lp = body(pools, tokens, positions, valid, tables)
            c = tokens.shape[1]
            last = (valid.sum(1) - 1).clamp(0, c - 1)
            base = torch.gather(positions, 1,
                                last[:, None].long())[:, 0] + 1
            props, plps = [cur], [cur_lp]
            for i in range(1, k):
                # feed proposal d_i at its position; masked for lanes not
                # speculating and past each lane's reserved horizon
                pos_i = base + i - 1
                v_i = (spec_go & (pos_i < limits))[:, None]
                cur, cur_lp = body(pools, cur[:, None],
                                   pos_i[:, None].to(torch.int32), v_i,
                                   tables)
                props.append(cur)
                plps.append(cur_lp)
            return torch.stack(props, 1), torch.stack(plps, 1)

    return draft_step
