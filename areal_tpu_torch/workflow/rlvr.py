"""RLVR (RL with verifiable rewards) workflow: generate, score, build the
trajectory dicts (``areal_tpu/workflow/rlvr.py``). One episode samples
``n_samples`` completions of one prompt (the GRPO group), scores each with
the reward function, and emits per-sequence dicts with the prompt masked
out of the loss and the server's per-token behavior logprobs and versions.
"""

from __future__ import annotations

import asyncio
from typing import Any, Callable

import numpy as np

from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.api.reward_api import AsyncRewardWrapper
from areal_tpu_torch.api.workflow_api import RolloutWorkflow
from areal_tpu_torch.utils import perf_tracer, stats_tracker


def prompt_ids_of(data: dict, tokenizer=None, enable_thinking: bool = False) -> list[int]:
    """The prompt token ids of a dataset row.

    A real tokenizer wins over baked ``prompt_ids``: rows that carry both
    (char-level ids for tokenizer-free smoke runs) must not feed those ids
    to a real model, whose vocabulary they mean nothing in."""
    if tokenizer is not None and ("messages" in data or "prompt" in data):
        if "messages" in data:
            return tokenizer.apply_chat_template(
                data["messages"],
                add_generation_prompt=True,
                tokenize=True,
                enable_thinking=enable_thinking,
            )
        return tokenizer.encode(data["prompt"])
    if "prompt_ids" in data:
        return list(data["prompt_ids"])
    assert tokenizer is not None, "tokenizer required for message/text prompts"
    if "messages" in data:
        return tokenizer.apply_chat_template(
            data["messages"],
            add_generation_prompt=True,
            tokenize=True,
            enable_thinking=enable_thinking,
        )
    return tokenizer.encode(data["prompt"])


class RLVRWorkflow(RolloutWorkflow):
    def __init__(
        self,
        reward_fn: Callable,
        gconfig: GenerationHyperparameters,
        tokenizer: Any = None,
        enable_thinking: bool = False,
        use_process_pool_reward: bool = False,
    ):
        self.reward_fn = AsyncRewardWrapper(reward_fn, use_process_pool=use_process_pool_reward)
        self.gconfig = gconfig
        self.tokenizer = tokenizer
        self.enable_thinking = enable_thinking

    async def arun_episode(self, engine, data: dict):
        prompt_ids = prompt_ids_of(data, self.tokenizer, self.enable_thinking)
        n = self.gconfig.n_samples
        gcfg = self.gconfig.new(n_samples=1)
        reqs = [ModelRequest(input_ids=prompt_ids, gconfig=gcfg) for _ in range(n)]
        with perf_tracer.get_session_tracer().phase("generate"):
            resps = await asyncio.gather(*[engine.agenerate(r) for r in reqs])

        results = []
        for resp in resps:
            completion_str = (
                self.tokenizer.decode(
                    resp.output_tokens,
                    skip_special_tokens=self.gconfig.skip_special_tokens,
                )
                if self.tokenizer
                else ""
            )
            prompt_str = (
                self.tokenizer.decode(prompt_ids) if self.tokenizer else ""
            )
            with perf_tracer.get_session_tracer().phase("reward"):
                reward = await self.reward_fn(
                    prompt_str,
                    completion_str,
                    prompt_ids,
                    resp.output_tokens,
                    **{
                        k: v
                        for k, v in data.items()
                        if k not in ("prompt_ids", "messages", "prompt")
                    },
                )
            p, o = len(prompt_ids), len(resp.output_tokens)
            seq = np.asarray(prompt_ids + resp.output_tokens, np.int32)
            results.append(
                {
                    "input_ids": seq,
                    "loss_mask": np.concatenate(
                        [np.zeros(p, np.float32), np.ones(o, np.float32)]
                    ),
                    "logprobs": np.concatenate(
                        [np.zeros(p, np.float32), np.asarray(resp.output_logprobs, np.float32)]
                    ),
                    "versions": np.concatenate(
                        [np.full(p, -1, np.int32), np.asarray(resp.output_versions, np.int32)]
                    ),
                    "rewards": np.float32(reward),
                    # length-capped and truncated (deadline / cancel)
                    # sequences did not choose to stop: the trainer must
                    # not score them as EOS-terminated
                    "seq_no_eos_mask": np.bool_(
                        resp.stop_reason == "length" or bool(resp.truncated_by)
                    ),
                }
            )
            stats_tracker.get().scalar(
                reward=float(reward), gen_tokens=float(o)
            )
        return results


class GroupedRolloutWorkflow(RolloutWorkflow):
    """Wrap a single-sample workflow to run ``group_size`` episodes."""

    def __init__(self, inner: RolloutWorkflow, group_size: int):
        self.inner = inner
        self.group_size = group_size

    async def arun_episode(self, engine, data: dict):
        outs = await asyncio.gather(
            *[self.inner.arun_episode(engine, data) for _ in range(self.group_size)]
        )
        flat = []
        for o in outs:
            if o is None:
                return None
            flat.extend(o if isinstance(o, list) else [o])
        return flat
