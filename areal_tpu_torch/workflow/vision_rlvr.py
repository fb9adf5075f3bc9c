"""Vision RLVR workflow: image + prompt -> generate -> verifiable reward
(``areal_tpu/workflow/vision_rlvr.py``).

The processor turns a dataset row's images and messages into prompt token
ids (with <|image_pad|> runs) and pixel patches; each request carries the
patches to the server, whose engine runs the vision tower at prefill
(``models/vision.py``), and the emitted trajectories keep the patches so the
trainer recomputes the multimodal logprobs.
"""

from __future__ import annotations

import asyncio
import uuid
from typing import Any, Callable

import numpy as np

from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.api.reward_api import AsyncRewardWrapper
from areal_tpu_torch.api.workflow_api import RolloutWorkflow
from areal_tpu_torch.models.vision import grid_pos_ids
from areal_tpu_torch.utils import perf_tracer, stats_tracker


class VisionRLVRWorkflow(RolloutWorkflow):
    def __init__(
        self,
        reward_fn: Callable,
        gconfig: GenerationHyperparameters,
        tokenizer: Any,
        processor: Any,
        enable_thinking: bool = False,
        use_process_pool_reward: bool = False,
    ):
        self.reward_fn = AsyncRewardWrapper(reward_fn, use_process_pool=use_process_pool_reward)
        self.gconfig = gconfig
        self.tokenizer = tokenizer
        self.processor = processor
        self.enable_thinking = enable_thinking

    def _process(self, data: dict) -> tuple[list[int], np.ndarray, np.ndarray | None]:
        """-> (prompt token ids with the image pads, pixel patches [P, pd],
        the (t, h, w) grids or None). A processor takes rendered text with
        the vision placeholders, so the messages are rendered first when it
        can render them."""
        messages = data["messages"]
        if hasattr(self.processor, "apply_chat_template"):
            text = self.processor.apply_chat_template(messages, add_generation_prompt=True, tokenize=False)
        else:
            text = messages
        out = self.processor(images=data["images"], text=text, padding=False, return_tensors="np")
        input_ids = np.asarray(out["input_ids"]).reshape(-1).tolist()
        pixel_values = np.asarray(out["pixel_values"], np.float32)
        if pixel_values.ndim == 3:  # [1, P, pd]
            pixel_values = pixel_values[0]
        grid_thw = out.get("image_grid_thw")
        if grid_thw is not None:
            grid_thw = np.asarray(grid_thw).reshape(-1, 3)
        return input_ids, pixel_values, grid_thw

    async def _one_sample(self, engine, prompt_ids, pixel_values, grid_thw, data):
        req = ModelRequest(
            rid=uuid.uuid4().hex,
            input_ids=prompt_ids,
            image_data=pixel_values,
            image_grid_thw=grid_thw,
            gconfig=self.gconfig.new(n_samples=1),
        )
        with perf_tracer.get_session_tracer().phase("generate"):
            resp = await engine.agenerate(req)
        prompt_str = self.tokenizer.decode(prompt_ids)
        completion_str = self.tokenizer.decode(resp.output_tokens, skip_special_tokens=self.gconfig.skip_special_tokens)
        with perf_tracer.get_session_tracer().phase("reward"):
            reward = await self.reward_fn(
                prompt_str,
                completion_str,
                prompt_ids,
                resp.output_tokens,
                **{k: v for k, v in data.items() if k not in ("messages", "images", "prompt")},
            )
        p, o = len(prompt_ids), len(resp.output_tokens)
        stats_tracker.get().scalar(reward=float(reward), gen_tokens=float(o))
        return {
            "input_ids": np.asarray(prompt_ids + resp.output_tokens, np.int32),
            "loss_mask": np.concatenate([np.zeros(p, np.float32), np.ones(o, np.float32)]),
            "logprobs": np.concatenate([np.zeros(p, np.float32), np.asarray(resp.output_logprobs, np.float32)]),
            "versions": np.concatenate([np.full(p, -1, np.int32), np.asarray(resp.output_versions, np.int32)]),
            "rewards": np.float32(reward),
            # the trainer's tower input (``_attach_image_embeds``)
            "pixel_values": pixel_values,
            "pixel_counts": np.int32(pixel_values.shape[0]),
            # per-patch grid (row, col) for the 2-D rope, ragged like the patches
            "pixel_pos_ids": self._pos_ids(pixel_values, grid_thw),
            # length-capped and truncated (deadline / cancel) sequences did
            # not choose to stop: the trainer must not score them as EOS
            "seq_no_eos_mask": np.bool_(resp.stop_reason == "length" or bool(resp.truncated_by)),
        }

    def _pos_ids(self, pixel_values, grid_thw) -> np.ndarray:
        if grid_thw is None:
            return np.zeros((pixel_values.shape[0], 2), np.int32)
        merge = getattr(getattr(self.processor, "image_processor", None), "merge_size", 2)
        return grid_pos_ids(grid_thw, merge)

    async def arun_episode(self, engine, data: dict):
        prompt_ids, pixel_values, grid_thw = self._process(data)
        # the GRPO group: n_samples completions of one prompt
        return list(
            await asyncio.gather(
                *[self._one_sample(engine, prompt_ids, pixel_values, grid_thw, data)
                  for _ in range(self.gconfig.n_samples)]
            )
        )
