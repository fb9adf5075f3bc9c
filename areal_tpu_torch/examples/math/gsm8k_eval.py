"""Evaluation entry — the port of ``examples/math/gsm8k_eval.py``: greedy
decoding of the test split against a running server (fleet mode,
``AREAL_TPU_SERVER_ADDRS``) or an in-process server loaded from the actor's
checkpoint, reporting the mean reward and the accuracy.

Usage::

    # against a running server
    AREAL_TPU_SERVER_ADDRS=10.0.0.1:9000 python -m areal_tpu_torch.examples.math.gsm8k_eval \\
        --config examples/math/gsm8k_grpo.yaml valid_dataset.path=/data/gsm8k
    # single-host: a server loaded from the actor checkpoint
    python -m areal_tpu_torch.examples.math.gsm8k_eval --config examples/math/gsm8k_grpo.yaml \\
        actor.path=/ckpt/Qwen2.5-1.5B valid_dataset.path=/data/gsm8k

The in-process server runs on the card; ``main(argv, device="cpu")`` runs it
on the CPU. Returns {"n", "mean_reward", "accuracy", "failed"}.
"""

from __future__ import annotations

import asyncio
import sys

import numpy as np

from areal_tpu_torch.api.config import GRPOConfig, load_expr_config
from areal_tpu_torch.api.io_struct import GenerationHyperparameters, ModelRequest
from areal_tpu_torch.dataset import get_custom_dataset
from areal_tpu_torch.examples.math.common import kept_signal_handlers, load_tokenizer, reward_for, start_local_server
from areal_tpu_torch.examples.math.gsm8k_rl import server_addresses
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.workflow.rlvr import prompt_ids_of


def main(argv: list[str], device=None) -> dict:
    config, _ = load_expr_config(argv, GRPOConfig)
    tokenizer = load_tokenizer(config.tokenizer_path or config.actor.path)

    ds_cfg = config.valid_dataset or config.train_dataset
    ds_type = ds_cfg.type or "gsm8k"
    dataset = get_custom_dataset(ds_type, split="test", path=ds_cfg.path or config.train_dataset.path)
    reward_fn = reward_for(ds_type)
    gcfg = GenerationHyperparameters(n_samples=1, max_new_tokens=config.gconfig.max_new_tokens, greedy=True)

    server = rollout = None
    with kept_signal_handlers():
        try:
            addrs = server_addresses()
            if not addrs:
                scfg = config.server
                scfg.model_path = scfg.model_path or config.actor.path
                server = start_local_server(scfg, device=device)
                addrs = [server.address]
            rollout = RemoteTorchEngine(config.rollout, addresses=addrs)
            rollout.initialize()

            async def run() -> list:
                # the rollout config's concurrency bound governs eval too
                sem = asyncio.Semaphore(config.rollout.max_concurrent_rollouts or 64)

                async def one(row: dict) -> float:
                    prompt_ids = prompt_ids_of(row, tokenizer, False)
                    async with sem:
                        resp = await rollout.agenerate(ModelRequest(input_ids=prompt_ids, gconfig=gcfg))
                    completion = tokenizer.decode(resp.output_tokens) if tokenizer else ""
                    prompt = tokenizer.decode(prompt_ids) if tokenizer else ""
                    extra = {k: v for k, v in row.items() if k not in ("prompt_ids", "messages", "prompt")}
                    return float(reward_fn(prompt, completion, prompt_ids, resp.output_tokens, **extra))

                # one failed row must not discard the finished scores
                out = await asyncio.gather(*(one(r) for r in dataset), return_exceptions=True)
                await rollout.close_loop_connections()
                return out

            results = asyncio.run(run())
        finally:
            if rollout is not None:
                rollout.destroy()
            if server is not None:
                server.stop()
    rewards = np.asarray([r for r in results if not isinstance(r, BaseException)], np.float64)
    n_failed = len(results) - len(rewards)
    if n_failed:
        first = next(r for r in results if isinstance(r, BaseException))
        print(f"warning: {n_failed}/{len(results)} rows failed (first: {first!r})")
    if not len(rewards):
        print("no rows scored")
        return {"n": 0, "mean_reward": 0.0, "accuracy": 0.0, "failed": n_failed}
    out = {
        "n": int(len(rewards)),
        "mean_reward": float(rewards.mean()),
        "accuracy": float((rewards > 0).mean()),
        "failed": int(n_failed),
    }
    print(f"n={out['n']} mean_reward={out['mean_reward']:.4f} accuracy={out['accuracy']:.4f} failed={out['failed']}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
