"""GRPO training entry — the port of ``examples/math/gsm8k_rl.py``.

Two deployment shapes:

- **fleet mode**: an inference server already runs (``python -m
  areal_tpu_torch.inference.server --config ...``) and its address comes
  through ``AREAL_TPU_SERVER_ADDRS`` (one address: a fleet of several is
  ROADMAP Queue A item 8, and the client refuses it);
- **single-host mode** (no address given): the trainer engine, then an
  in-process ``DecodeEngine`` + ``ServerThread`` started from its weights,
  on this host's card; weight updates are "mem" pushes.

Usage::

    python -m areal_tpu_torch.examples.math.gsm8k_rl --config examples/math/gsm8k_grpo.yaml \\
        [train_dataset.path=/data/gsm8k] [key=value ...]

Everything runs on the card; ``main(argv, device="cpu")`` runs the plain
PyTorch path on the CPU (the tests do). Returns the closed ``PPOTrainer``.
"""

from __future__ import annotations

import os
import sys

from areal_tpu_torch.api.config import GRPOConfig, load_expr_config
from areal_tpu_torch.dataset import get_custom_dataset
from areal_tpu_torch.examples.math.common import (
    kept_signal_handlers,
    load_processor,
    load_tokenizer,
    make_workflow,
    start_single_host_stack,
)
from areal_tpu_torch.inference.client import RemoteTorchEngine
from areal_tpu_torch.trainer.rl_trainer import PPOTrainer


def server_addresses() -> list[str]:
    return [a for a in os.environ.get("AREAL_TPU_SERVER_ADDRS", "").split(",") if a]


def main(argv: list[str], device=None):
    config, _ = load_expr_config(argv, GRPOConfig)
    tokenizer = load_tokenizer(config.tokenizer_path or config.actor.path)

    ds_type = config.train_dataset.type or "gsm8k"
    train_dataset = get_custom_dataset(ds_type, split="train", path=config.train_dataset.path)
    valid_dataset = None
    if config.valid_dataset is not None:
        valid_dataset = get_custom_dataset(
            config.valid_dataset.type or ds_type, split="test", path=config.valid_dataset.path
        )

    server = rollout = trainer = workflow = eval_workflow = None
    with kept_signal_handlers():
        try:
            addrs = server_addresses()
            actor_engine = None  # fleet mode: PPOTrainer builds it
            if not addrs:
                actor_engine, server = start_single_host_stack(config, len(train_dataset), device=device)
                addrs = [server.address]
            rollout = RemoteTorchEngine(config.rollout, addresses=addrs)
            rollout.initialize()

            # each split's workflow follows its dataset's modality
            valid_ds_type = (config.valid_dataset.type or ds_type) if config.valid_dataset is not None else ds_type
            proc_path = config.tokenizer_path or config.actor.path
            workflow = make_workflow(ds_type, config.gconfig, tokenizer, load_processor(proc_path, ds_type))
            eval_workflow = make_workflow(valid_ds_type, config.gconfig.new(temperature=0.6), tokenizer,
                                          load_processor(proc_path, valid_ds_type))
            trainer = PPOTrainer(
                config,
                train_dataset,
                valid_dataset=valid_dataset,
                rollout=rollout,
                tokenizer=tokenizer,
                actor_engine=actor_engine,
                device=device,
            )
            trainer.train(workflow=workflow, eval_workflow=eval_workflow)
        finally:
            if trainer is not None:
                trainer.close()  # destroys the rollout client too
            elif rollout is not None:
                rollout.destroy()
            if server is not None:
                server.stop()
            for wf in (workflow, eval_workflow):
                if wf is not None:
                    wf.reward_fn.close()  # the reward's thread pool
    return trainer


if __name__ == "__main__":
    main(sys.argv[1:])
