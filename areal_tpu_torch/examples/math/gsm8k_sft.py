"""Supervised fine-tuning entry — the port of ``examples/math/gsm8k_sft.py``.

Rows from the dataset registry ({"messages", "answer"}) are tokenized here,
the prompt through the chat template (masked out) and the answer as the
supervised target, into the {"input_ids", "loss_mask"} rows ``SFTTrainer``
takes. Without a tokenizer (the smoke configs) rows that carry char-level
``prompt_ids`` get a char-level answer too.

Usage::

    python -m areal_tpu_torch.examples.math.gsm8k_sft --config examples/math/gsm8k_sft.yaml \\
        [model.path=/ckpt/Qwen2.5-1.5B] [train_dataset.path=/data/gsm8k]

Everything runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
Returns the step losses.
"""

from __future__ import annotations

import sys

import numpy as np

from areal_tpu_torch.api.config import SFTConfig, load_expr_config
from areal_tpu_torch.dataset import get_custom_dataset
from areal_tpu_torch.examples.math.common import kept_signal_handlers, load_tokenizer
from areal_tpu_torch.trainer.sft_trainer import SFTTrainer


def tokenize_sft_rows(dataset, tokenizer, max_len: int | None = None) -> list[dict]:
    """{"messages", "answer"} -> {"input_ids", "loss_mask"}: the answer
    supervised, the prompt masked. Rows already tokenized pass through; a
    row whose prompt alone fills ``max_len`` is dropped (it would carry no
    supervised token)."""
    rows = []
    for x in dataset:
        if "input_ids" in x:
            rows.append(x)
            continue
        if tokenizer is None:
            prompt_ids = list(x["prompt_ids"])
            answer_ids = [ord(c) % 256 for c in str(x["answer"])] + [0]
            rows.append({
                "input_ids": np.asarray(prompt_ids + answer_ids, np.int32),
                "loss_mask": np.asarray([0.0] * len(prompt_ids) + [1.0] * len(answer_ids), np.float32),
            })
            continue
        prompt_ids = tokenizer.apply_chat_template(x["messages"], add_generation_prompt=True, tokenize=True)
        answer_ids = tokenizer.encode(str(x["answer"]), add_special_tokens=False)
        if tokenizer.eos_token_id is not None:
            answer_ids = answer_ids + [tokenizer.eos_token_id]
        if max_len is not None and len(prompt_ids) >= max_len:
            continue
        ids = list(prompt_ids) + list(answer_ids)
        mask = [0.0] * len(prompt_ids) + [1.0] * len(answer_ids)
        if max_len is not None and len(ids) > max_len:
            ids, mask = ids[:max_len], mask[:max_len]
        rows.append({"input_ids": np.asarray(ids, np.int32), "loss_mask": np.asarray(mask, np.float32)})
    return rows


def main(argv: list[str], device=None) -> list[float]:
    config, _ = load_expr_config(argv, SFTConfig)
    tokenizer = load_tokenizer(config.tokenizer_path or config.model.path)

    ds_type = config.train_dataset.type or "gsm8k"
    train_rows = get_custom_dataset(ds_type, split="train", path=config.train_dataset.path)
    valid_rows = None
    if config.valid_dataset is not None:
        valid_rows = get_custom_dataset(
            config.valid_dataset.type or ds_type,
            split="test",
            # the eval split defaults to the train split's location
            path=config.valid_dataset.path or config.train_dataset.path,
        )
    max_len = config.train_dataset.max_length
    train_rows = tokenize_sft_rows(train_rows, tokenizer, max_len)
    if valid_rows is not None:
        valid_rows = tokenize_sft_rows(valid_rows, tokenizer, max_len)

    with kept_signal_handlers():
        trainer = SFTTrainer(config, train_rows, valid_dataset=valid_rows, tokenizer=tokenizer, device=device)
        try:
            losses = trainer.train()
        finally:
            trainer.close()
    print(f"final ppl_loss: {losses[-1]:.4f}" if losses else "no steps run")
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
