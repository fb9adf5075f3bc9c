"""Reward-model training entry — the port of
``examples/alignment/hhrlhf_rw.py``: the Bradley-Terry pairwise loss over a
value head (``trainer/sft_trainer.py RWTrainer``); each batch interleaves
(chosen, rejected) rows and microbatching keeps the pairs whole.

Usage::

    python -m areal_tpu_torch.examples.alignment.hhrlhf_rw \\
        --config examples/alignment/hhrlhf_rw.yaml \\
        model.path=/ckpt/Qwen2.5-1.5B train_dataset.path=/data/hh-rlhf

Everything runs on the card; ``main(argv, device="cpu")`` runs on the CPU.
Returns the step losses.
"""

from __future__ import annotations

import sys

from areal_tpu_torch.api.config import RWConfig, load_expr_config
from areal_tpu_torch.dataset import get_custom_dataset
from areal_tpu_torch.examples.math.common import kept_signal_handlers, load_tokenizer
from areal_tpu_torch.trainer.sft_trainer import RWTrainer


def main(argv: list[str], device=None) -> list[float]:
    config, _ = load_expr_config(argv, RWConfig)
    tokenizer = load_tokenizer(config.tokenizer_path or config.model.path)

    ds_type = config.train_dataset.type or "hh_rlhf"
    train_rows = get_custom_dataset(
        ds_type,
        split="train",
        path=config.train_dataset.path,
        tokenizer=tokenizer,
        max_length=config.train_dataset.max_length,
    )
    with kept_signal_handlers():
        trainer = RWTrainer(config, train_rows, tokenizer=tokenizer, device=device)
        try:
            losses = trainer.train()
        finally:
            trainer.close()
    print(f"final rw_loss={losses[-1]:.4f}" if losses else "no steps run")
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
