"""Reward functions, copied from ``areal_tpu/reward/``."""

from areal_tpu_torch.reward.gsm8k import gsm8k_reward_fn  # noqa: F401
