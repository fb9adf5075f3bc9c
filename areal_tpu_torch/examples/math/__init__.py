"""The math entries: GRPO (``gsm8k_rl``), SFT (``gsm8k_sft``) and greedy evaluation (``gsm8k_eval``)."""
