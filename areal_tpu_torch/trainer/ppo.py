"""PPO-family algorithm layer: advantages, the loss dispatch and the update
loop — the port of ``areal_tpu/trainer/ppo.py`` (``grpo_loss_fn``,
``PPOActor``).

Host-side data is token-aligned ([b, t] refers to token t: rollout
logprobs, ``forward_batch`` outputs); ``compute_advantages`` converts the
per-token training keys to label alignment with roll(-1), because the train
engine's outputs are label-aligned. The log-linear proximal approximation's
factor ``prox_alpha`` is computed on the host from the per-token versions.

``ppo_update`` records the JAX actor's ``stats_tracker`` scalars under
``ppo_actor/`` (the batch's reward, lengths and advantages, then each
minibatch's training stats), which ``PPOTrainer`` commits every step.

Left out: the learning-health and lineage exports of the JAX trainer
(per-lag-bucket loss stats, per-sequence loss attribution), ROADMAP Queue
A, trainer breadth; and the critic (``PPOCritic``).
"""

from __future__ import annotations

import numpy as np
import torch

from areal_tpu_torch.api.config import PPOActorConfig
from areal_tpu_torch.ops import functional as F
from areal_tpu_torch.utils import stats_tracker
from areal_tpu_torch.utils.data import (
    MicroBatchSpec,
    Normalization,
    TensorDict,
    split_padded_tensor_dict_into_mb_list,
)
from areal_tpu_torch.utils.data import roll_to_label_alignment as _roll_back


def grpo_loss_fn(outputs: dict, b: dict, cfg: PPOActorConfig):
    """Packed-grid policy loss. ``outputs`` has label-aligned logprobs and
    entropy; ``b`` the label-aligned per-token data ``compute_advantages``
    prepared. M2PO mask -> SAPO or PPO-clip / decoupled -> scalar stats."""
    logprobs = outputs["logprobs"]
    entropy = outputs["entropy"].detach()
    lm = (b["loss_mask"] > 0) & b["label_valid"]
    old_logp = b["old_logprobs"]

    # resolve the proximal logprobs
    if "prox_logprobs" in b:
        prox_logp = b["prox_logprobs"]
    elif "prox_alpha" in b:  # log-linear approximation, no extra forward
        prox_logp = old_logp + b["prox_alpha"] * (logprobs.detach() - old_logp)
    else:
        prox_logp = old_logp

    if cfg.use_m2po_loss:
        lm = F.m2po_loss_mask(old_logp, prox_logp, lm, cfg.m2po_tau)

    if cfg.use_sapo_loss:
        loss, stat = F.sapo_loss_fn(
            logprobs=logprobs,
            old_logprobs=old_logp,
            advantages=b["advantages"],
            loss_mask=lm,
            tau_pos=cfg.sapo_tau_pos,
            tau_neg=cfg.sapo_tau_neg,
            importance_sampling_level=cfg.imp_ratio_level,
        )
    else:
        loss, stat = F.ppo_actor_loss_fn(
            logprobs=logprobs,
            proximal_logprobs=prox_logp,
            old_logprobs=old_logp,
            advantages=b["advantages"],
            loss_mask=lm,
            eps_clip=cfg.eps_clip,
            eps_clip_higher=cfg.eps_clip_higher,
            c_clip=cfg.c_clip,
            behave_imp_weight_cap=cfg.behav_imp_weight_cap,
            importance_sampling_level=cfg.imp_ratio_level,
            behave_imp_weight_mode=(
                cfg.behave_imp_weight_mode if cfg.use_decoupled_loss else "disabled"
            ),
        )

    lmf = lm.float()
    if cfg.entropy_coeff:
        loss = loss - cfg.entropy_coeff * (outputs["entropy"] * lmf).sum() / torch.clamp(
            lmf.sum(), min=1.0
        )

    denom = torch.clamp(lmf.sum(), min=1.0)

    def tok_mean(x, mask=None):
        m = lmf if mask is None else mask.float()
        return (x * m).sum() / torch.clamp(m.sum(), min=1.0)

    stats = {
        "actor_loss": tok_mean(stat["loss"]),
        "importance_weight": tok_mean(stat["importance_weight"]),
        "approx_kl": tok_mean(stat["approx_kl"]),
        "entropy": tok_mean(entropy),
        "new_logp": tok_mean(logprobs.detach()),
        "old_logp": tok_mean(old_logp),
        "clip_ratio": stat["clip_mask"].float().sum() / denom,
        "dual_clip_ratio": stat["dual_clip_mask"].float().sum() / denom,
        "n_valid_tokens": lmf.sum(),
    }
    if "behave_imp_weight" in stat:
        stats["behave_imp_weight"] = tok_mean(stat["behave_imp_weight"], stat["behave_mask"])
        stats["behave_approx_kl"] = tok_mean(stat["behave_approx_kl"], stat["behave_mask"])
        stats["unclipped_behave_ratio"] = stat["behave_mask"].float().sum() / denom
    if "sapo_soft_gate" in stat:
        stats["sapo_soft_gate"] = tok_mean(stat["sapo_soft_gate"])
    return loss, stats


class PPOActor:
    """Algorithm logic over a train engine (``TorchTrainEngine``)."""

    def __init__(self, config: PPOActorConfig, engine):
        self.config = config
        self.engine = engine
        # group_reward_norm: normalize the scalar task reward within each
        # GRPO sample group
        self.reward_norm = (
            Normalization(mean_level="group", std_level="group", group_size=config.group_size)
            if config.group_reward_norm
            else None
        )
        self.adv_norm = (
            Normalization(
                mean_level=config.adv_norm.mean_level,
                std_level=config.adv_norm.std_level,
                group_size=config.adv_norm.group_size or config.group_size,
                mean_leave1out=config.adv_norm.mean_leave1out,
                std_unbiased=config.adv_norm.std_unbiased,
            )
            if config.adv_norm
            else None
        )
        cfg = config
        self._loss_fn = lambda outputs, b: grpo_loss_fn(outputs, b, cfg)

    def should_compute_prox_logp(self) -> bool:
        c = self.config
        if c.use_decoupled_loss:
            return c.prox_logp_mode in ("recompute", "metrics")
        return c.recompute_logprob

    def compute_logp(self, data: TensorDict) -> np.ndarray:
        """Token-aligned logprobs of ``input_ids`` under the current policy
        (the no-grad forward: flash kernel K2 on a card)."""
        return self.engine.forward_batch(data, output_key="logprobs")

    # -- advantages --------------------------------------------------------
    def compute_advantages(self, data: TensorDict) -> TensorDict:
        """Reward shaping, KL-regularized token rewards, masked GAE and
        advantage normalization, on the host in numpy; per-token training
        keys come back label-aligned."""
        cfg = self.config
        data = dict(data)
        attn = np.asarray(data["attention_mask"], bool)
        B, L = attn.shape
        loss_mask_tok = np.asarray(data["loss_mask"], np.float32) * attn

        # 1. sequence rewards: overlong penalty -> bias/scale/clip -> norm
        reward_score = np.asarray(data["rewards"], np.float32).reshape(B)
        if cfg.overlong_reward_penalty:
            if cfg.max_response_length <= 0:
                raise ValueError(
                    "overlong_reward_penalty=True requires max_response_length > 0 "
                    "(set it to the generation cap)"
                )
            reward_score = F.reward_overlong_penalty(
                torch.from_numpy(reward_score),
                torch.from_numpy(loss_mask_tok.sum(-1)),
                overlong_tokens=cfg.overlong_tokens,
                overlong_penalty_factor=cfg.overlong_penalty_factor,
                max_response_length=cfg.max_response_length,
            ).numpy()
        reward_score = (reward_score + cfg.reward_bias) * cfg.reward_scaling
        reward_score = np.clip(reward_score, -cfg.reward_clip, cfg.reward_clip)
        if self.reward_norm is not None:
            reward_score = self.reward_norm(reward_score)

        # 2. label-align the mask and logprobs
        loss_mask = _roll_back(loss_mask_tok)
        if cfg.mask_too_long_tokens and "seq_no_eos_mask" in data:
            loss_mask[np.asarray(data["seq_no_eos_mask"], bool)] = 0.0

        prox_tok = data.pop("prox_logp", None)
        if not cfg.use_decoupled_loss and cfg.recompute_logprob:
            if prox_tok is None:
                raise ValueError("recompute_logprob=True but prox_logp missing")
            old_logp = _roll_back(np.asarray(prox_tok, np.float32))
            prox = old_logp
        else:
            old_logp = _roll_back(np.asarray(data["logprobs"], np.float32))
            prox = _roll_back(np.asarray(prox_tok, np.float32)) if prox_tok is not None else None

        ref_tok = data.pop("ref_logp", None)
        ref_logp = (
            _roll_back(np.asarray(ref_tok, np.float32)) if ref_tok is not None else np.zeros_like(old_logp)
        )
        old_logp = old_logp * loss_mask
        ref_logp = ref_logp * loss_mask

        # 3. KL-regularized token rewards; the task reward lands on the last
        #    generated label position
        seqlens = attn.sum(-1).astype(np.int64)
        if "seq_no_eos_mask" in data:
            seq_no_eos = np.asarray(data["seq_no_eos_mask"], bool).reshape(B)
        else:
            seq_no_eos = seqlens == L
        kl = F.approx_kl(
            torch.from_numpy(old_logp), torch.from_numpy(ref_logp), cfg.kl_estimator
        ).numpy()
        rewards = -cfg.kl_ctl * kl
        kl_rewards = rewards.copy()
        bidx = np.arange(B)
        rewards[bidx, seqlens - 1] = 0.0
        last_label = np.clip(seqlens - 2, 0, None)
        if cfg.mask_no_eos_with_zero:
            rewards[bidx, last_label] += np.where(seq_no_eos, 0.0, reward_score)
        else:
            rewards[bidx, last_label] += reward_score

        # 4. masked GAE (values are token-aligned; zeros for pure GRPO)
        values = np.asarray(data.get("values", np.zeros_like(rewards)), np.float32).reshape(B, L)
        advantages = np.zeros((B, L), np.float32)
        nextvalues = values[:, L - 1] * seq_no_eos
        lastgaelam = np.zeros(B, np.float32)
        for t in range(L - 2, -1, -1):
            delta = rewards[:, t] + cfg.gamma * nextvalues - values[:, t]
            newgaelam = delta + cfg.gamma * cfg.lam * lastgaelam
            m = loss_mask[:, t]
            nextvalues = nextvalues * (1 - m) + values[:, t] * m
            lastgaelam = lastgaelam * (1 - m) + newgaelam * m
            advantages[:, t] = lastgaelam
        data["returns"] = advantages + values

        if self.adv_norm is not None:
            advantages = self.adv_norm(advantages, loss_mask > 0)

        # 5. store the label-aligned training keys
        data["advantages"] = advantages.astype(np.float32)
        data["kl_rewards"] = kl_rewards
        data["tot_rewards"] = rewards
        data["loss_mask"] = loss_mask
        data["old_logprobs"] = old_logp
        if prox is not None:
            data["prox_logprobs"] = prox * loss_mask
        elif cfg.use_decoupled_loss and cfg.prox_logp_mode == "loglinear":
            data["prox_alpha"] = self._prox_alpha(data, loss_mask)
        if "versions" in data:
            # per-token version lag (label-aligned); -1 marks untagged
            # (prompt) positions
            v_theta = int(self.engine.get_version())
            versions_lbl = _roll_back(np.asarray(data["versions"], np.int64))
            lag = np.where(versions_lbl >= 0, v_theta - versions_lbl, -1)
            data["version_lag"] = np.clip(lag, -1, 2**31 - 1).astype(np.int32)
        data.pop("logprobs", None)
        return data

    def _prox_alpha(self, data: TensorDict, loss_mask: np.ndarray) -> np.ndarray:
        """Per-token factor of the log-linear proximal approximation:
        alpha = clip((v_prox - v_behave) / (v_theta - v_behave), 0, 1) on
        generated tokens."""
        versions = _roll_back(np.asarray(data["versions"], np.int64))
        v_theta = float(self.engine.get_version())
        v_prox = v_theta - 1.0
        v_behave = versions.astype(np.float32)
        diff = v_theta - v_behave
        generated = versions >= 0
        alpha = np.where(
            generated & (diff > 0), (v_prox - v_behave) / np.maximum(diff, 1e-9), 0.0
        )
        return (np.clip(alpha, 0.0, 1.0) * loss_mask).astype(np.float32)

    # -- update ------------------------------------------------------------
    def ppo_update(self, data: TensorDict) -> list[dict[str, float]]:
        """``ppo_n_minibatches`` optimizer steps over a balanced split of the
        batch; returns each minibatch's ``train_batch`` stats."""
        cfg = self.config
        data = dict(data)
        reward_score = np.asarray(data.get("rewards", np.zeros(1)), np.float32)
        attn = np.asarray(data["attention_mask"], bool)
        lm = np.asarray(data["loss_mask"], np.float32)
        with stats_tracker.scope("ppo_actor"):
            stats_tracker.get().scalar(
                task_reward=float(reward_score.mean()),
                correct_ratio=float((reward_score > 0).mean()),
                seq_len=float(attn.sum(-1).mean()),
                prompt_len=float((attn.sum(-1) - lm.sum(-1)).mean()),
                no_eos_ratio=float(np.asarray(data.get("seq_no_eos_mask", np.zeros(1))).mean()),
                advantages=float((np.asarray(data["advantages"]) * lm).sum() / max(lm.sum(), 1)),
                final_reward=float(np.asarray(data["tot_rewards"]).sum(-1).mean()),
            )
        for key in ("rewards", "tot_rewards", "kl_rewards", "returns"):
            data.pop(key, None)
        mb_list = split_padded_tensor_dict_into_mb_list(
            data, MicroBatchSpec(n_mbs=cfg.ppo_n_minibatches)
        )
        all_stats = []
        for mb in mb_list.mbs:
            train_stat = self.engine.train_batch(
                mb,
                loss_fn=self._loss_fn,
                loss_weight_fn=lambda x: float((np.asarray(x["loss_mask"]) > 0).sum()),
            )
            with stats_tracker.scope("ppo_actor"):
                stats_tracker.get().scalar(**train_stat)
            all_stats.append(train_stat)
        return all_stats
