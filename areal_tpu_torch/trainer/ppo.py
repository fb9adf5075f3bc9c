"""PPO-family algorithm layer: advantages, the loss dispatch and the update
loops — the port of ``areal_tpu/trainer/ppo.py`` (``grpo_loss_fn``,
``PPOActor``, ``critic_loss_fn``, ``PPOCritic``).

Host-side data is token-aligned ([b, t] refers to token t: rollout
logprobs, ``forward_batch`` outputs); ``compute_advantages`` converts the
per-token training keys to label alignment with roll(-1), because the train
engine's outputs are label-aligned. The log-linear proximal approximation's
factor ``prox_alpha`` is computed on the host from the per-token versions.

``ppo_update`` records the JAX actor's ``stats_tracker`` scalars under
``ppo_actor/`` (the batch's reward, lengths and advantages, then each
minibatch's training stats), which ``PPOTrainer`` commits every step.

The learning-health observatory: with ``version_lag`` in the batch,
``grpo_loss_fn`` adds per-lag-bucket loss stats (``lag_{bucket}/*``,
masked reductions on the device that ride the engine's one transfer per
step; ``_finalize_lag_stats`` turns them into ratios after the engine's
microbatch fold); with the engine's segment map it adds per-sequence
``seq__*`` sums. ``ppo_update`` exports the buckets as the
``areal_train_lag_*{lag_bucket}`` metrics and joins each trajectory's
clip fraction and behave KL onto its lineage record
(``observability/lineage.py``).

The critic (``PPOCritic``, ``ppo.py:686-750``) runs over an engine built
with ``value_head=True``: ``compute_values`` is its token-aligned forward,
and ``ppo_update`` trains the clipped value loss on the batch that
``compute_advantages`` returned (``values`` and ``returns`` become
``old_values`` and ``target_values``), its stats under ``ppo_critic/``.
"""

from __future__ import annotations

import numpy as np
import torch

from areal_tpu_torch.api.config import PPOActorConfig, PPOCriticConfig
from areal_tpu_torch.infra.staleness_manager import LAG_BUCKET_LABELS
from areal_tpu_torch.observability import catalog as obs_catalog
from areal_tpu_torch.observability import lineage as lineage_mod
from areal_tpu_torch.ops import functional as F
from areal_tpu_torch.utils import stats_tracker
from areal_tpu_torch.utils.data import (
    MicroBatchSpec,
    Normalization,
    TensorDict,
    split_padded_tensor_dict_into_mb_list,
)
from areal_tpu_torch.utils.data import roll_to_label_alignment as _roll_back


def _lag_bucket_stats(version_lag: torch.Tensor, lmf: torch.Tensor, denom: torch.Tensor, stat: dict) -> dict:
    """Staleness-conditioned loss diagnostics (``ppo.py:43``): per-lag-bucket
    clip fraction, approx-KL, behave importance weight, cap-hit tail and
    token share, as masked reductions over the packed grid. All outputs are
    scalars, so they ride the engine's one device -> host transfer per step.

    The identity: for clip_ratio and approx_kl, the token-share-weighted
    sum over the buckets is the batch-wide scalar; the behave stats
    recompose through ``behave_share``. The buckets partition the valid
    tokens; unknown lags (< 0) fall into "0".

    Every output is normalized by the same ``denom`` (the microbatch's
    valid tokens, also the engine's fold weight), so the engine's weighted
    fold recombines them exactly across a ``max_tokens_per_mb`` split; the
    per-bucket ratios are quotients of these, taken on the host after the
    fold (``_finalize_lag_stats``)."""
    lag = torch.clamp(version_lag, min=0)
    # the edges of staleness_manager.lag_bucket_index (0 / 1 / 2 / 4+)
    bucket = torch.where(lag >= 4, 3, torch.where(lag >= 2, 2, torch.where(lag >= 1, 1, 0)))
    clip_f = stat["clip_mask"].float()
    behave = "behave_mask" in stat
    if behave:
        behave_f = stat["behave_mask"].float()
        imp_w = stat["behave_imp_weight"].detach()
        bkl = stat["behave_approx_kl"].detach()
    akl = stat["approx_kl"].detach()
    out: dict[str, torch.Tensor] = {}
    for i, label in enumerate(LAG_BUCKET_LABELS):
        bm = lmf * (bucket == i)
        out[f"lag_{label}/token_share"] = bm.sum() / denom
        out[f"lag_{label}/clip_frac"] = (clip_f * bm).sum() / denom
        out[f"lag_{label}/kl_frac"] = (akl * bm).sum() / denom
        if behave:
            bb = behave_f * bm  # uncapped tokens in this bucket
            out[f"lag_{label}/behave_frac"] = bb.sum() / denom
            out[f"lag_{label}/imp_weight_frac"] = (imp_w * bb).sum() / denom
            out[f"lag_{label}/behave_kl_frac"] = (bkl * bb).sum() / denom
            # the magnitude twin of the signed mean above: the signed one
            # recomposes the batch scalar, the absolute one is the drift
            # signal the metrics export
            out[f"lag_{label}/behave_abs_kl_frac"] = (torch.abs(bkl) * bb).sum() / denom
            out[f"lag_{label}/cap_frac"] = (bm - bb).sum() / denom
    return out


def _finalize_lag_stats(stats: dict[str, float]) -> dict[str, float]:
    """The host half of ``_lag_bucket_stats`` (``ppo.py:110``): turn the
    fold-safe ``*_frac`` stats into the per-bucket ratios (clip_ratio,
    approx_kl, behave_*, cap_hit_share) after the engine's fold, so each
    quotient's numerator and denominator folded exactly. The batch-wide
    behave scalars are re-derived from the bucket pieces (which partition
    the behave mask), so the identity closes on both sides. The internal
    ``*_frac`` keys are consumed; a no-op without the lag families."""
    if "lag_0/token_share" not in stats:
        return stats
    out = dict(stats)
    behave_total = sum(out.get(f"lag_{label}/behave_frac", 0.0) for label in LAG_BUCKET_LABELS)
    if behave_total > 0:
        out["behave_approx_kl"] = (
            sum(out.get(f"lag_{label}/behave_kl_frac", 0.0) for label in LAG_BUCKET_LABELS) / behave_total
        )
        out["behave_imp_weight"] = (
            sum(out.get(f"lag_{label}/imp_weight_frac", 0.0) for label in LAG_BUCKET_LABELS) / behave_total
        )
    for label in LAG_BUCKET_LABELS:
        share = out[f"lag_{label}/token_share"]
        d = share if share > 0 else 1.0
        out[f"lag_{label}/clip_ratio"] = out.pop(f"lag_{label}/clip_frac", 0.0) / d
        out[f"lag_{label}/approx_kl"] = out.pop(f"lag_{label}/kl_frac", 0.0) / d
        if f"lag_{label}/behave_frac" in out:
            bfrac = out.pop(f"lag_{label}/behave_frac")
            bd = bfrac if bfrac > 0 else 1.0
            out[f"lag_{label}/behave_imp_weight"] = out.pop(f"lag_{label}/imp_weight_frac", 0.0) / bd
            out[f"lag_{label}/behave_approx_kl"] = out.pop(f"lag_{label}/behave_kl_frac", 0.0) / bd
            out[f"lag_{label}/behave_abs_kl"] = out.pop(f"lag_{label}/behave_abs_kl_frac", 0.0) / bd
            out[f"lag_{label}/behave_share"] = bfrac / (behave_total if behave_total > 0 else 1.0)
            out[f"lag_{label}/cap_hit_share"] = out.pop(f"lag_{label}/cap_frac", 0.0) / d
    return out


def _per_sequence_stats(b: dict, lmf: torch.Tensor, stat: dict) -> dict:
    """Per-trajectory loss attribution through the packed grid's segment map
    (``ppo.py:172``): ``seq_slot`` maps each cell to its grid-local
    sequence slot (-1 = padding, summed into a trash slot that is dropped),
    and the length of ``seq_slots`` is the slot count. ``index_add_`` into
    ``nseq + 1`` slots; the arrays ride the engine's one transfer per step,
    and the engine maps them back to the input's sequences
    (``last_seq_stats``) for the lineage ring."""
    nseq = b["seq_slots"].shape[0]
    slot = b["seq_slot"].reshape(-1).long()
    slot = torch.where(slot < 0, torch.full_like(slot, nseq), slot)

    def seg(x: torch.Tensor) -> torch.Tensor:
        x = x.detach().reshape(-1).float()
        return torch.zeros(nseq + 1, dtype=x.dtype, device=x.device).index_add_(0, slot, x)[:nseq]

    out = {
        "seq__tokens": seg(lmf),
        "seq__clipped": seg(stat["clip_mask"].float()),
    }
    if "behave_mask" in stat:
        bf = stat["behave_mask"].float()
        out["seq__behave_tokens"] = seg(bf)
        # absolute: the trajectory's drift magnitude
        out["seq__behave_kl_sum"] = seg(torch.abs(stat["behave_approx_kl"].detach()) * bf)
    return out


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
    # the learning-health observatory: staleness-conditioned stats and the
    # per-trajectory attribution the lineage ring joins on, emitted only
    # when the batch carries the host-prepared keys
    if "version_lag" in b:
        stats.update(_lag_bucket_stats(b["version_lag"], lmf, denom, stat))
    if "seq_slot" in b and "seq_slots" in b:
        stats.update(_per_sequence_stats(b, lmf, stat))
    return loss, stats


def _export_learning_health(all_stats: list[dict[str, float]], weights: list[float] | None = None) -> None:
    """Fold one update's minibatch stats into the ``areal_train_lag_*
    {lag_bucket}`` metrics (``ppo.py:298``): gauges carry this step's
    token-weighted view, counters accumulate token-weighted sums. The
    minibatches are weighted by their host loss weight (valid tokens, the
    weight the engine folds by), so a one-minibatch update recomposes the
    batch scalars exactly and the counters track the tokens trained."""
    keep = [
        (s, w)
        for s, w in zip(all_stats, weights if weights is not None else [s.get("n_valid_tokens", 0.0) for s in all_stats])
        if "lag_0/token_share" in s
    ]
    if not keep:
        return
    stats = [s for s, _ in keep]
    m = obs_catalog.learning_health_metrics()
    total_tokens = sum(w for _, w in keep) or 1.0
    for label in LAG_BUCKET_LABELS:
        tok = [w * s.get(f"lag_{label}/token_share", 0.0) for s, w in keep]
        ntok = sum(tok)
        d = max(ntok, 1.0)
        clip = sum(t * s.get(f"lag_{label}/clip_ratio", 0.0) for t, s in zip(tok, stats)) / d
        akl = sum(t * s.get(f"lag_{label}/approx_kl", 0.0) for t, s in zip(tok, stats)) / d
        m.token_share.labels(lag_bucket=label).set(ntok / total_tokens)
        m.clip_ratio.labels(lag_bucket=label).set(clip)
        m.approx_kl.labels(lag_bucket=label).set(akl)
        m.tokens_total.labels(lag_bucket=label).inc(ntok)
        m.clipped_total.labels(lag_bucket=label).inc(clip * ntok)
        if any(f"lag_{label}/behave_approx_kl" in s for s in stats):
            cap = sum(t * s.get(f"lag_{label}/cap_hit_share", 0.0) for t, s in zip(tok, stats)) / d
            btok = [t * (1.0 - s.get(f"lag_{label}/cap_hit_share", 0.0)) for t, s in zip(tok, stats)]
            nb = max(sum(btok), 1.0)
            bkl = sum(bt * s.get(f"lag_{label}/behave_abs_kl", 0.0) for bt, s in zip(btok, stats)) / nb
            biw = sum(bt * s.get(f"lag_{label}/behave_imp_weight", 0.0) for bt, s in zip(btok, stats)) / nb
            m.cap_hit.labels(lag_bucket=label).set(cap)
            m.behave_kl.labels(lag_bucket=label).set(bkl)
            m.imp_weight.labels(lag_bucket=label).set(biw)
            m.capped_total.labels(lag_bucket=label).inc(cap * ntok)
            m.behave_kl_sum.labels(lag_bucket=label).inc(bkl * sum(btok))


def _accumulate_lineage(
    acc: dict[int, dict[str, float]], lineage_ids: np.ndarray, seq_stats: dict[str, np.ndarray]
) -> None:
    """Fold one minibatch's per-sequence loss attribution (the engine's
    ``last_seq_stats``) onto lineage ids. A GRPO group's sequences share
    one lineage id, so this is also the group -> trajectory sum."""
    toks = seq_stats.get("seq__tokens")
    if toks is None:
        return
    clipped = seq_stats.get("seq__clipped")
    btok = seq_stats.get("seq__behave_tokens")
    bkl = seq_stats.get("seq__behave_kl_sum")
    for i, lid in enumerate(np.ravel(np.asarray(lineage_ids))):
        lid = int(lid)
        if lid < 0 or i >= len(toks):
            continue
        a = acc.setdefault(lid, {"tokens": 0.0, "clipped": 0.0, "behave_tokens": 0.0, "behave_kl_sum": 0.0})
        a["tokens"] += float(toks[i])
        if clipped is not None:
            a["clipped"] += float(clipped[i])
        if btok is not None:
            a["behave_tokens"] += float(btok[i])
        if bkl is not None:
            a["behave_kl_sum"] += float(bkl[i])


def _commit_lineage(acc: dict[int, dict[str, float]], version: int) -> None:
    """Join the update's per-trajectory loss stats onto the lineage ring:
    the train end of the generate -> journal -> consume -> update chain."""
    if not acc:
        return
    ring = lineage_mod.get_lineage()
    for lid, a in acc.items():
        ring.record_train(
            lid,
            version=version,
            tokens=a["tokens"],
            clip_fraction=a["clipped"] / max(a["tokens"], 1.0),
            behave_kl=a["behave_kl_sum"] / max(a["behave_tokens"], 1.0) if a["behave_tokens"] else None,
        )


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
        batch; returns each minibatch's ``train_batch`` stats (lag buckets
        finalized), exports the learning-health metrics and joins the
        trajectories' loss stats onto the lineage ring."""
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
        mb_weights = []
        consuming_version = int(self.engine.get_version())
        lineage_acc: dict[int, dict[str, float]] = {}
        for mb in mb_list.mbs:
            train_stat = _finalize_lag_stats(
                self.engine.train_batch(
                    mb,
                    loss_fn=self._loss_fn,
                    loss_weight_fn=lambda x: float((np.asarray(x["loss_mask"]) > 0).sum()),
                )
            )
            mb_weights.append(float((np.asarray(mb["loss_mask"]) > 0).sum()))
            seq_stats = getattr(self.engine, "last_seq_stats", None)
            if seq_stats and "lineage_id" in mb:
                _accumulate_lineage(lineage_acc, np.asarray(mb["lineage_id"]), seq_stats)
            with stats_tracker.scope("ppo_actor"):
                stats_tracker.get().scalar(**train_stat)
            all_stats.append(train_stat)
        _export_learning_health(all_stats, mb_weights)
        _commit_lineage(lineage_acc, consuming_version)
        return all_stats


def critic_loss_fn(outputs: dict, b: dict, cfg: PPOCriticConfig):
    """Packed-grid clipped value loss over the loss-masked, label-valid
    positions (``ppo.py:686``), with ``critic_loss`` and
    ``value_clip_ratio`` as its stats."""
    lm = (b["loss_mask"] > 0) & b["label_valid"]
    loss, stat = F.ppo_critic_loss_fn(
        value=outputs["values"],
        old_value=b["old_values"],
        target_value=b["target_values"],
        loss_mask=lm,
        value_eps_clip=cfg.eps_clip,
    )
    lmf = lm.float()
    denom = torch.clamp(lmf.sum(), min=1.0)
    return loss, {
        "critic_loss": (stat["loss"] * lmf).sum() / denom,
        "value_clip_ratio": stat["clip_mask"].float().sum() / denom,
    }


class PPOCritic:
    """Value-function trainer over a train engine with a value head."""

    def __init__(self, config: PPOCriticConfig, engine):
        self.config = config
        self.engine = engine
        cfg = config
        self._loss_fn = lambda outputs, b: critic_loss_fn(outputs, b, cfg)

    def compute_values(self, data: TensorDict) -> np.ndarray:
        """Token-aligned values: out[b, t] = V(prefix up to and including
        token t) (the no-grad forward: flash kernel K2 on a card)."""
        return self.engine.forward_batch(data, output_key="values")

    def ppo_update(self, data: TensorDict) -> list[dict[str, float]]:
        """``ppo_n_minibatches`` optimizer steps of the value loss; the
        loss weight is each minibatch's loss-mask tokens."""
        data = dict(data)
        # label-aligned targets: the value at position t predicts the return from t
        data["old_values"] = np.asarray(data.pop("values"), np.float32)
        data["target_values"] = np.asarray(data.pop("returns"), np.float32)
        # the actor's loss diagnostics and reward keys: no use to the critic
        for key in ("rewards", "tot_rewards", "kl_rewards", "versions", "version_lag", "lineage_id"):
            data.pop(key, None)
        mb_list = split_padded_tensor_dict_into_mb_list(data, MicroBatchSpec(n_mbs=self.config.ppo_n_minibatches))
        all_stats = []
        for mb in mb_list.mbs:
            train_stat = self.engine.train_batch(
                mb,
                loss_fn=self._loss_fn,
                loss_weight_fn=lambda x: float((np.asarray(x["loss_mask"]) > 0).sum()),
            )
            with stats_tracker.scope("ppo_critic"):
                stats_tracker.get().scalar(**train_stat)
            all_stats.append(train_stat)
        return all_stats
