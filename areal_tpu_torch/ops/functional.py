"""PPO-family loss math in PyTorch: the port of ``areal_tpu/ops/functional.py``.

Elementwise torch on padded [B, L] batches; ``loss_mask`` is the shifted
(label-aligned) mask. Where the JAX version stops gradients
(``jax.lax.stop_gradient``) this one detaches, so autograd gives the same
gradients as ``jax.grad``.
"""

from __future__ import annotations

import torch

# ---------------------------------------------------------------------------
# normalization / KL
# ---------------------------------------------------------------------------


def masked_normalization(
    x: torch.Tensor,
    mask: torch.Tensor | None = None,
    dim=None,
    unbiased: bool = False,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Whiten ``x`` over ``dim`` (default: all) counting only masked entries."""
    x = x.float()
    if dim is None:
        dim = tuple(range(x.dim()))
    dims = dim if isinstance(dim, tuple) else (dim,)
    if mask is None:
        factor = torch.tensor(1.0, device=x.device)
        for d in dims:
            factor = factor * x.shape[d]
        xm = x
    else:
        mask = mask.float()
        xm = x * mask
        factor = mask.sum(dim=dims, keepdim=True)
    x_sum = xm.sum(dim=dims, keepdim=True)
    x_sum_sq = xm.square().sum(dim=dims, keepdim=True)
    mean = x_sum / factor
    var = x_sum_sq / factor - mean.square()
    if unbiased:
        var = var * factor / torch.clamp(factor - 1, min=1)
    return (x - mean) / (torch.sqrt(torch.clamp(var, min=0.0)) + eps)


def approx_kl(
    log_probs: torch.Tensor,
    log_probs_base: torch.Tensor,
    estimator: str = "k1",
    apply_clamp: bool = True,
) -> torch.Tensor:
    """Schulman's k1/k2/k3 KL estimators."""
    log_ratio = log_probs.float() - log_probs_base.float()
    if estimator == "k1":
        kl = log_ratio
    elif estimator == "k2":
        kl = 0.5 * log_ratio.square()
    elif estimator == "k3":
        kl = torch.expm1(-log_ratio) + log_ratio
    else:
        raise ValueError(f"invalid KL estimator {estimator!r} (k1|k2|k3)")
    if apply_clamp:
        kl = torch.clamp(kl, -10.0, 10.0)
    return kl


# ---------------------------------------------------------------------------
# GAE
# ---------------------------------------------------------------------------


def gae(
    rewards: torch.Tensor,  # [B, L]
    values: torch.Tensor,  # [B, L]
    loss_mask: torch.Tensor,  # [B, L] shifted mask
    seq_no_eos_mask: torch.Tensor,  # [B] True if the sequence hit the cap
    gamma: float = 1.0,
    lam: float = 1.0,
) -> torch.Tensor:
    """Masked generalized advantage estimation, the reverse recursion over
    time: padding positions carry the state through unchanged. The last
    position's advantage is 0."""
    B, L = rewards.shape
    loss_mask = loss_mask.float()
    nextvalues = values[:, L - 1] * seq_no_eos_mask.to(values.dtype)
    lastgaelam = torch.zeros(B, dtype=torch.float32, device=rewards.device)
    advantages = torch.zeros((B, L), dtype=torch.float32, device=rewards.device)
    for t in range(L - 2, -1, -1):
        delta = rewards[:, t] + gamma * nextvalues - values[:, t]
        newgaelam = delta + gamma * lam * lastgaelam
        m = loss_mask[:, t]
        nextvalues = nextvalues * (1 - m) + values[:, t] * m
        lastgaelam = lastgaelam * (1 - m) + newgaelam * m
        advantages[:, t] = lastgaelam
    return advantages


# ---------------------------------------------------------------------------
# sequence-level (GSPO) helpers
# ---------------------------------------------------------------------------


def _sequence_level_ratio_and_adv(
    log_ratio: torch.Tensor,  # [B, L]
    advantages: torch.Tensor,  # [B, L]
    loss_mask: torch.Tensor,  # [B, L] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """GSPO: per-sequence geometric-mean ratio and mean advantage,
    broadcast back to tokens."""
    lm = loss_mask.float()
    counts = torch.clamp(lm.sum(dim=1, keepdim=True), min=1.0)
    mean_log_ratio = (log_ratio * lm).sum(dim=1, keepdim=True) / counts
    ratio = torch.exp(mean_log_ratio) * lm
    adv = (advantages * lm).sum(dim=1, keepdim=True) / counts
    adv = adv * lm
    return ratio, adv.expand(advantages.shape) * lm


def compute_behave_imp_weight(
    proximal_logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    loss_mask: torch.Tensor,
    mode: str = "token_mask",
    cap: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decoupled-PPO behavior importance weight pi_prox / pi_behave with a
    cap; modes token|sequence x truncate|mask. Returns (weight, approx_kl,
    behave_mask)."""
    lm = loss_mask.bool()
    behave_kl = proximal_logprobs - old_logprobs
    if "sequence" in mode:
        w, _ = _sequence_level_ratio_and_adv(behave_kl, torch.zeros_like(behave_kl), lm)
    else:
        w = torch.exp(behave_kl)
    if cap is not None:
        if "truncate" in mode:
            w = torch.clamp(w, 0.0, cap)
        else:  # mask
            w = torch.where(w > cap, torch.zeros_like(w), w)
    w = torch.where(lm, w, torch.zeros_like(w))
    behave_mask = (w > 0) & lm
    behave_kl = torch.where(behave_mask, behave_kl, torch.zeros_like(behave_kl))
    return w, behave_kl, behave_mask


# ---------------------------------------------------------------------------
# actor losses
# ---------------------------------------------------------------------------


def ppo_actor_loss_fn(
    logprobs: torch.Tensor,  # pi_theta [B, L]
    proximal_logprobs: torch.Tensor,  # pi_prox
    old_logprobs: torch.Tensor,  # pi_behave
    advantages: torch.Tensor,
    loss_mask: torch.Tensor,
    eps_clip: float = 0.2,
    eps_clip_higher: float | None = None,
    c_clip: float | None = None,
    behave_imp_weight_cap: float | None = None,
    importance_sampling_level: str = "token",
    behave_imp_weight_mode: str = "token_mask",
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """PPO-clip policy loss with the decoupled behavior correction: token-
    level (PPO/GRPO) or sequence-level (GSPO) ratios, DAPO's asymmetric
    upper clip, dual-clip and the behave importance weight."""
    lm = loss_mask.bool()
    denom = torch.clamp(lm.sum(), min=1)
    advantages = advantages.detach()
    # proximal/old logprobs are data from earlier forward passes
    proximal_logprobs = proximal_logprobs.detach()
    old_logprobs = old_logprobs.detach()

    if importance_sampling_level == "sequence":
        log_ratio = logprobs - proximal_logprobs
        ratio, advantages = _sequence_level_ratio_and_adv(log_ratio, advantages, lm)
    elif importance_sampling_level == "token":
        ratio = torch.where(lm, torch.exp(logprobs - proximal_logprobs), torch.zeros_like(logprobs))
    else:
        raise ValueError(f"invalid importance_sampling_level {importance_sampling_level!r}")

    hi = eps_clip if eps_clip_higher is None else eps_clip_higher
    clipped_ratio = torch.clamp(ratio, 1.0 - eps_clip, 1.0 + hi)
    pg_loss1 = -advantages * ratio
    pg_loss2 = -advantages * clipped_ratio
    clip_mask = pg_loss1.detach() < pg_loss2.detach()
    pg_loss = torch.maximum(pg_loss1, pg_loss2)
    if c_clip is not None:
        if c_clip <= 1.0:
            raise ValueError(f"c_clip={c_clip} must be > 1")
        pg_loss3 = torch.sign(advantages) * c_clip * advantages
        dual_clip_mask = pg_loss3.detach() < pg_loss.detach()
        pg_loss = torch.minimum(pg_loss, pg_loss3)
    else:
        dual_clip_mask = torch.zeros_like(clip_mask)

    stat: dict[str, torch.Tensor] = {}
    if behave_imp_weight_mode != "disabled":
        w, behave_kl, behave_mask = compute_behave_imp_weight(
            proximal_logprobs,
            old_logprobs,
            lm,
            mode=behave_imp_weight_mode,
            cap=behave_imp_weight_cap,
        )
        pg_loss = pg_loss * w.detach()
        stat.update(
            behave_approx_kl=behave_kl.detach(),
            behave_imp_weight=w.detach(),
            behave_mask=behave_mask,
        )

    loss = torch.where(lm, pg_loss, torch.zeros_like(pg_loss)).sum() / denom
    stat.update(
        loss=pg_loss.detach(),
        importance_weight=ratio.detach(),
        approx_kl=(logprobs - proximal_logprobs).detach(),
        clip_mask=clip_mask & lm,
        dual_clip_mask=dual_clip_mask & lm,
    )
    return loss, stat


def sapo_loss_fn(
    logprobs: torch.Tensor,
    old_logprobs: torch.Tensor,
    advantages: torch.Tensor,
    loss_mask: torch.Tensor,
    tau_pos: float = 1.0,
    tau_neg: float = 1.05,
    importance_sampling_level: str = "token",
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """SAPO: asymmetric sigmoid gates in place of hard clipping."""
    if tau_pos <= 0 or tau_neg <= 0:
        raise ValueError("SAPO temperatures must be positive")
    lm = loss_mask.bool()
    denom = torch.clamp(lm.sum(), min=1)
    advantages = advantages.detach()
    old_logprobs = old_logprobs.detach()
    log_ratio = logprobs - old_logprobs

    if importance_sampling_level == "sequence":
        ratio, advantages = _sequence_level_ratio_and_adv(log_ratio, advantages, lm)
    elif importance_sampling_level == "token":
        ratio = torch.exp(log_ratio)
    else:
        raise ValueError(f"invalid importance_sampling_level {importance_sampling_level!r}")

    gate_pos = torch.sigmoid(tau_pos * (ratio - 1.0)) * (4.0 / tau_pos)
    gate_neg = torch.sigmoid(tau_neg * (ratio - 1.0)) * (4.0 / tau_neg)
    soft_gate = torch.where(advantages > 0, gate_pos, gate_neg)

    pg_loss = -soft_gate * advantages
    loss = torch.where(lm, pg_loss, torch.zeros_like(pg_loss)).sum() / denom
    stat = dict(
        loss=pg_loss.detach(),
        importance_weight=ratio.detach(),
        approx_kl=log_ratio.detach(),
        clip_mask=torch.zeros_like(lm),
        dual_clip_mask=torch.zeros_like(lm),
        sapo_soft_gate=soft_gate.detach(),
    )
    return loss, stat


def ppo_critic_loss_fn(
    value: torch.Tensor,
    old_value: torch.Tensor,
    target_value: torch.Tensor,
    loss_mask: torch.Tensor,
    value_eps_clip: float = 0.5,
    loss_fn_type: str = "mse",
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Clipped value loss (mse or huber)."""
    if loss_fn_type == "mse":

        def err(v):
            return 0.5 * (v - target_value).square()

    elif loss_fn_type == "huber":
        delta = 10.0

        def err(v):
            d = (v - target_value).abs()
            return torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))

    else:
        raise NotImplementedError(loss_fn_type)

    loss_orig = err(value)
    value_clipped = old_value + torch.clamp(value - old_value, -value_eps_clip, value_eps_clip)
    loss_clip = err(value_clipped)
    value_loss = torch.maximum(loss_orig, loss_clip)
    lm = loss_mask.bool()
    clip_mask = (loss_clip.detach() > loss_orig.detach()) & lm
    loss = torch.where(lm, value_loss, torch.zeros_like(value_loss)).sum() / torch.clamp(lm.sum(), min=1)
    return loss, dict(loss=value_loss.detach(), clip_mask=clip_mask)


# ---------------------------------------------------------------------------
# M2PO second-moment masking
# ---------------------------------------------------------------------------


def m2po_loss_mask(
    old_logp: torch.Tensor,
    prox_logp: torch.Tensor,
    loss_mask: torch.Tensor,
    m2_threshold: float,
) -> torch.Tensor:
    """Drop the highest-(logp delta)^2 tokens until the mean second moment
    of the survivors is below ``m2_threshold`` (sort / cumsum, as the JAX
    version)."""
    lm = loss_mask.bool().reshape(-1)
    m2 = (old_logp - prox_logp).square().reshape(-1)
    n = lm.numel()
    n_valid = lm.sum()

    # invalid tokens sort to the end (m2 >= 0 for valid ones)
    key = torch.where(lm, m2, torch.full_like(m2, -1.0))
    order = torch.argsort(-key, stable=True)  # descending; invalid last
    sorted_m2 = key[order]

    idx = torch.arange(n, device=lm.device)
    valid_sorted = idx < n_valid
    vals = torch.where(valid_sorted, sorted_m2, torch.zeros_like(sorted_m2))
    total = vals.sum()
    prefix = torch.cumsum(vals, dim=0) - vals  # sum of the entries before i
    suffix = total - prefix
    counts = torch.clamp(n_valid - idx, min=1)
    avg_suffix = suffix / counts
    below = valid_sorted & (avg_suffix < m2_threshold)
    num_to_mask = torch.where(
        below.any(), torch.argmax(below.to(torch.int32)), torch.clamp(n_valid - 1, min=0)
    )

    keep_sorted = (idx >= num_to_mask) & valid_sorted
    keep = torch.zeros(n, dtype=torch.bool, device=lm.device)
    keep[order] = keep_sorted
    return (keep & lm).reshape(loss_mask.shape)


# ---------------------------------------------------------------------------
# reward shaping
# ---------------------------------------------------------------------------


def reward_overlong_penalty(
    rewards: torch.Tensor,  # [B]
    response_lengths: torch.Tensor,  # [B]
    overlong_tokens: int,
    overlong_penalty_factor: float,
    max_response_length: int,
) -> torch.Tensor:
    """DAPO soft length penalty."""
    expected = max_response_length - overlong_tokens
    exceed = response_lengths.float() - expected
    penalty = torch.clamp(-exceed / overlong_tokens * overlong_penalty_factor, max=0.0)
    return rewards + penalty
