"""Token sampling for autoregressive generation (twin of
``lumen_tpu/ops/sampling.py``): greedy, repetition penalty, temperature
and nucleus (top-p) sampling.

Random numbers come from a ``torch.Generator``; the categorical draw is
the Gumbel-max trick, as ``jax.random.categorical`` computes it, and
``gumbel`` lets a caller (the tests) hand both frameworks the same noise.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """[..., V] -> [...] argmax token ids."""
    return torch.argmax(logits, dim=-1)


def _per_sample(value, logits: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or per-sample [...] param against [..., V]."""
    v = torch.as_tensor(value, dtype=torch.float32, device=logits.device)
    if v.dim() == logits.dim() - 1 and v.dim() > 0:
        v = v[..., None]
    return v


def apply_repetition_penalty(logits, token_mask, penalty):
    """CTRL-style penalty over tokens already seen (``token_mask`` [..., V]
    bool): positive logits divided, negative multiplied. ``penalty`` is a
    scalar or per-sample [B]."""
    penalty = _per_sample(penalty, logits)
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(token_mask, penalized, logits)


def top_p_filter(logits, top_p):
    """Nucleus filtering: keep the smallest prefix of sorted tokens whose
    cumulative probability reaches ``top_p`` (the top-1 token always);
    the rest get -inf."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    sorted_probs = torch.softmax(sorted_logits, dim=-1)
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cumulative - sorted_probs) < _per_sample(top_p, logits)
    keep_sorted[..., 0] = True
    threshold = torch.where(keep_sorted, sorted_logits, torch.inf).amin(dim=-1, keepdim=True)
    return torch.where(logits >= threshold, logits, -torch.inf)


def sample(
    logits: torch.Tensor,
    temperature=1.0,
    top_p=1.0,
    do_sample=True,
    generator: "torch.Generator | None" = None,
    gumbel: "torch.Tensor | None" = None,
    any_sample: "bool | None" = None,
) -> torch.Tensor:
    """Temperature + top-p categorical sampling; greedy where ``do_sample``
    is False or temperature ~ 0. Params are scalars or per-sample [B].
    When no row samples, only the argmax is computed; ``any_sample`` is
    the caller's host-side knowledge of that, which spares a device sync
    (None: read it from the tensors)."""
    greedy_ids = greedy(logits)
    temp = torch.as_tensor(temperature, dtype=torch.float32, device=logits.device)
    use_sample = torch.as_tensor(do_sample, device=logits.device) & (temp > 1e-6)
    if any_sample is None:
        any_sample = bool(use_sample.any())
    if not any_sample:
        return greedy_ids
    scaled = logits.float() / torch.clamp(_per_sample(temperature, logits), min=1e-6)
    filtered = top_p_filter(scaled, top_p)
    if gumbel is None:
        u = torch.rand(filtered.shape, generator=generator, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    sampled_ids = torch.argmax(filtered + gumbel, dim=-1)
    return torch.where(use_sample, sampled_ids, greedy_ids)
