"""AdamW with warmup and decay, global-norm clipping and gradient
accumulation.

Counterpart of ``make_optimizer`` in ``spokennlp_tpu/train/optim.py``, which
chains optax's ``clip_by_global_norm``, ``adamw`` (decay masked off biases,
LayerNorm scales and ``*_ln`` modules) and ``MultiSteps``. Here that is
``torch.optim.AdamW`` over two parameter groups, a ``LambdaLR`` for the
schedule, and the clipping and accumulation written out with optax's
semantics:

- the update is clipped when the global norm is >= max_norm, scaled by
  max_norm / norm (no epsilon);
- with k > 1 accumulation steps the optimizer steps on the mean of k
  micro-batch gradients, every k-th call;
- the learning rate of the n-th optimizer step (n from 0) is the schedule at n.

Also the counterparts of ``noam_schedule`` (the PALM title-generation
recipe's schedule) and ``make_module_lr_optimizer`` (optax's
``multi_transform`` over per-module learning-rate groups).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import torch
from torch import nn

from spokennlp_tpu_torch.configs import TrainConfig


def linear_warmup_schedule(base_lr: float, total_steps: int,
                           warmup_steps: int = 0) -> Callable[[int], float]:
    """Linear warmup from 0 to ``base_lr`` over ``warmup_steps``, then linear
    decay to 0 at ``total_steps`` (optax's linear schedules, clipped)."""

    def schedule(step: int) -> float:
        if warmup_steps > 0 and step < warmup_steps:
            return base_lr * step / warmup_steps
        t = step - warmup_steps if warmup_steps > 0 else step
        n = max(total_steps - warmup_steps, 1) if warmup_steps > 0 else max(total_steps, 1)
        return base_lr * (1.0 - min(t, n) / n)

    return schedule


def noam_schedule(model_size: int, factor: float, warmup_steps: int) -> Callable[[int], float]:
    """Noam learning rate: factor * model_size^-0.5 * min(s^-0.5, s *
    warmup_steps^-1.5) at s = step + 1."""

    def schedule(step: int) -> float:
        s = step + 1
        return factor * model_size ** (-0.5) * min(s ** (-0.5), s * warmup_steps ** (-1.5))

    return schedule


def decays(name: str) -> bool:
    """Weight decay applies to every parameter but biases, LayerNorm scales
    and the parameters of ``LayerNorm`` / ``*_ln`` modules (BERT convention;
    the names are the Flax tree's)."""
    parts = name.split(".")
    if parts[-1] in ("bias", "scale") or "LayerNorm" in parts:
        return False
    return not any(p.endswith("_ln") for p in parts)


class TrainOptimizer:
    """The optimizer the train step drives: ``step(grads)`` takes one
    micro-batch's gradients (a list matching ``params``)."""

    def __init__(self, params: Sequence[nn.Parameter], names: Sequence[str], cfg: TrainConfig,
                 total_steps: int):
        self.params = list(params)
        self.max_grad_norm = cfg.max_grad_norm
        self.accumulation_steps = max(cfg.gradient_accumulation_steps, 1)
        decay = [p for p, n in zip(self.params, names) if decays(n)]
        no_decay = [p for p, n in zip(self.params, names) if not decays(n)]
        self.optimizer = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.weight_decay},
             {"params": no_decay, "weight_decay": 0.0}],
            lr=cfg.learning_rate, betas=(cfg.adam_beta1, cfg.adam_beta2), eps=cfg.adam_eps,
        )
        warmup = int(cfg.warmup_ratio * total_steps)
        self.schedule = linear_warmup_schedule(cfg.learning_rate, total_steps, warmup)
        base = cfg.learning_rate
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda n: self.schedule(n) / base if base else 0.0
        )
        self.micro_step = 0
        self._acc: List[torch.Tensor] = []

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> bool:
        """Accumulate one micro-batch's gradients; on every k-th call clip
        their mean and take an AdamW step. Returns whether it stepped."""
        k = self.accumulation_steps
        if k > 1:
            if self.micro_step % k == 0:
                self._acc = [g.detach().clone() for g in grads]
            else:
                torch._foreach_add_(self._acc, list(grads))
            self.micro_step += 1
            if self.micro_step % k:
                return False
            grads = torch._foreach_div(self._acc, float(k))
        else:
            self.micro_step += 1
        clip_by_global_norm_(grads, self.max_grad_norm)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.scheduler.step()
        self._acc = []
        return True

    def state_dict(self) -> Dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "micro_step": self.micro_step}

    def load_state_dict(self, state: Dict):
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        self.micro_step = state["micro_step"]


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(sum of squares) over all gradients, in float32."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([g.float() for g in grads])))


def clip_by_global_norm_(grads: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm / norm when norm >= max_norm
    (optax's clip_by_global_norm); returns the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(list(grads), scale)
    return norm


def make_optimizer(model: nn.Module, cfg: TrainConfig, total_steps: int) -> TrainOptimizer:
    """AdamW + schedule + clipping + accumulation over the model's trainable
    parameters."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return TrainOptimizer([p for _, p in named], [n for n, _ in named], cfg, total_steps)


def module_lr_groups(names: Sequence[str], module_lrs: Mapping[str, float]) -> List[str]:
    """The group of each parameter name: the first of ``module_lrs``'s keys,
    in sorted order, that is a substring of the name's Flax path (its parts
    joined by "/", as optax's ``multi_transform`` label sees it), else
    ``"__base__"``."""
    keys = sorted(module_lrs)
    groups = []
    for name in names:
        path = name.replace(".", "/")
        groups.append(next((k for k in keys if k in path), "__base__"))
    return groups


def make_module_lr_optimizer(named_params: Sequence[Tuple[str, nn.Parameter]], base_lr: float,
                             module_lrs: Mapping[str, float], weight_decay: float = 0.0,
                             b1: float = 0.9, b2: float = 0.999,
                             eps: float = 1e-8) -> torch.optim.Optimizer:
    """Adam (AdamW when ``weight_decay``, decaying every parameter, as
    optax's ``adamw`` without a mask) with one learning rate a module group:
    a parameter whose path holds a key of ``module_lrs`` takes that key's
    rate (``module_lr_groups``), the rest ``base_lr``. The reference's
    cross-encoder group (mmvts/src/main_multimodal.py:695-705)."""
    named = list(named_params)
    groups: Dict[str, List[nn.Parameter]] = {}
    for (_, p), g in zip(named, module_lr_groups([n for n, _ in named], module_lrs)):
        groups.setdefault(g, []).append(p)
    lrs = {"__base__": base_lr, **module_lrs}
    return torch.optim.AdamW(
        [{"params": ps, "lr": lrs[g]} for g, ps in groups.items()],
        lr=base_lr, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
    )
