"""Plain reference of the training objective and optimizer: MONAI's
DiceFocal loss on sigmoid logits, and AdamW with decoupled weight decay
(p <- p - lr (m_hat / (sqrt(v_hat) + eps) + wd p)), no decay on biases,
on tensors of at most one dimension and on the names a configuration lists
as `no_decay`."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dice_focal(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """mean over (sample, channel) of 1 - 2 |p t| / (|p| + |t| + 1e-5), plus
    the mean of BCE (1 - p_t)^2; p = sigmoid(logits)."""
    p = torch.sigmoid(logits)
    dims = tuple(range(2, p.ndim))
    dice = 1.0 - 2.0 * (p * targets).sum(dims) / (p.sum(dims) + targets.sum(dims) + 1e-5)
    ce = F.binary_cross_entropy_with_logits(logits, targets, reduction="none")
    p_t = p * targets + (1 - p) * (1 - targets)
    return dice.mean() + (ce * (1 - p_t) ** 2).mean()


class AdamW:
    """AdamW over a model's named parameters, with its moments in f32."""

    def __init__(self, named_params, lr: float, weight_decay: float, betas, eps: float,
                 no_decay):
        self.params = [(n, p) for n, p in named_params if p.requires_grad]
        self.lr, self.wd, self.betas, self.eps = lr, weight_decay, tuple(betas), eps
        leaf = lambda n: n.rsplit(".", 1)[-1]  # noqa: E731
        self.decay = {n: not (leaf(n) in no_decay or leaf(n).endswith("bias") or p.ndim <= 1)
                      for n, p in self.params}
        self.m = {n: torch.zeros_like(p) for n, p in self.params}
        self.v = {n: torch.zeros_like(p) for n, p in self.params}
        self.t = 0

    @torch.no_grad()
    def step(self) -> None:
        self.t += 1
        b1, b2 = self.betas
        for n, p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.m[n].mul_(b1).add_((1 - b1) * g)
            self.v[n].mul_(b2).add_((1 - b2) * g * g)
            m_hat = self.m[n] / (1 - b1 ** self.t)
            v_hat = self.v[n] / (1 - b2 ** self.t)
            upd = m_hat / (v_hat.sqrt() + self.eps)
            if self.decay[n]:
                upd = upd + self.wd * p
            p.sub_(self.lr * upd)
