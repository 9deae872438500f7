"""DReG (doubly-reparameterized gradient) support (counterpart of
``multivae_tpu/ops/dreg.py``).

``scale_grad`` is the identity in the forward pass and multiplies the
incoming gradient by the importance weights ``w`` in the backward pass:
the reference's ``register_hook`` on the latent samples, as an autograd
Function.
"""

from __future__ import annotations

import torch


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(w)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        # keep the cotangent in its own dtype (w may be f32 under bf16)
        return (g * w).to(g.dtype), None


def scale_grad(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Identity on ``x``; backward multiplies the cotangent by ``w``.

    ``w`` must broadcast against ``x`` and receives no gradient.
    """
    return _ScaleGrad.apply(x, w)
