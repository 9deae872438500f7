"""The train step's bfloat16 loss: the trainer's ``mixed_precision``
(JAX ``BaseTrainer`` ``loss_fn`` with ``_to_bf16``).

Inside ``bf16_parameters`` the model computes with bfloat16 copies of its
float32 parameters, cast from the live ones on entry and swapped in where
the modules hold them (a reparametrization, as ``torch.func.functional_call``
makes one; kept nowhere: a CUDA graph that captures a step reads the
parameters the optimizer updates in place), and the trainer hands the loss
the batch with its float leaves in bf16 (``data.batch.floats_to``) and
takes the loss back in float32. Every op of the loss then runs in bf16
where its inputs are bf16, as in the JAX mode, unlike ``torch.autocast``,
which casts at matmul and conv inputs only. Sums the models take in float32 (``sum_f32``) and
float32 arrays they mix in stay float32 by promotion in both packages.

One promotion differs: a Flax layer promotes its input and its parameters
to their common dtype (``flax.linen.dtypes.promote_dtype``), where
``F.linear`` and ``F.conv2d`` refuse mixed dtypes. Under the loss,
``PromoteMixed`` casts the float tensors of a matmul, convolution or norm
to their promoted dtype, so a bf16 layer meeting a float32 input (MHVAE's
levels, sampled from a float32 product of experts) or a float32 weight
(the MADE layers' ``kernel * mask``, mask float32) computes in float32 as
JAX does.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F
from torch import nn
from torch.overrides import TorchFunctionMode

# the functions whose float operands Flax (jnp.dot, lax.conv) promotes
_PROMOTED = {
    F.linear, F.bilinear, F.conv1d, F.conv2d, F.conv3d, F.conv_transpose1d,
    F.conv_transpose2d, F.conv_transpose3d, F.layer_norm, F.group_norm,
    torch.matmul, torch.mm, torch.bmm, torch.addmm, torch.baddbmm, torch.einsum,
    torch.Tensor.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
    torch.Tensor.mm, torch.Tensor.bmm,
}


class PromoteMixed(TorchFunctionMode):
    """Casts the float tensor arguments of a matmul, convolution or norm
    whose dtypes differ to their promoted dtype."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PROMOTED:
            floats = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                      if isinstance(t, torch.Tensor) and t.is_floating_point()]
            dtypes = {t.dtype for t in floats}
            if len(dtypes) > 1:
                dtype = functools.reduce(torch.promote_types, dtypes)
                args, kwargs = torch.utils._pytree.tree_map(
                    lambda t: t.to(dtype) if isinstance(t, torch.Tensor)
                    and t.is_floating_point() else t, (args, kwargs))
        return func(*args, **kwargs)


@contextlib.contextmanager
def bf16_parameters(model: nn.Module):
    """Inside the block the model's float32 parameters are bfloat16 copies,
    cast from them on entry (one cast a tensor, so tied weights stay tied)
    and swapped in where each module holds them, and ``PromoteMixed`` is
    on. A step runs its loss and its backward inside, so that a
    ``use_remat`` recomputation sees the same copies; the gradients reach
    the float32 parameters through the casts. On exit the parameters are
    back."""
    held = [(module, name, p) for module in model.modules()
            for name, p in module._parameters.items()
            if p is not None and p.dtype == torch.float32]
    casts = {}
    for module, name, p in held:
        if id(p) not in casts:
            casts[id(p)] = p.to(torch.bfloat16)
        module._parameters[name] = casts[id(p)]
    try:
        with PromoteMixed():
            yield
    finally:
        for module, name, p in held:
            module._parameters[name] = p
