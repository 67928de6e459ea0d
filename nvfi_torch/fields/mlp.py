"""Minimal functional MLP building blocks (port of ``nvfi_tpu/fields/mlp.py``).

Params are plain dicts in the JAX package's layout: ``{'w': (in, out),
'b': (out,)}``.  ``nn.Linear.weight`` is ``(out, in)``; keeping ``(in, out)``
means params and checkpoints cross between the packages untransposed, and
``x @ w + b`` is one ``addmm`` in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def linear_init(generator: torch.Generator, in_dim: int, out_dim: int, bias: bool = True):
    """torch.nn.Linear's default init: W and b ~ U(-1/sqrt(in), 1/sqrt(in)).

    Drawn on the CPU from ``generator``; callers move the tree to a device."""
    bound = 1.0 / math.sqrt(in_dim)

    def uniform(*shape):
        return (torch.rand(*shape, generator=generator) * 2.0 - 1.0) * bound

    p = {"w": uniform(in_dim, out_dim)}
    if bias:
        p["b"] = uniform(out_dim)
    return p


def linear(p, x: torch.Tensor, widen: bool = False) -> torch.Tensor:
    """``x @ w + b`` in the weight's dtype (x is cast to it, as the JAX
    package does for bf16-cast params).  In float32 one ``addmm``; in bf16
    the product is rounded before the bias is added, as JAX's dot + add
    round twice (``addmm`` would round once).

    ``widen``: in bf16, return the bias add unrounded, in float32.  Where the
    JAX package widens a bf16 result to float32 at once, XLA drops the
    rounding in between and keeps the float32 sum (its excess precision)."""
    w = p["w"]
    x2 = x.reshape(-1, x.shape[-1]).to(w.dtype)
    if w.dtype == torch.float32:
        y = torch.addmm(p["b"], x2, w) if "b" in p else x2 @ w
    else:
        y = x2 @ w
        if widen:
            y = y.float()
        if "b" in p:
            y = y + p["b"].to(y.dtype)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def mlp_init(generator: torch.Generator, dims, bias: bool = True):
    """Init a stack of Linear layers with the given [in, h1, ..., out] dims."""
    return [linear_init(generator, dims[i], dims[i + 1], bias) for i in range(len(dims) - 1)]


def mlp_apply(layers, x: torch.Tensor, act, final_act=None, widen: bool = False) -> torch.Tensor:
    """``widen``: the last layer's output in float32 (see :func:`linear`);
    without ``final_act`` only."""
    for i, p in enumerate(layers):
        last = i == len(layers) - 1
        x = linear(p, x, widen=widen and last and final_act is None)
        if not last:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


class _Bf16Sigmoid(torch.autograd.Function):
    """``jax.nn.sigmoid`` of a bf16 array as XLA computes it: ``1 / (1 +
    exp(-x))``, each op rounded to bf16 (equal in every element on the CPU,
    where ``torch.sigmoid``, rounded once, agrees in 66%), and JAX's
    derivative rule ``g * (y * (1 - y))``, each op rounded.  With ``widen``
    the division is left in float32 and so is the output (see
    :func:`linear`)."""

    @staticmethod
    def forward(ctx, x, widen):
        d = 1.0 + torch.exp(-x)
        y = 1.0 / (d.float() if widen else d)
        ctx.save_for_backward(y.to(x.dtype))
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g.to(y.dtype) * (y * (1.0 - y)), None


def sigmoid(x: torch.Tensor, widen: bool = False) -> torch.Tensor:
    """``torch.sigmoid`` in float32; JAX's bf16 sigmoid for bf16."""
    return torch.sigmoid(x) if x.dtype == torch.float32 else _Bf16Sigmoid.apply(x, widen)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``F.silu`` in float32; in bf16 ``x * sigmoid(x)`` with JAX's bf16
    sigmoid, the form of ``jax.nn.silu``, which it then equals element for
    element (``F.silu`` rounded once agrees in 61%)."""
    return F.silu(x) if x.dtype == torch.float32 else x * sigmoid(x)
