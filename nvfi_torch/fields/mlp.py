"""Minimal functional MLP building blocks (port of ``nvfi_tpu/fields/mlp.py``).

Params are plain dicts in the JAX package's layout: ``{'w': (in, out),
'b': (out,)}``.  ``nn.Linear.weight`` is ``(out, in)``; keeping ``(in, out)``
means params and checkpoints cross between the packages untransposed, and
``x @ w + b`` is one ``addmm``.
"""

from __future__ import annotations

import math

import torch


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


def linear(p, x: torch.Tensor) -> torch.Tensor:
    w = p["w"]
    x2 = x.reshape(-1, x.shape[-1])
    y = torch.addmm(p["b"], x2, w) if "b" in p else x2 @ w
    return y.reshape(*x.shape[:-1], w.shape[-1])


def mlp_init(generator: torch.Generator, dims, bias: bool = True):
    """Init a stack of Linear layers with the given [in, h1, ..., out] dims."""
    return [linear_init(generator, dims[i], dims[i + 1], bias) for i in range(len(dims) - 1)]


def mlp_apply(layers, x: torch.Tensor, act, final_act=None) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = linear(p, x)
        if i < len(layers) - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x
