"""Per-group Adam with exponential per-step learning-rate decay.

Port of ``nvfi_tpu/train/optim.py`` as plain functions on the param tree:
grids at lr_grid, networks (basis mats, shader) at lr_net, the velocity net
at lr_vel, betas (0.9, 0.99), ``torch.optim.Adam``'s bias correction and eps
placement (eps outside the root).  The per-leaf base lr lives in an
``lr_tree`` mirroring the params and the decay enters as one scalar
``lr_scale``.  The state is the JAX package's ``{"m", "v", "step"}`` tree;
``step`` is a host int here.

Unlike the JAX original, ``apply_updates`` works in place: params and state
are updated where they are (three plane-sized temporaries less per step) and
returned.
"""

from __future__ import annotations

import torch

from ..fields.kplane import map_params

B1, B2 = 0.9, 0.99
EPS = 1e-8
GRID_KEYS = frozenset({"planes_space", "planes_time", "density_plane", "density_line",
                       "app_plane", "app_line"})


def make_lr_tree(params: dict, lr_grid: float, lr_net: float, lr_vel=None) -> dict:
    """Param grouping: planes at lr_grid, velocity at lr_vel, the rest at lr_net."""
    if lr_vel is None:
        lr_vel = lr_net

    def assign(key, subtree):
        lr = lr_grid if key in GRID_KEYS else (lr_vel if key == "vel" else lr_net)
        return map_params(lambda _: lr, subtree)

    return {k: assign(k, v) for k, v in params.items()}


def init_state(params) -> dict:
    return {"m": map_params(torch.zeros_like, params),
            "v": map_params(torch.zeros_like, params), "step": 0}


def tree_leaves(tree) -> list:
    """The leaves of a param-shaped tree in a fixed order (None leaves kept)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


@torch.no_grad()
def apply_updates(params, grads, state, lr_tree, lr_scale: float):
    """One Adam step, in place.  ``grads`` mirrors ``params``; a None leaf is
    a zero gradient.  ``lr_scale`` multiplies every leaf's lr.  Returns
    (params, state)."""
    step = int(state["step"]) + 1
    bc1 = 1.0 - B1**step
    bc2 = 1.0 - B2**step
    for p, g, m, v, lr in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]), tree_leaves(lr_tree)):
        if p is None:
            continue
        if g is not None:
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
        else:
            m.mul_(B1)
            v.mul_(B2)
        p.sub_((m / bc1) / (torch.sqrt(v / bc2) + EPS), alpha=lr_scale * lr)
    state["step"] = step
    return params, state
