"""Appearance shader and density decoder (port of ``nvfi_tpu/fields/shaders.py``).

Ported: the ``MLP_PE`` shader (features + viewdir + position + their
positional encodings -> 3-layer ReLU MLP -> sigmoid, zero-initialized final
bias) and the ``Density`` decoder (passthrough).  The other shading and
density modes raise ``NotImplementedError`` (ROADMAP.md A3).
"""

from __future__ import annotations

import torch

from ..ops.encoding import positional_encoding
from .mlp import mlp_apply, mlp_init, sigmoid

DENSITY_DATA_DIM = {"Density": 1, "DensityLinear": 2}


def unported(kind: str, mode: str):
    return NotImplementedError(
        f"{kind} {mode!r} is not ported to nvfi_torch yet (ROADMAP.md A3: "
        "fields/shaders.py, the other shaders and density decoders)"
    )


def shader_in_dim(mode: str, app_dim: int, view_pe: int, pos_pe: int, fea_pe: int) -> int:
    if mode == "MLP_PE":
        return (3 + 2 * view_pe * 3) + (3 + 2 * pos_pe * 3) + app_dim
    raise unported("shadingMode", mode)


def init_shader(generator: torch.Generator, mode: str, app_dim: int, view_pe: int = 6,
                pos_pe: int = 6, fea_pe: int = 6, feature_c: int = 128):
    """Shader params: the MLP layer list."""
    in_dim = shader_in_dim(mode, app_dim, view_pe, pos_pe, fea_pe)
    layers = mlp_init(generator, [in_dim, feature_c, feature_c, 3])
    layers[-1]["b"] = torch.zeros_like(layers[-1]["b"])  # zero-initialized final bias
    return layers


def make_shader(mode: str, view_pe: int = 6, pos_pe: int = 6, fea_pe: int = 6):
    """The shading function ``apply(params, pts, viewdirs, features) -> rgb``
    (float32 whatever the params' dtype)."""
    if mode != "MLP_PE":
        raise unported("shadingMode", mode)

    def apply(params, pts, viewdirs, features):
        indata = [features, viewdirs, pts]
        if pos_pe > 0:
            indata.append(positional_encoding(pts, pos_pe))
        if view_pe > 0:
            indata.append(positional_encoding(viewdirs, view_pe))
        x = torch.cat(indata, dim=-1)
        # bf16: JAX widens the colour to float32 at once, and XLA leaves the
        # sigmoid's last op, the division, in float32
        return sigmoid(mlp_apply(params, x, torch.relu), widen=True)

    return apply


def make_density_decoder(mode: str):
    """Density-feature decoder for ``densityMode``."""
    if mode != "Density":
        raise unported("densityMode", mode)

    def decode(features):
        return features[..., 0]

    return decode
