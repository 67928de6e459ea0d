"""Appearance shaders and density decoders (port of ``nvfi_tpu/fields/shaders.py``).

* MLP shaders: ``MLP_PE`` (features + viewdir + position + their positional
  encodings), ``MLP_Fea`` (features + viewdir + the encodings of both) and
  ``MLP`` (features + viewdir + the viewdir encoding), each a 3-layer ReLU
  MLP with a sigmoid output and a zero-initialized final bias;
* analytic shaders, with no parameters: ``SH`` (degree-2 spherical
  harmonics, ``fields.sh``), ``RGB`` (sigmoid), ``RGBIdentity``
  (``|x + 0.5|``) and ``RGBtLinear`` (a per-channel basis linear in t);
* density decoders: ``Density`` (passthrough) and ``DensityLinear`` (linear
  in t).

``make_shader(mode, ...)`` returns ``apply(params, pts, viewdirs, features,
aux=None) -> rgb``; ``aux`` carries the per-sample times (``aux["times"]``),
which ``RGBtLinear`` and ``DensityLinear`` read.  Where the JAX package's
caller passes no ``aux`` (the PDE filter, the segmentation query, the static
field) those two modes fail there, in JAX with a ``TypeError``; here with a
``ValueError`` saying so.  Plain torch ops and matmuls, as the JAX package
leaves them to XLA.

bf16 (features in bf16, the MLPs on bf16-cast params): the MLP modes take
MLP_PE's form (``mlp.sigmoid(widen=True)``), and MLP_Fea encodes the bf16
features in bf16; the analytic modes widen their bf16 result to float32 at
once, as XLA keeps it where JAX casts the colour to float32.
"""

from __future__ import annotations

import torch

from ..ops.encoding import positional_encoding
from .mlp import mlp_apply, mlp_init, sigmoid
from .sh import eval_sh_bases

MLP_SHADERS = ("MLP_PE", "MLP_Fea", "MLP")
ANALYTIC_SHADERS = ("SH", "RGB", "RGBIdentity", "RGBtLinear")

DENSITY_DATA_DIM = {"Density": 1, "DensityLinear": 2}


def shader_in_dim(mode: str, app_dim: int, view_pe: int, pos_pe: int, fea_pe: int) -> int:
    if mode == "MLP_PE":
        return (3 + 2 * view_pe * 3) + (3 + 2 * pos_pe * 3) + app_dim
    if mode == "MLP_Fea":
        return 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
    if mode == "MLP":
        return (3 + 2 * view_pe * 3) + app_dim
    raise ValueError(mode)


def init_shader(generator: torch.Generator, mode: str, app_dim: int, view_pe: int = 6,
                pos_pe: int = 6, fea_pe: int = 6, feature_c: int = 128):
    """Shader params: the MLP layer list, or None for an analytic shader."""
    if mode in MLP_SHADERS:
        in_dim = shader_in_dim(mode, app_dim, view_pe, pos_pe, fea_pe)
        layers = mlp_init(generator, [in_dim, feature_c, feature_c, 3])
        layers[-1]["b"] = torch.zeros_like(layers[-1]["b"])  # zero-initialized final bias
        return layers
    if mode in ANALYTIC_SHADERS:
        return None
    raise ValueError(f"unknown shadingMode {mode}")


def _times(aux, mode: str) -> torch.Tensor:
    """The per-sample times of ``aux``; a caller without them is refused."""
    if aux is None or "times" not in aux:
        raise ValueError(
            f"{mode} reads the per-sample times aux['times'], which this caller does not pass "
            "(the JAX package's caller passes aux=None here too, and fails there)")
    return aux["times"]


def _linear_in_t(coeffs: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., n, 2) coefficients on the basis (1, t): ``c0 + t c1``, JAX's sum."""
    return coeffs[..., 0] + t[..., None] * coeffs[..., 1]


def make_shader(mode: str, view_pe: int = 6, pos_pe: int = 6, fea_pe: int = 6):
    """The shading function ``apply(params, pts, viewdirs, features, aux=None)
    -> rgb`` (float32 whatever the params' dtype)."""

    def mlp(params, indata):
        # bf16: JAX widens the colour to float32 at once, and XLA leaves the
        # sigmoid's last op, the division, in float32
        return sigmoid(mlp_apply(params, torch.cat(indata, dim=-1), torch.relu), widen=True)

    if mode == "MLP_PE":

        def apply(params, pts, viewdirs, features, aux=None):
            indata = [features, viewdirs, pts]
            if pos_pe > 0:
                indata.append(positional_encoding(pts, pos_pe))
            if view_pe > 0:
                indata.append(positional_encoding(viewdirs, view_pe))
            return mlp(params, indata)

    elif mode == "MLP_Fea":

        def apply(params, pts, viewdirs, features, aux=None):
            indata = [features, viewdirs]
            if fea_pe > 0:  # in the features' dtype, as JAX encodes them
                indata.append(positional_encoding(features, fea_pe))
            if view_pe > 0:
                indata.append(positional_encoding(viewdirs, view_pe))
            return mlp(params, indata)

    elif mode == "MLP":

        def apply(params, pts, viewdirs, features, aux=None):
            indata = [features, viewdirs]
            if view_pe > 0:
                indata.append(positional_encoding(viewdirs, view_pe))
            return mlp(params, indata)

    elif mode == "SH":

        def apply(params, pts, viewdirs, features, aux=None):
            sh_mult = eval_sh_bases(2, viewdirs)[..., None, :]
            rgb_sh = features.reshape(*features.shape[:-1], 3, sh_mult.shape[-1])
            return torch.relu(torch.sum(sh_mult * rgb_sh, dim=-1) + 0.5)

    elif mode == "RGB":

        def apply(params, pts, viewdirs, features, aux=None):
            return sigmoid(features, widen=True)

    elif mode == "RGBIdentity":

        def apply(params, pts, viewdirs, features, aux=None):
            return torch.abs(features.float() + 0.5)

    elif mode == "RGBtLinear":

        def apply(params, pts, viewdirs, features, aux=None):
            coeffs = features.reshape(*features.shape[:-1], 3, 2)
            return torch.relu(_linear_in_t(coeffs, _times(aux, mode)) + 0.5)

    else:
        raise ValueError(f"unknown shadingMode {mode}")

    return apply


def make_density_decoder(mode: str):
    """Density-feature decoder ``decode(features, aux=None)`` for
    ``densityMode``."""
    if mode == "Density":

        def decode(features, aux=None):
            return features[..., 0]

    elif mode == "DensityLinear":

        def decode(features, aux=None):
            coeffs = features.reshape(*features.shape[:-1], 1, 2)
            return _linear_in_t(coeffs, _times(aux, mode))[..., 0]

    else:
        raise ValueError(f"unknown densityMode {mode}")

    return decode
