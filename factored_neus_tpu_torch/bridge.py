"""Weight bridge between the JAX package's parameter pytrees (as numpy
arrays) and the port's modules: the name and layout map of the port's
checkpoints (utils/checkpoints.py), which keep the JAX package's format,
and of the tests and tools.

JAX layouts: weight-normed layers ``{'v': [in, out], 'g': [out], 'b'}``,
plain layers ``{'w': [in, out], 'b'}``, the variance ``{'variance': []}``,
the background NeRF ``{'pts_linears': [...], 'views_linear',
'feature_linear', 'alpha_linear', 'rgb_linear'}``, Lvis and IndirectLight
a list of plain layers, the material ``{'lgtSGs': [M, 7], 'brdf_encoder',
'brdf_decoder', 'net_cs'}`` with lists of plain layers.  A model's groups
are its ``GROUPS``: those of a Stage1Model, of a Stage2Model, which keeps
the stage-1 groups in its frozen ``stage1``, and of a Stage3Model.
The port keeps torch layouts: ``weight_v`` [out, in], ``weight_g`` [out, 1],
``nn.Linear.weight`` [out, in].  Tensors shaped like the parameters (their
gradients, Adam's moments) cross by the same map: ``jax_tree(model,
value=)`` reads them into the JAX layout, and ``load_jax_params(model,
tree, assign=)`` hands them back per parameter in the torch layout.
Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .ops.mlp import WNLinear

# the Sequential of Lvis' and IndirectLight's layers
_MLP = {"lvis": "lvis", "indirect": "indi"}
# the material group's MLPs: JAX key -> the Sequential of EnvmapMaterial
_MATERIAL_MLP = {"brdf_encoder": "brdf_encoder_layer",
                 "brdf_decoder": "brdf_decoder_layer", "net_cs": "net_cs"}
# the groups a Stage2Model or Stage3Model holds beside its ``stage1``
_LATER = ("lvis", "indirect", "material")
# parameter -> the tensor of that shape to read (the parameter itself,
# its gradient, an optimizer moment)
Value = Callable[[torch.Tensor], torch.Tensor]
# (parameter, a value in the parameter's torch layout) -> None
Assign = Callable[[torch.Tensor, torch.Tensor], None]


def _copy_into(param: torch.Tensor, value: torch.Tensor) -> None:
    with torch.no_grad():
        param.copy_(value)


def _grad_or_zeros(param: torch.Tensor) -> torch.Tensor:
    """A parameter's .grad, zeros where it took no part in the loss (what
    jax.grad gives for it)."""
    return torch.zeros_like(param) if param.grad is None else param.grad


def _linears(module: nn.Module) -> List[nn.Module]:
    """lin0 .. lin{n-1} of an SDFNetwork or RenderingNetwork."""
    return [getattr(module, f"lin{l}") for l in range(module.num_layers - 1)]


def _refcolor_linears(rc: nn.Module) -> Dict[str, List[nn.Linear]]:
    return {"net_cd": [rc.net_cd[i] for i in (0, 2, 4, 6, 8)],
            "viewdir_mlp": list(rc.viewdir_mlp),
            "net_cs": [rc.net_cs[0]]}


def _mlp_linears(seq: nn.Sequential) -> List[nn.Linear]:
    """The linear layers of an nn.Sequential (Lvis' or IndirectLight's
    stack, or one of EnvmapMaterial's MLPs)."""
    return [m for m in seq if isinstance(m, nn.Linear)]


def _module(model: nn.Module, group: str) -> nn.Module:
    """The module of a params group: a Stage2Model or Stage3Model holds
    the stage-1 groups in ``stage1``."""
    if group not in _LATER and hasattr(model, "stage1"):
        model = model.stage1
    return getattr(model, group)


def _nerf_linears(nerf: nn.Module) -> Dict[str, Any]:
    """The NeRF's layers under the JAX group's keys (a list for
    pts_linears, a single layer for the heads)."""
    return {"pts_linears": list(nerf.pts_linears),
            "views_linear": nerf.views_linears[0],
            "feature_linear": nerf.feature_linear,
            "alpha_linear": nerf.alpha_linear,
            "rgb_linear": nerf.rgb_linear}


def _set_layer(lin: nn.Module, p: Dict[str, Any],
               assign: Assign = _copy_into) -> None:
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    if isinstance(lin, WNLinear):
        assign(lin.weight_v, t(p["v"]).T)
        assign(lin.weight_g, t(p["g"]).reshape(-1, 1))
    else:
        assign(lin.weight, t(p["w"]).T)
    assign(lin.bias, t(p["b"]))


def _fetch(x: torch.Tensor, host: bool = True):
    """A value read out: a host array, or the detached tensor itself."""
    return x.detach().cpu().numpy() if host else x.detach()


def _get_layer(lin: nn.Module, value: Value,
               host: bool = True) -> Dict[str, Any]:
    a = lambda x: _fetch(value(x), host)
    if isinstance(lin, WNLinear):
        return {"v": a(lin.weight_v).T, "g": a(lin.weight_g).reshape(-1),
                "b": a(lin.bias)}
    return {"w": a(lin.weight).T, "b": a(lin.bias)}


def _value(grads: bool, value: Optional[Value]) -> Value:
    if value is not None:
        return value
    return _grad_or_zeros if grads else (lambda p: p)


def load_layers(module: nn.Module, layers: List[Dict[str, Any]],
                assign: Assign = _copy_into) -> None:
    """Copy a JAX layer list into an SDFNetwork or RenderingNetwork."""
    for lin, p in zip(_linears(module), layers, strict=True):
        _set_layer(lin, p, assign)


def load_jax_group(model: nn.Module, group: str, params: Any,
                   assign: Assign = _copy_into) -> None:
    """Copy one JAX params group (nerf, sdf, variance, color, ref_color,
    lvis, indirect or material; numpy leaves) into a Stage1Model,
    Stage2Model or Stage3Model, or hand each value to ``assign``."""
    if group not in model.GROUPS:
        raise KeyError(f"no params group {group!r} in {type(model).__name__}")
    module = _module(model, group)
    if group in ("sdf", "color"):
        load_layers(module, params, assign)
    elif group == "variance":
        assign(module.variance,
               torch.tensor(np.asarray(params["variance"], np.float32)))
    elif group == "ref_color":
        for name, lins in _refcolor_linears(module).items():
            for lin, p in zip(lins, params[name], strict=True):
                _set_layer(lin, p, assign)
    elif group == "nerf":
        load_nerf(module, params, assign)
    elif group == "material":
        assign(module.lgtSGs,
               torch.tensor(np.asarray(params["lgtSGs"], np.float32)))
        for name, seq in _MATERIAL_MLP.items():
            for lin, p in zip(_mlp_linears(getattr(module, seq)),
                              params[name], strict=True):
                _set_layer(lin, p, assign)
    else:
        for lin, p in zip(_mlp_linears(getattr(module, _MLP[group])), params,
                          strict=True):
            _set_layer(lin, p, assign)


def load_jax_params(model: nn.Module, params: Dict[str, Any],
                    assign: Assign = _copy_into,
                    groups: Optional[Sequence[str]] = None) -> None:
    """Copy the model's groups (or ``groups``) of a JAX params dict (numpy
    leaves) into a Stage1Model, Stage2Model or Stage3Model."""
    for group in groups or model.GROUPS:
        load_jax_group(model, group, params[group], assign)


def load_nerf(nerf: nn.Module, params: Dict[str, Any],
              assign: Assign = _copy_into) -> None:
    """Copy a JAX NeRF params group into a NeRF module."""
    for name, lins in _nerf_linears(nerf).items():
        if isinstance(lins, list):
            for lin, p in zip(lins, params[name], strict=True):
                _set_layer(lin, p, assign)
        else:
            _set_layer(lins, params[name], assign)


def jax_tree_layers(module: nn.Module, grads: bool = False,
                    value: Optional[Value] = None, host: bool = True
                    ) -> List[Dict[str, Any]]:
    """An SDFNetwork's or RenderingNetwork's layers (or their .grad, or
    ``value`` of each parameter) in the JAX layout."""
    get = _value(grads, value)
    return [_get_layer(l, get, host) for l in _linears(module)]


def _jax_group(module: nn.Module, group: str, get: Value,
               host: bool) -> Any:
    layer = lambda l: _get_layer(l, get, host)
    if group in ("sdf", "color"):
        return jax_tree_layers(module, value=get, host=host)
    if group == "variance":
        return {"variance": _fetch(get(module.variance), host)}
    if group == "ref_color":
        return {name: [layer(l) for l in lins]
                for name, lins in _refcolor_linears(module).items()}
    if group == "nerf":
        return {name: ([layer(l) for l in lins]
                       if isinstance(lins, list) else layer(lins))
                for name, lins in _nerf_linears(module).items()}
    if group == "material":
        return {"lgtSGs": _fetch(get(module.lgtSGs), host),
                **{name: [layer(l)
                          for l in _mlp_linears(getattr(module, seq))]
                   for name, seq in _MATERIAL_MLP.items()}}
    return [layer(l) for l in _mlp_linears(getattr(module, _MLP[group]))]


def jax_tree(model: nn.Module, grads: bool = False,
             value: Optional[Value] = None,
             groups: Optional[Sequence[str]] = None,
             host: bool = True) -> Dict[str, Any]:
    """The parameters (or their .grad, or ``value`` of each parameter) of
    the model's groups (or ``groups``) in the JAX pytree layout: host
    arrays, or with ``host`` False the detached tensors in that layout
    (views of the parameters; checkpoints.save_checkpoint_async copies
    them on the device)."""
    get = _value(grads, value)
    return {g: _jax_group(_module(model, g), g, get, host)
            for g in groups or model.GROUPS}
