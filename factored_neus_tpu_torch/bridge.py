"""Weight bridge between the JAX package's parameter pytrees (as numpy
arrays) and the port's modules, for tests and tools.

JAX layouts: weight-normed layers ``{'v': [in, out], 'g': [out], 'b'}``,
plain layers ``{'w': [in, out], 'b'}``, the variance ``{'variance': []}``.
The port keeps torch layouts: ``weight_v`` [out, in], ``weight_g`` [out, 1],
``nn.Linear.weight`` [out, in].  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch import nn

from .ops.mlp import WNLinear


def _linears(module: nn.Module) -> List[nn.Module]:
    """lin0 .. lin{n-1} of an SDFNetwork or RenderingNetwork."""
    return [getattr(module, f"lin{l}") for l in range(module.num_layers - 1)]


def _refcolor_linears(rc: nn.Module) -> Dict[str, List[nn.Linear]]:
    return {"net_cd": [rc.net_cd[i] for i in (0, 2, 4, 6, 8)],
            "viewdir_mlp": list(rc.viewdir_mlp),
            "net_cs": [rc.net_cs[0]]}


def _set_layer(lin: nn.Module, p: Dict[str, Any]) -> None:
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    with torch.no_grad():
        if isinstance(lin, WNLinear):
            lin.weight_v.copy_(t(p["v"]).T)
            lin.weight_g.copy_(t(p["g"]).reshape(-1, 1))
        else:
            lin.weight.copy_(t(p["w"]).T)
        lin.bias.copy_(t(p["b"]))


def _get_layer(lin: nn.Module, grad: bool) -> Dict[str, np.ndarray]:
    a = lambda x: (x.grad if grad else x).detach().cpu().numpy()
    if isinstance(lin, WNLinear):
        return {"v": a(lin.weight_v).T, "g": a(lin.weight_g).reshape(-1),
                "b": a(lin.bias)}
    return {"w": a(lin.weight).T, "b": a(lin.bias)}


def load_layers(module: nn.Module, layers: List[Dict[str, Any]]) -> None:
    """Copy a JAX layer list into an SDFNetwork or RenderingNetwork."""
    for lin, p in zip(_linears(module), layers, strict=True):
        _set_layer(lin, p)


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> None:
    """Copy a JAX stage-1 params dict (groups sdf, variance, color,
    ref_color; numpy leaves) into a Stage1Model."""
    for group in ("sdf", "color"):
        load_layers(getattr(model, group), params[group])
    with torch.no_grad():
        model.variance.variance.copy_(torch.as_tensor(
            np.asarray(params["variance"]["variance"], np.float32)))
    for name, lins in _refcolor_linears(model.ref_color).items():
        for lin, p in zip(lins, params["ref_color"][name], strict=True):
            _set_layer(lin, p)


def jax_tree_layers(module: nn.Module, grads: bool = False
                    ) -> List[Dict[str, np.ndarray]]:
    """An SDFNetwork's or RenderingNetwork's layers (or their .grad) in the
    JAX layout."""
    return [_get_layer(l, grads) for l in _linears(module)]


def jax_tree(model: nn.Module, grads: bool = False) -> Dict[str, Any]:
    """The model's parameters (or their .grad) in the JAX pytree layout."""
    tree: Dict[str, Any] = {
        g: jax_tree_layers(getattr(model, g), grads) for g in ("sdf", "color")}
    v = model.variance.variance
    tree["variance"] = {
        "variance": (v.grad if grads else v).detach().cpu().numpy()}
    tree["ref_color"] = {
        name: [_get_layer(l, grads) for l in lins]
        for name, lins in _refcolor_linears(model.ref_color).items()}
    return tree
