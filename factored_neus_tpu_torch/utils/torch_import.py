"""Import reference torch ``.pth`` checkpoints into the port.  Counterpart
of factored_neus_tpu/utils/torch_import.py, written without JAX.

The reference saves per-network ``state_dict()`` groups
(ref:exp_runner.py:266-278, lvis.py:255-269, mateIllu.py:269-284):
  nerf, sdf_network_fine, variance_network_fine, color_network_fine,
  refColor_network, lvis_network, indiLgt_network, mateIllu_network,
  optimizer, iter_step.

The converters map those state dicts (weight-norm ``weight_g`` /
``weight_v`` in both key layouts: the legacy one, which is the port's own
``WNLinear`` layout, and ``parametrizations.weight.original0/1``) onto the
JAX package's parameter trees, the layout of the port's checkpoints
(bridge.py, utils/checkpoints.py).  ``load_into`` puts a checkpoint's
groups straight into a Stage1Model, Stage2Model or Stage3Model through
bridge.py.

The Adam ``optimizer`` group is not converted, as in the JAX package: torch
Adam state is keyed by parameter order inside torch's param groups, which
has no stable correspondence to the checkpoints' optimizer leaves; the
runners start a fresh optimizer, as the reference does between stages
(ref:lvis.py:241-250).

CLI:  python -m factored_neus_tpu_torch.utils.torch_import ckpt.pth
out_exp_dir/  writes ``out_exp_dir/checkpoints/ckpt_{iter:06d}.npz``, which
every runner's ``--is_continue`` reads.

Weight layout (torch -> the checkpoints' trees):
  * ``nn.Linear.weight`` is stored [out, in]; the trees keep [in, out].
  * weight norm keeps ``g`` as [out, 1], the norm over the input axis; the
    trees keep ``g`` as [out] with the same meaning.
"""
from __future__ import annotations

import sys
from typing import Any, Dict, List

import numpy as np

from .. import bridge


def _t2n(t) -> np.ndarray:
    if hasattr(t, "detach"):
        t = t.detach().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _dense(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    return {"w": _t2n(sd[f"{prefix}.weight"]).T,
            "b": _t2n(sd[f"{prefix}.bias"])}


def _wn(sd: Dict, prefix: str) -> Dict[str, np.ndarray]:
    if f"{prefix}.weight_g" in sd:
        g = _t2n(sd[f"{prefix}.weight_g"])
        v = _t2n(sd[f"{prefix}.weight_v"])
    else:                       # torch >= 2.1 parametrizations layout
        g = _t2n(sd[f"{prefix}.parametrizations.weight.original0"])
        v = _t2n(sd[f"{prefix}.parametrizations.weight.original1"])
    return {"v": v.T, "g": g.reshape(-1), "b": _t2n(sd[f"{prefix}.bias"])}


def _wn_lin_stack(sd: Dict, base: str = "lin") -> List[Dict]:
    """lin0..linN weight-normed stack (SDFNetwork / RenderingNetwork)."""
    out = []
    l = 0
    while any(f"{base}{l}.{k}" in sd for k in
              ("weight_g", "bias", "parametrizations.weight.original0")):
        out.append(_wn(sd, f"{base}{l}"))
        l += 1
    if not out:
        raise KeyError(f"no '{base}N' layers found in state dict")
    return out


def _seq_dense_stack(sd: Dict, base: str) -> List[Dict]:
    """nn.Sequential(Linear, Act, Linear, ...) -> plain layers at even idx."""
    out = []
    i = 0
    while f"{base}.{i}.weight" in sd:
        out.append(_dense(sd, f"{base}.{i}"))
        i += 2
    if not out:
        raise KeyError(f"no '{base}.N' layers found in state dict")
    return out


def _modlist_dense_stack(sd: Dict, base: str) -> List[Dict]:
    """nn.ModuleList of Linears -> consecutive indices."""
    out = []
    i = 0
    while f"{base}.{i}.weight" in sd:
        out.append(_dense(sd, f"{base}.{i}"))
        i += 1
    if not out:
        raise KeyError(f"no '{base}.N' layers found in state dict")
    return out


# --- per-network converters (torch state_dict -> the checkpoints' tree) -----

def convert_sdf(sd: Dict) -> List[Dict]:
    """ref:models/fields.py:9-111 (SDFNetwork, weight-normed lin0..linN)."""
    return _wn_lin_stack(sd)


def convert_rendering(sd: Dict) -> List[Dict]:
    """ref:models/fields.py:114-175 (RenderingNetwork)."""
    return _wn_lin_stack(sd)


def convert_variance(sd: Dict) -> Dict[str, np.ndarray]:
    """ref:models/fields.py:262-268 (SingleVarianceNetwork)."""
    return {"variance": _t2n(sd["variance"]).reshape(())}


def convert_nerf(sd: Dict) -> Dict[str, Any]:
    """ref:models/fields.py:178-259 (background NeRF, use_viewdirs=True)."""
    return {
        "pts_linears": _modlist_dense_stack(sd, "pts_linears"),
        "views_linear": _dense(sd, "views_linears.0"),
        "feature_linear": _dense(sd, "feature_linear"),
        "alpha_linear": _dense(sd, "alpha_linear"),
        "rgb_linear": _dense(sd, "rgb_linear"),
    }


def convert_refcolor(sd: Dict) -> Dict[str, Any]:
    """ref:models/fields.py:271-335 (RefColor)."""
    return {
        "net_cd": _seq_dense_stack(sd, "net_cd"),
        "viewdir_mlp": _modlist_dense_stack(sd, "viewdir_mlp"),
        "net_cs": _seq_dense_stack(sd, "net_cs"),
    }


def convert_lvis(sd: Dict) -> List[Dict]:
    """ref:models/fields.py:338-369 (Lvis)."""
    return _seq_dense_stack(sd, "lvis")


def convert_indirect(sd: Dict) -> List[Dict]:
    """ref:models/fields.py:372-412 (IndirectLight)."""
    return _seq_dense_stack(sd, "indi")


def convert_material(sd: Dict) -> Dict[str, Any]:
    """ref:models/inverRender.py:451-528 (EnvmapMaterialNetwork)."""
    return {
        "lgtSGs": _t2n(sd["lgtSGs"]),
        "brdf_encoder": _seq_dense_stack(sd, "brdf_encoder_layer"),
        "brdf_decoder": _seq_dense_stack(sd, "brdf_decoder_layer"),
        "net_cs": _seq_dense_stack(sd, "net_cs"),
    }


# group name in the .pth -> (converter, the params group of the port's
# models, bridge.py)
GROUP_CONVERTERS = {
    "nerf": (convert_nerf, "nerf"),
    "sdf_network_fine": (convert_sdf, "sdf"),
    "variance_network_fine": (convert_variance, "variance"),
    "color_network_fine": (convert_rendering, "color"),
    "refColor_network": (convert_refcolor, "ref_color"),
    "lvis_network": (convert_lvis, "lvis"),
    "indiLgt_network": (convert_indirect, "indirect"),
    "mateIllu_network": (convert_material, "material"),
}


def convert_torch_checkpoint(ckpt: Dict) -> Dict[str, Any]:
    """Torch checkpoint dict (as saved by the reference) -> the port's
    checkpoint groups (same group names; values are the checkpoints'
    trees) plus iter_step.  Unknown groups and the optimizer are skipped."""
    out: Dict[str, Any] = {}
    for name, (fn, _) in GROUP_CONVERTERS.items():
        if name in ckpt:
            out[name] = fn(ckpt[name])
    out["iter_step"] = int(ckpt.get("iter_step", 0))
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Read a reference .pth from disk (CPU) and convert."""
    import torch
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return convert_torch_checkpoint(ckpt)


def load_into(model, groups: Dict[str, Any]) -> int:
    """Puts a converted checkpoint's groups (convert_torch_checkpoint or
    load_torch_checkpoint) into a Stage1Model, Stage2Model or Stage3Model,
    each group the model holds (model.GROUPS), through bridge.py; returns
    the checkpoint's iter_step.  Raises if a group the model holds is
    missing."""
    for name, (_, group) in GROUP_CONVERTERS.items():
        if group not in model.GROUPS:
            continue
        if name not in groups:
            raise KeyError(f"the checkpoint has no {name!r} group, which "
                           f"{type(model).__name__} holds ({group!r})")
        bridge.load_jax_group(model, group, groups[name])
    return int(groups.get("iter_step", 0))


def import_to_exp_dir(pth_path: str, base_exp_dir: str) -> str:
    """Convert a .pth and write it as an npz checkpoint under
    ``{base_exp_dir}/checkpoints/`` so ``--is_continue`` picks it up."""
    from . import checkpoints as CK
    groups = load_torch_checkpoint(pth_path)
    return CK.save_checkpoint(base_exp_dir, groups["iter_step"], groups)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python -m factored_neus_tpu_torch.utils.torch_import "
              "<ckpt.pth> <base_exp_dir>", file=sys.stderr)
        return 2
    path = import_to_exp_dir(argv[0], argv[1])
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
