"""Config schema: HOCON tree -> typed configs of stage 1 and, from the
section model.lvis_renderer, stages 2 and 3 (the Lvis, IndirectLight and
material configs keep their defaults, as in the JAX package; the
material's tonemap is the caller's: srgb for DTU).  Counterpart of
factored_neus_tpu/utils/config.py (sdf_config, rendering_config,
nerf_config, renderer_config, variance_init_val, load)."""
from __future__ import annotations

from ..models import fields as F
from ..models.materials import EnvmapMaterialConfig
from ..models.renderer import RendererConfig
from .hocon import ConfigTree, parse_file


def sdf_config(c: ConfigTree) -> F.SDFConfig:
    d = c.get("model.sdf_network", ConfigTree())
    return F.SDFConfig(
        d_in=int(d.get("d_in", 3)),
        d_out=int(d.get("d_out", 257)),
        d_hidden=int(d.get("d_hidden", 256)),
        n_layers=int(d.get("n_layers", 8)),
        skip_in=tuple(d.get("skip_in", [4])),
        multires=int(d.get("multires", 6)),
        bias=float(d.get("bias", 0.5)),
        scale=float(d.get("scale", 1.0)),
        geometric_init=bool(d.get("geometric_init", True)),
        weight_norm=bool(d.get("weight_norm", True)),
        inside_outside=bool(d.get("inside_outside", False)))


def rendering_config(c: ConfigTree) -> F.RenderingConfig:
    d = c.get("model.rendering_network", ConfigTree())
    return F.RenderingConfig(
        d_feature=int(d.get("d_feature", 256)),
        mode=str(d.get("mode", "idr")),
        d_in=int(d.get("d_in", 9)),
        d_out=int(d.get("d_out", 3)),
        d_hidden=int(d.get("d_hidden", 256)),
        n_layers=int(d.get("n_layers", 4)),
        weight_norm=bool(d.get("weight_norm", True)),
        multires_view=int(d.get("multires_view", 4)),
        squeeze_out=bool(d.get("squeeze_out", True)))


def nerf_config(c: ConfigTree) -> F.NeRFConfig:
    d = c.get("model.nerf", ConfigTree())
    return F.NeRFConfig(
        D=int(d.get("D", 8)),
        W=int(d.get("W", 256)),
        d_in=int(d.get("d_in", 4)),
        d_in_view=int(d.get("d_in_view", 3)),
        multires=int(d.get("multires", 10)),
        multires_view=int(d.get("multires_view", 4)),
        skips=tuple(d.get("skips", [4])))


def renderer_config(c: ConfigTree, section: str = "model.neus_renderer",
                    tonemap: str = "srgb") -> RendererConfig:
    d = c.get(section, ConfigTree())
    sdf = sdf_config(c)
    return RendererConfig(
        n_samples=int(d.get("n_samples", 64)),
        n_importance=int(d.get("n_importance", 64)),
        n_outside=int(d.get("n_outside", 0)),
        up_sample_steps=int(d.get("up_sample_steps", 4)),
        perturb=float(d.get("perturb", 1.0)),
        sdf=sdf,
        rendering=rendering_config(c),
        nerf=nerf_config(c),
        # RefColor consumes the SDF feature vector (d_out - 1 dims)
        refcolor=F.RefColorConfig(d_feature=sdf.d_out - 1),
        material=EnvmapMaterialConfig(tonemap=tonemap))


def variance_init_val(c: ConfigTree) -> float:
    return float(c.get("model.variance_network.init_val", 0.3))


def load(conf_path: str, case: str = "") -> ConfigTree:
    """Parse a conf with CASE_NAME substitution."""
    c = parse_file(conf_path, case_name=case)
    if "dataset" in c and "data_dir" in c["dataset"]:
        c["dataset"]["data_dir"] = str(c["dataset"]["data_dir"]).replace(
            "CASE_NAME", case)
    return c
