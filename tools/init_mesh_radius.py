#!/usr/bin/env python3
"""Mean vertex radius of the full-width SDF's zero set at geometric init,
per seed, for the PyTorch port and for the JAX package side by side.

    python3 tools/init_mesh_radius.py [--seeds 10] [--res 40]

The geometric init (bias 0.5) makes the SDF a noisy sphere.  For each seed
this meshes two independent inits over the DTU object box: the port's
Stage1Model(seed).sdf through the port's extraction (the plain PyTorch
twin on the CPU), and the JAX package's sdf_init with the key its
init_all_params(PRNGKey(seed)) gives the sdf group, through the JAX
package's extraction with a float32 wire.  The two RNGs differ, so the
columns are two samples of one distribution, not the same meshes.  Both
run on the CPU: no device metric comes from this tool.  It is the one
script outside the tests that imports both packages.
"""
import argparse
import os
import sys

import numpy as np
import torch

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from factored_neus_tpu.meshing import extract as JMEXT  # noqa: E402
from factored_neus_tpu.models import fields as JF  # noqa: E402
from factored_neus_tpu_torch.meshing import extract as MEXT  # noqa: E402
from factored_neus_tpu_torch.models.renderer import (  # noqa: E402
    RendererConfig, Stage1Model)

BOX = ([-1.01] * 3, [1.01] * 3)


def _radius(v: np.ndarray) -> str:
    r = np.linalg.norm(v, axis=-1)
    return f"{r.mean():.4f} (std {r.std():.4f}, {len(v)} vertices)"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--res", type=int, default=40)
    args = p.parse_args()
    jcfg = JF.SDFConfig()
    port, ref = [], []
    for seed in range(args.seeds):
        sdf = Stage1Model(RendererConfig(), seed=seed).sdf
        with torch.no_grad():
            v, _ = MEXT.extract_geometry(*BOX, args.res, 0.0,
                                         MEXT.sdf_grid_query(sdf), "cpu")
        key = jax.random.split(jax.random.PRNGKey(seed), 8)[1]
        jq = JMEXT.make_sdf_grid_query(JF.sdf_init(key, jcfg), jcfg)
        jv, _ = JMEXT.extract_geometry(*BOX, args.res, 0.0, jq,
                                       transfer_dtype=jnp.float32)
        port.append(np.linalg.norm(v, axis=-1).mean())
        ref.append(np.linalg.norm(jv, axis=-1).mean())
        print(f"seed {seed}: port {_radius(v)} | JAX {_radius(jv)}",
              flush=True)
    for name, r in (("port", port), ("JAX", ref)):
        print(f"{name}: mean radius over seeds {np.mean(r):.4f}, std "
              f"{np.std(r):.4f}, range {np.min(r):.4f}-{np.max(r):.4f} at "
              f"{args.res}^3 (CPU)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
