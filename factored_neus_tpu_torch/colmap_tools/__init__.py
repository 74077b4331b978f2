"""Standalone COLMAP interchange utilities.  Counterpart of
factored_neus_tpu/colmap_tools (the port's own copies, numpy, sqlite3 and
the standard library; no training path uses them):

  database     COLMAP sqlite database creation/reading (the public schema)
  dense        COLMAP MVS .bin depth/normal map I/O ("w&h&c&" header,
               column-major f32)
  export       sparse model -> PLY point cloud; PLY merging
  fused        MVS fused.ply + fused.ply.vis point-visibility I/O
  interchange  Bundler / VisualSfM <-> COLMAP (CLI: python -m
               factored_neus_tpu_torch.colmap_tools.interchange <cmd> ...)
  visualize    headless model viewer equivalent: cameras as frustums and
               filtered points exported to one PLY

The sparse model reader is data/colmap_model.py, the PLY writer
meshing/ply.py.
"""
from . import database, dense, export, fused, visualize  # noqa: F401
