"""Video writing.  Counterpart of factored_neus_tpu/utils/video.py, with
its order of attempts: imageio, then cv2, then a directory of PNG frames
written by the port's own PNG codec (the fallback on a machine with
neither; ``ffmpeg -i %04d.png out.mp4`` reassembles it)."""
from __future__ import annotations

import os
from typing import List

import numpy as np

from ..data.images import imwrite


def write_video(path: str, frames: List[np.ndarray], fps: int = 30,
                bgr: bool = False) -> str:
    """frames: [H, W, 3] uint8, BGR when ``bgr`` (the DTU loader's channel
    order).  Returns the path written: the mp4, or the frame directory
    ``<path without .mp4>_frames`` when no encoder is there."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rgb = [np.ascontiguousarray(f[..., ::-1] if bgr else f) for f in frames]
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(path, rgb, fps=fps, quality=9)
        if os.path.exists(path) and os.path.getsize(path) > 0:
            return path
    except Exception:      # no imageio, or no ffmpeg plugin behind it
        pass
    try:
        import cv2 as cv
        h, w = rgb[0].shape[:2]
        wr = cv.VideoWriter(path, cv.VideoWriter_fourcc(*"mp4v"), fps,
                            (w, h))
        # the writer does not raise when the codec is missing: it stays
        # closed, or writes nothing
        if wr.isOpened():
            for f in rgb:
                wr.write(np.ascontiguousarray(f[..., ::-1]))
        wr.release()
        if os.path.exists(path) and os.path.getsize(path) > 0:
            return path
    except Exception:      # no cv2, or a cv2 build without video I/O
        pass
    if os.path.exists(path):
        os.remove(path)            # a partial file from a failed encoder
    frame_dir = os.path.splitext(path)[0] + "_frames"
    os.makedirs(frame_dir, exist_ok=True)
    for i, f in enumerate(rgb):
        imwrite(os.path.join(frame_dir, f"{i:04d}.png"), f[..., ::-1])
    return frame_dir
