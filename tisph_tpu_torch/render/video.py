"""Assemble exported frames into an animation (GIF via Pillow).

The reference shows frames live in ti.GUI; the headless equivalent is
``run_scene.py --format png`` + this assembler (or any external encoder on
the PNG sequence).
"""

from __future__ import annotations

import glob
import os


def frames_to_gif(
    frame_dir: str,
    out_path: str,
    pattern: str = "*.png",
    fps: int = 20,
    every: int = 1,
) -> str:
    """Combine ``frame_dir/pattern`` (sorted) into a GIF.  Returns out_path."""
    from PIL import Image

    paths = sorted(glob.glob(os.path.join(frame_dir, pattern)))[::every]
    if not paths:
        raise FileNotFoundError(f"no frames matching {pattern} in {frame_dir}")
    frames = [Image.open(p).convert("P", palette=Image.ADAPTIVE) for p in paths]
    frames[0].save(
        out_path,
        save_all=True,
        append_images=frames[1:],
        duration=int(1000 / fps),
        loop=0,
        optimize=True,
    )
    return out_path
