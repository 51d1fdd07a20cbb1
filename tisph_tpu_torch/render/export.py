"""Headless frame export, the counterpart of ``tisph_tpu.render.export``.

A frame holds the reference's six arrays, ``position``, ``velocity``,
``density``, ``pressure``, ``material`` and ``color``, each cut to the
live particles, as ``.npz`` (or a scatter plot as ``.png``, through
matplotlib, which is imported only then).  ``save`` does not wait for the
device: on a CUDA state it starts non-blocking copies into pinned host
memory on the current stream and records a CUDA event behind them; a
worker thread waits on that event and writes the file, one frame behind
the solver.  On the CPU the copy is a plain one.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from tisph_tpu_torch.config import SceneConfig
from tisph_tpu_torch.models.state import SimState


class FrameExporter:
    """Writes per-frame particle snapshots as .npz (the six arrays) or .png
    (a scatter render, 2D or the xy projection of 3D)."""

    def __init__(self, out_dir: str, fmt: str = "npz", scene: SceneConfig | None = None):
        if fmt not in ("npz", "png"):
            raise ValueError(f"unknown frame format {fmt!r}")
        self.out_dir = out_dir
        self.fmt = fmt
        self.scene = scene
        os.makedirs(out_dir, exist_ok=True)
        self._q: queue.Queue = queue.Queue(maxsize=4)
        self._error: BaseException | None = None
        self._worker = threading.Thread(target=self._drain, daemon=True)
        self._worker.start()

    def save(self, state: SimState, frame: int) -> None:
        if self._error is not None:
            raise self._error
        n = state.num_active
        arrays = {"position": state.x, "velocity": state.v, "density": state.density,
                  "pressure": state.pressure, "material": state.material,
                  "color": state.color}
        done = None
        if state.device.type == "cuda":
            host = {}
            for k, a in arrays.items():
                host[k] = torch.empty(a[:n].shape, dtype=a.dtype, pin_memory=True)
                host[k].copy_(a[:n], non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(state.device))
        else:
            host = {k: a[:n].clone() for k, a in arrays.items()}
        self._q.put((frame, host, done))

    def _drain(self) -> None:
        try:
            while True:
                item = self._q.get()
                if item is None:
                    return
                frame, host, done = item
                if done is not None:
                    done.synchronize()
                arrays = {k: v.numpy() for k, v in host.items()}
                if self.fmt == "npz":
                    np.savez_compressed(
                        os.path.join(self.out_dir, f"frame_{frame:06d}.npz"), **arrays)
                else:
                    self._write_png(arrays, frame)
        except BaseException as e:  # surfaced on the next save() or close()
            self._error = e

    def _write_png(self, host: dict[str, np.ndarray], frame: int) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        x = host["position"]
        mat = host["material"]
        fig, ax = plt.subplots(figsize=(8, 6))
        if x.shape[1] == 3:
            # orthographic xy projection, drawn back to front in z
            order = np.argsort(x[:, 2])
            x2, mat2 = x[order][:, :2], mat[order]
        else:
            x2, mat2 = x, mat
        ax.scatter(x2[mat2 == 1, 0], x2[mat2 == 1, 1], s=1.0, c="#3070c0", lw=0)
        ax.scatter(x2[mat2 == 0, 0], x2[mat2 == 0, 1], s=1.0, c="#909090", lw=0)
        if self.scene is not None:
            ax.set_xlim(self.scene.domain_start[0], self.scene.domain_end[0])
            ax.set_ylim(self.scene.domain_start[1], self.scene.domain_end[1])
        ax.set_aspect("equal")
        ax.set_title(f"frame {frame}")
        fig.savefig(os.path.join(self.out_dir, f"frame_{frame:06d}.png"), dpi=100)
        plt.close(fig)

    def close(self) -> None:
        """Write the frames still queued, stop the worker, and raise what it
        raised."""
        self._q.put(None)
        self._worker.join(timeout=60)
        if self._error is not None:
            raise self._error
        if self._worker.is_alive():
            raise RuntimeError(f"frame writer still busy after 60 s ({self.out_dir})")


def load_frame(path: str) -> dict[str, np.ndarray]:
    """Read back one exported .npz frame."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
