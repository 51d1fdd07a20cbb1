"""Interactive / scripted viewers (matplotlib): ``tisph_tpu.render.viewer``
on the port's ``state_to_host``.

Replaces the reference's ti.GUI circles (main.py:16-24) and GGUI 3D scene
(main_3d.py:8-46) with a host-side matplotlib viewer fed by async
device->host snapshots — deliberately out of the device's hot path
(SURVEY.md §2.9.7).  Works headless (Agg) for frame export and
interactively when a display is present.
"""

from __future__ import annotations

import numpy as np

from tisph_tpu_torch.config import SceneConfig
from tisph_tpu_torch.models.state import SimState, state_to_host
from tisph_tpu_torch.utils.lines import domain_wireframe


class Viewer:
    """Live scatter viewer.  Call ``show(state)`` once per rendered frame."""

    def __init__(self, scene: SceneConfig, interactive: bool = True, point_size: float = 1.5):
        import matplotlib

        if not interactive:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        self._plt = plt
        self.scene = scene
        self.point_size = point_size
        self.dim = scene.dim
        if self.dim == 3:
            self.fig = plt.figure(figsize=(9, 6))
            self.ax = self.fig.add_subplot(111, projection="3d")
        else:
            self.fig, self.ax = plt.subplots(figsize=(9, 6))
        self._scatter = None
        self._draw_domain()
        if interactive:
            plt.ion()
            plt.show(block=False)

    def _draw_domain(self):
        pts, edges = domain_wireframe(self.scene.domain_start, self.scene.domain_end)
        for a, b in edges:
            seg = np.stack([pts[a], pts[b]])
            if self.dim == 3:
                self.ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], c="#cccccc", lw=0.8)
            else:
                self.ax.plot(seg[:, 0], seg[:, 1], c="#cccccc", lw=0.8)
        s, e = self.scene.domain_start, self.scene.domain_end
        self.ax.set_xlim(s[0], e[0])
        self.ax.set_ylim(s[1], e[1])
        if self.dim == 3:
            self.ax.set_zlim(s[2], e[2])
            try:
                self.ax.set_box_aspect([e[i] - s[i] for i in range(3)])
            except Exception:
                pass
        else:
            self.ax.set_aspect("equal")

    def show(self, state: SimState, title: str | None = None) -> None:
        host = state_to_host(state)
        x = host["position"] if "position" in host else host["x"]
        colors = np.clip(host["color"], 0.0, 1.0)
        if self._scatter is not None:
            self._scatter.remove()
        if self.dim == 3:
            self._scatter = self.ax.scatter(
                x[:, 0], x[:, 1], x[:, 2], s=self.point_size, c=colors, lw=0
            )
        else:
            self._scatter = self.ax.scatter(
                x[:, 0], x[:, 1], s=self.point_size, c=colors, lw=0
            )
        if title:
            self.ax.set_title(title)
        self.fig.canvas.draw_idle()
        try:
            self.fig.canvas.flush_events()
        except Exception:
            pass

    def savefig(self, path: str) -> None:
        self.fig.savefig(path, dpi=110)

    def close(self) -> None:
        self._plt.close(self.fig)
