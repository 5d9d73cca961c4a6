"""Training visualization sink: image grids + loss curves + HTML gallery
(port of ihmr_tpu/utils/visualizer.py).

Per-iteration image panels under ``web/images`` written by the port's own
PNG writer (``data.image_io.imwrite_png``: cv2's pixels, not its zlib
bytes), a regenerated ``index.html`` gallery with the JAX package's text,
and loss-curve PNGs through matplotlib where it can be imported. Where it
cannot (a host without it, or without PIL, which it imports), the curves
are kept in memory only and one line says so.
"""

from __future__ import annotations

import os.path as osp
from collections import OrderedDict
from typing import Dict, List

import numpy as np

from ihmr_tpu_torch.data import image_io
from ihmr_tpu_torch.utils import io_utils


def _as_u8(image) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    return img


class Visualizer:
    def __init__(self, checkpoints_dir: str, name: str = "ihmr_tpu", live_port: int = -1):
        """``live_port >= 0`` starts the in-process live HTTP monitor
        (``utils.live_dashboard``; 0 picks an ephemeral port)."""
        self.name = name
        self.web_dir = osp.join(checkpoints_dir, "web")
        self.img_dir = osp.join(self.web_dir, "images")
        io_utils.build_dir(self.img_dir)
        self._loss_history: Dict[str, List] = {}
        self._gallery: List[Dict] = []
        self.curves_skipped = None  # why loss curves are not drawn, once known
        self.dashboard = None
        if live_port >= 0:
            from ihmr_tpu_torch.utils.live_dashboard import LiveDashboard

            self.dashboard = LiveDashboard(self.web_dir, name=name)
            self.dashboard.start(live_port)

    # ------------------------------------------------------------------
    def display_current_results(self, visuals: "OrderedDict[str, np.ndarray]", epoch: int, it: int = 0):
        """Write the visual dict (RGB panels) as PNGs + refresh the gallery."""
        entry = {"epoch": epoch, "iter": it, "images": []}
        for label, image in visuals.items():
            safe = label.replace(" ", "_").replace("/", "-")
            fname = f"epoch{epoch:03d}_{it:06d}_{safe}.png"
            image_io.imwrite_png(osp.join(self.img_dir, fname), _as_u8(image)[..., ::-1])  # RGB->BGR
            entry["images"].append((label, fname))
        self._gallery.append(entry)
        self._write_html()

    def _write_html(self):
        rows = []
        for entry in reversed(self._gallery[-50:]):
            cells = "".join(
                f'<td><img src="images/{fname}" style="max-width:256px"><br>{label}</td>'
                for label, fname in entry["images"]
            )
            rows.append(f"<tr><th>epoch {entry['epoch']} iter {entry['iter']}</th>{cells}</tr>")
        html = (
            f"<html><head><title>{self.name}</title></head><body>"
            f"<h1>{self.name}</h1><table border=1>{''.join(rows)}</table></body></html>"
        )
        with open(osp.join(self.web_dir, "index.html"), "w") as f:
            f.write(html)

    # ------------------------------------------------------------------
    def plot_current_errors(self, epoch: float, errors: Dict[str, float]):
        """Accumulate + re-plot loss curves (``web/loss_curves.png``)."""
        for name, value in errors.items():
            self._loss_history.setdefault(name, []).append((epoch, float(value)))
        if self.dashboard is not None:
            self.dashboard.update(epoch, errors)
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(8, 5))
            for name, series in self._loss_history.items():
                xs, ys = zip(*series)
                ax.plot(xs, ys, label=name, linewidth=1)
            ax.set_xlabel("epoch")
            ax.set_ylabel("loss")
            ax.legend(fontsize=7)
            fig.tight_layout()
            fig.savefig(osp.join(self.web_dir, "loss_curves.png"), dpi=100)
            plt.close(fig)
        except Exception as err:  # no matplotlib here: the curves stay in the history only
            if self.curves_skipped is None:
                self.curves_skipped = f"{type(err).__name__}: {err}"
                print(f"[visualizer] loss curves skipped (matplotlib cannot be used: {self.curves_skipped}); "
                      "the losses are kept in memory and on the live monitor", flush=True)

    def print_current_errors(self, epoch: int, i: int, errors: Dict[str, float]):
        parts = [f"(epoch: {epoch}, iters: {i})"] + [f"{k}: {v:.3f}" for k, v in errors.items()]
        print(" ".join(parts), flush=True)


def save_vis_result(visuals: "OrderedDict[str, np.ndarray]", out_dir: str, epoch: int, it: int):
    """Tile all panels into one PNG (panels of another height resized to the
    tallest, as ``cv2.resize`` resizes uint8)."""
    io_utils.build_dir(out_dir)
    imgs = []
    height = max(np.asarray(v).shape[0] for v in visuals.values())
    for label, img in visuals.items():
        img = _as_u8(img)
        if img.shape[0] != height:
            scale = height / img.shape[0]
            img = image_io.resize_linear(img, (int(img.shape[1] * scale), height))
        imgs.append(img)
    tile = np.concatenate(imgs, axis=1)
    image_io.imwrite_png(osp.join(out_dir, f"epoch{epoch:03d}_iter{it:06d}.png"), np.ascontiguousarray(tile[..., ::-1]))
