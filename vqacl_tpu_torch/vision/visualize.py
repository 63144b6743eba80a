"""Box visualization (debug) — counterpart of the reference's
VL-T5/inference/visualizing_image.py (SingleImageViz):
draw the 36 region boxes with class labels onto an image, matplotlib
only (no cv2 dependency).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def draw_boxes(image_rgb: np.ndarray, boxes: np.ndarray,
               labels: Optional[Sequence[str]] = None,
               scores: Optional[np.ndarray] = None,
               out_path: Optional[str] = None):
    """image [H,W,3] uint8; boxes [N,4] pixel xyxy. Saves a PNG if
    ``out_path`` given, else returns the matplotlib figure."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    fig, ax = plt.subplots(figsize=(image_rgb.shape[1] / 100,
                                    image_rgb.shape[0] / 100), dpi=100)
    ax.imshow(image_rgb)
    ax.axis("off")
    cmap = plt.get_cmap("tab20")
    for i, b in enumerate(np.asarray(boxes)):
        color = cmap(i % 20)
        ax.add_patch(Rectangle((b[0], b[1]), b[2] - b[0], b[3] - b[1],
                               fill=False, edgecolor=color, linewidth=1.5))
        text = ""
        if labels is not None:
            text = str(labels[i])
        if scores is not None:
            text += f" {float(scores[i]):.2f}"
        if text:
            ax.text(b[0], max(b[1] - 2, 0), text, fontsize=6, color="white",
                    bbox=dict(facecolor=color, alpha=0.7, pad=1,
                              edgecolor="none"))
    fig.tight_layout(pad=0)
    if out_path:
        fig.savefig(out_path)
        plt.close(fig)
        return None
    return fig
