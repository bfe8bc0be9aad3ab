"""Control overlays: a mouse compass and button boxes on each frame (the
port's own copy of owl_audio_exps_tpu/utils/vis.py; PIL, the reference's
keybind layout).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

KEYBINDS = ["W", "A", "S", "D", "LSHIFT", "SPACE", "R", "F", "E",
            "LMB", "RMB"]  # reference: owl_wms/utils/vis.py:6


def draw_frame_overlay(frame: np.ndarray, mouse: Sequence[float],
                       buttons: Sequence[float]) -> np.ndarray:
    """frame: [H, W, 3] uint8; mouse: (dx, dy); buttons: [n] 0/1.

    Draws a mouse-direction compass (bottom-left) and a row of button
    boxes (bottom), highlighted when pressed.
    """
    from PIL import Image, ImageDraw

    img = Image.fromarray(frame)
    draw = ImageDraw.Draw(img)
    H, W = frame.shape[:2]

    # compass
    cx, cy, r = 30, H - 30, 20
    draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=(255, 255, 255))
    dx, dy = float(mouse[0]), float(mouse[1])
    norm = (dx * dx + dy * dy) ** 0.5
    if norm > 1e-6:
        ux, uy = dx / max(norm, 1.0), dy / max(norm, 1.0)
        draw.line([cx, cy, cx + ux * r, cy + uy * r], fill=(0, 255, 0),
                  width=2)

    # button boxes
    n = len(buttons)
    box_w = max(10, min(28, (W - 70) // max(n, 1)))
    for i in range(n):
        x0 = 60 + i * (box_w + 2)
        y0 = H - 24
        pressed = float(buttons[i]) > 0.5
        fill = (0, 200, 0) if pressed else None
        draw.rectangle([x0, y0, x0 + box_w, y0 + 14],
                       outline=(255, 255, 255), fill=fill)
        label = KEYBINDS[i] if i < len(KEYBINDS) else str(i)
        draw.text((x0 + 2, y0 + 1), label[:2], fill=(255, 255, 255))

    return np.asarray(img)


def draw_frames(video: np.ndarray, mouse: np.ndarray,
                buttons: np.ndarray) -> np.ndarray:
    """video: [n, H, W, 3] uint8; mouse: [n, 2]; buttons: [n, k].
    Reference: owl_wms/utils/vis.py:10-80 draw_frames."""
    return np.stack([
        draw_frame_overlay(video[i], mouse[i], buttons[i])
        for i in range(video.shape[0])
    ])
