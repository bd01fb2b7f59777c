"""Interactive mask bootstrapping: click-to-segment, text similarity, and
classical background removal (port of `spinnerf_tpu/pipeline/interactive.py`).

Reference surface (`MVSeg/DS_NeRF/interactive_segmentation.py:5-34` +
`MVSeg/DS_NeRF/run_nerf_helpers.py:439+`): an EISeg (PaddlePaddle) deep
interactive segmenter driven by positive/negative clicks, a matplotlib
click-collection UI, CLIP image-text similarity, and a Canny-contour
background remover.

These are host tools built on other libraries, as in the JAX package:
`ClickSegmenter` runs cv2's GrabCut seeded by the clicks, `bg_remover`
cv2's Canny and contours, `collect_clicks_matplotlib` a matplotlib window,
and `img_txt_similarity` a local transformers CLIP checkpoint. Each imports
its library when called and raises RuntimeError naming the package when it
is not installed (the card's machine has none of the three).
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device


def _require(module: str, package: str, what: str):
    try:
        return importlib.import_module(module)
    except ImportError:
        raise RuntimeError(f"{what} needs {package}, which is not "
                           f"installed") from None


def _uint8_image(image) -> np.ndarray:
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return img


class ClickSegmenter:
    """Positive/negative-click segmentation (the `Segmenter.segment` API).

    Usage:
        seg = ClickSegmenter(image)           # [H, W, 3] float or uint8
        seg.add_click(x, y, positive=True)
        mask = seg.segment()                  # [H, W] float 0/1
    """

    def __init__(self, image, *, iterations: int = 5, radius: int = 7):
        _require("cv2", "cv2 (opencv-python)", "ClickSegmenter")
        self.image = _uint8_image(image)
        self.iterations = iterations
        self.radius = radius
        self.clicks: list[tuple[int, int, bool]] = []

    def add_click(self, x: int, y: int, positive: bool = True):
        self.clicks.append((int(x), int(y), bool(positive)))
        return self

    def reset(self):
        self.clicks.clear()

    def segment(self) -> np.ndarray:
        cv2 = _require("cv2", "cv2 (opencv-python)", "ClickSegmenter")
        if not any(p for _, _, p in self.clicks):
            raise ValueError("need at least one positive click")
        h, w = self.image.shape[:2]
        grab = np.full((h, w), cv2.GC_PR_BGD, np.uint8)
        pos = [(x, y) for x, y, p in self.clicks if p]
        # probable-foreground box around the positive clicks
        xs = np.array([x for x, _ in pos])
        ys = np.array([y for _, y in pos])
        span = max(h, w) // 4
        x0, x1 = max(xs.min() - span, 0), min(xs.max() + span, w - 1)
        y0, y1 = max(ys.min() - span, 0), min(ys.max() + span, h - 1)
        grab[y0:y1 + 1, x0:x1 + 1] = cv2.GC_PR_FGD
        for x, y, p in self.clicks:
            cv2.circle(grab, (x, y),
                       self.radius, int(cv2.GC_FGD if p else cv2.GC_BGD), -1)
        bgd = np.zeros((1, 65), np.float64)
        fgd = np.zeros((1, 65), np.float64)
        cv2.grabCut(self.image, grab, None, bgd, fgd, self.iterations,
                    cv2.GC_INIT_WITH_MASK)
        return ((grab == cv2.GC_FGD) | (grab == cv2.GC_PR_FGD)) \
            .astype(np.float32)


def collect_clicks_matplotlib(image, *, title="left-click: object, "
                              "right-click: background"):
    """Interactive click collection (the `object_selection` UI). Returns the
    click list; requires a display."""
    plt = _require("matplotlib.pyplot", "matplotlib",
                   "collect_clicks_matplotlib")
    clicks = []
    fig, ax = plt.subplots()
    ax.imshow(image)
    ax.set_title(title)

    def onclick(event):
        if event.xdata is None:
            return
        clicks.append((int(event.xdata), int(event.ydata), event.button == 1))
        ax.plot(event.xdata, event.ydata,
                "go" if event.button == 1 else "rx")
        fig.canvas.draw()

    fig.canvas.mpl_connect("button_press_event", onclick)
    plt.show()
    return clicks


def img_txt_similarity(images, texts, *, model_path=None, device=None):
    """CLIP image-text similarity (the `img_txt_similarity` helper), on
    `device` (the card unless "cpu").

    Requires a locally available CLIP checkpoint (`model_path` or a
    transformers cache); nothing is downloaded. Returns [N_images, N_texts]
    similarity logits (numpy)."""
    tf = _require("transformers", "transformers", "img_txt_similarity")
    src = model_path or "openai/clip-vit-base-patch32"
    try:
        model = tf.CLIPModel.from_pretrained(src, local_files_only=True)
        proc = tf.CLIPProcessor.from_pretrained(src, local_files_only=True)
    except (OSError, ValueError) as e:   # ValueError: not a path or hub id
        raise RuntimeError(
            f"no local CLIP checkpoint at {src!r}; pass model_path to a "
            f"local checkpoint") from e
    dev = resolve_device(device)
    model = model.to(dev)
    imgs = [_uint8_image(i) for i in images]
    with torch.no_grad():
        inputs = proc(text=list(texts), images=imgs, return_tensors="pt",
                      padding=True)
        out = model(**{k: v.to(dev) for k, v in inputs.items()})
    return out.logits_per_image.cpu().numpy()


def bg_remover(image, *, canny_lo: int = 50, canny_hi: int = 150,
               close_kernel: int = 9) -> np.ndarray:
    """Classical background removal (the Canny-contour `bg_remover`):
    edge map -> morphological close -> largest contour -> filled mask.

    Returns [H, W] float 0/1 foreground mask.
    """
    cv2 = _require("cv2", "cv2 (opencv-python)", "bg_remover")
    img = _uint8_image(image)
    gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    edges = cv2.Canny(gray, canny_lo, canny_hi)
    kernel = np.ones((close_kernel, close_kernel), np.uint8)
    closed = cv2.morphologyEx(edges, cv2.MORPH_CLOSE, kernel)
    contours, _ = cv2.findContours(closed, cv2.RETR_EXTERNAL,
                                   cv2.CHAIN_APPROX_SIMPLE)
    mask = np.zeros(gray.shape, np.float32)
    if contours:
        largest = max(contours, key=cv2.contourArea)
        cv2.drawContours(mask, [largest], -1, 1.0, -1)
    return mask
