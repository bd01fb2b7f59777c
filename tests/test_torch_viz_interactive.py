"""The port's drawing helpers (`spinnerf_tpu_torch/utils/visualization.py`:
`draw_keypoints`, `visualize_sigma`) and interactive mask tools
(`pipeline/interactive.py`) against the JAX package's, on the CPU.

`draw_keypoints` fills discs without cv2: equal pixel for pixel to the JAX
package's cv2.circle at radii 0-5, centres inside, on and outside the
border. `visualize_sigma` rasterises the curve without matplotlib: each
point's pixel on the curve, every curve pixel within one pixel of the
polyline, the frame drawn. `ClickSegmenter` and `bg_remover` run the same
cv2 calls as the JAX package (equal masks); each tool without its library
raises RuntimeError naming the package.
"""
import sys

import numpy as np
import pytest
import torch

from spinnerf_tpu.pipeline import interactive as jint
from spinnerf_tpu.utils import visualization as jviz
from spinnerf_tpu_torch.eval.render import read_png
from spinnerf_tpu_torch.pipeline import interactive as pint
from spinnerf_tpu_torch.utils import visualization as pviz

torch.set_num_threads(1)

# centres inside, on the border and outside it (19 x 23 image), with
# fractional coordinates truncated as int() truncates
XS = (-4, -1, -0.5, 0, 0.7, 1, 2, 11, 20, 21, 22, 22.9, 23, 25)
YS = (-3, -0.2, 0, 1, 3, 9, 17, 18, 19, 22)


@pytest.mark.parametrize("radius", range(6))
def test_draw_keypoints_matches_cv2(radius):
    img = np.random.RandomState(radius).rand(19, 23, 3)
    pts = [(x, y) for x in XS for y in YS]
    for p in pts:
        np.testing.assert_array_equal(
            pviz.draw_keypoints(img, [p], radius=radius),
            jviz.draw_keypoints(img, [p], radius=radius), err_msg=str(p))
    np.testing.assert_array_equal(
        pviz.draw_keypoints(img, pts, radius=radius, color=(10, 200, 30)),
        jviz.draw_keypoints(img, pts, radius=radius, color=(10, 200, 30)))


def _segment_distance(p, a, b):
    ab = b - a
    t = np.clip(((p - a) @ ab) / max(ab @ ab, 1e-12), 0, 1)
    return np.linalg.norm(p - (a + t[:, None] * ab), axis=-1)


def test_visualize_sigma_raster_follows_the_curve(tmp_path):
    z = np.linspace(2.0, 6.0, 64)
    sigma = np.maximum(0.0, np.sin(3 * z)) * 40.0
    img = pviz.visualize_sigma(sigma, z, tmp_path / "rays.png")
    np.testing.assert_array_equal(read_png(tmp_path / "rays.png"), img)
    h, w = pviz.SIGMA_PLOT_SIZE
    left, top, right, bottom = pviz.SIGMA_PLOT_BOX
    assert img.shape == (h, w, 3)
    # the frame
    assert (img[top, left:right + 1] == 0).all()
    assert (img[bottom, left:right + 1] == 0).all()
    assert (img[top:bottom + 1, left] == 0).all()
    assert (img[top:bottom + 1, right] == 0).all()
    cols, rows = pviz.sigma_plot_coords(sigma, z)
    # the curve spans the box, padded by 5 %, with the largest sigma on top
    assert left < cols.min() < cols.max() < right
    assert top < rows.min() < rows.max() < bottom
    assert rows[np.argmax(sigma)] == rows.min()
    curve = np.all(img == np.array([31, 119, 180], np.uint8), axis=-1)
    # every point's pixel is on the curve
    assert curve[np.rint(rows).astype(int), np.rint(cols).astype(int)].all()
    # every curve pixel lies within a pixel of the polyline
    ry, rx = np.nonzero(curve)
    pix = np.stack([rx, ry], -1).astype(np.float64)
    pts = np.stack([cols, rows], -1)
    d = np.min([_segment_distance(pix, pts[k], pts[k + 1])
                for k in range(len(pts) - 1)], axis=0)
    assert d.max() <= 1.0
    # nothing else is drawn
    inside = np.zeros((h, w), bool)
    inside[top:bottom + 1, left:right + 1] = True
    assert (img[~inside] == 255).all()


def test_visualize_sigma_degenerate_inputs(tmp_path):
    """One point, a constant curve, and non-finite samples dropped."""
    one = pviz.visualize_sigma([3.0], [2.0], tmp_path / "a.png")
    flat = pviz.visualize_sigma(np.zeros(5), np.arange(5.0), tmp_path / "b.png")
    nan = pviz.visualize_sigma([1.0, np.nan, 2.0], [1.0, 2.0, 3.0],
                               tmp_path / "c.png")
    for img in (one, flat, nan):
        assert (np.all(img == [31, 119, 180], axis=-1)).sum() >= 1


def _object_image():
    rng = np.random.RandomState(0)
    img = np.full((60, 80, 3), 0.15) + 0.05 * rng.rand(60, 80, 3)
    yy, xx = np.mgrid[:60, :80]
    img[(yy - 30) ** 2 + (xx - 42) ** 2 < 15 ** 2] = (0.9, 0.6, 0.2)
    return img


def test_click_segmenter_matches_jax():
    img = _object_image()
    jseg, pseg = jint.ClickSegmenter(img), pint.ClickSegmenter(img)
    for seg in (jseg, pseg):
        seg.add_click(42, 30).add_click(40, 28).add_click(5, 5,
                                                          positive=False)
    want, got = jseg.segment(), pseg.segment()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and 100 < got.sum() < 60 * 80 - 100
    pseg.reset()
    with pytest.raises(ValueError, match="positive click"):
        pseg.segment()


def test_bg_remover_matches_jax():
    img = _object_image()
    got = pint.bg_remover(img)
    np.testing.assert_array_equal(got, jint.bg_remover(img))
    assert 500 < got.sum() < 60 * 80 / 2


def test_tools_name_their_missing_package(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        pint.ClickSegmenter(np.zeros((4, 4, 3)))
    with pytest.raises(RuntimeError, match="cv2"):
        pint.bg_remover(np.zeros((4, 4, 3)))
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        pint.collect_clicks_matplotlib(np.zeros((4, 4, 3)))


def test_img_txt_similarity_raises_without_a_checkpoint(tmp_path):
    """No transformers here, or no CLIP checkpoint at the path: either way
    a RuntimeError that says which."""
    with pytest.raises(RuntimeError, match="transformers|CLIP checkpoint"):
        pint.img_txt_similarity([np.zeros((8, 8, 3))], ["a ball"],
                                model_path=str(tmp_path / "none"),
                                device="cpu")
