"""The port's mask refinement and correspondence
(`spinnerf_tpu_torch/pipeline/mask_refine.py`, `utils/correspondence.py`)
against the JAX package's numpy on the same inputs, on the CPU.

The views are the analytic plane-and-ball world of `tests/test_mask_refine.py`
(exact surface depths from the tracer, dilated ball masks), turned into
render dumps as `render_path` writes them: float32 depth and disparity with
seeded noise, 8 float32 z samples around the surface with random alpha
peaking there. Refined masks must be equal and the float maps within 1e-12
(both keep the dumps' float32, so they come out bit-equal); correspondences
within 1e-9 (relative above 1) with `valid` equal.
"""
import numpy as np
import pytest
import torch

from spinnerf_tpu.data import synthetic as jsynthetic
from spinnerf_tpu.pipeline import mask_refine as jmr
from spinnerf_tpu.utils import correspondence as jcorr
from spinnerf_tpu_torch.core.rendering import RenderConfig
from spinnerf_tpu_torch.eval import render as eval_render
from spinnerf_tpu_torch.pipeline import mask_refine as mr
from spinnerf_tpu_torch.utils import correspondence as corr

torch.set_num_threads(1)

H, W, FOCAL, S = 40, 52, 60.0, 8


def _view_pose(v, n_views):
    th = 2 * np.pi * v / n_views
    pos = np.array([3.5 * np.cos(th), 3.5 * np.sin(th), 2.0])
    c2w3 = jsynthetic.look_at_pose(pos, target=(0, 0, 0.3))
    return np.concatenate([c2w3, [[0, 0, 0, 1]]], 0)


def make_arrays(n_views=5, seed=0, dilate=4, noise=2e-3):
    """Per view the numpy maps of a render dump (float32 like
    `render_path`'s; c2w float64 like `np.loadtxt`'s)."""
    import cv2
    rng = np.random.RandomState(seed)
    views = []
    for v in range(n_views):
        c2w = _view_pose(v, n_views)
        rgb, t, hit = jsynthetic.render_view(c2w[:3], H, W, FOCAL)
        t = np.nan_to_num(t, posinf=20.0)
        depth = (t * (1 + noise * rng.randn(H, W))).astype(np.float32)
        mask = cv2.dilate(hit.astype(np.uint8), np.ones((5, 5), np.uint8),
                          iterations=dilate).astype(np.float32)
        offs = np.sort(rng.uniform(-0.08, 0.08, (H, W, S)), -1)
        z = (depth[..., None] * (1 + offs)).astype(np.float32)
        alpha = rng.uniform(0, 0.3, (H, W, S))
        near = np.abs(offs).argmin(-1)
        np.put_along_axis(alpha, near[..., None], 0.9, -1)
        views.append(dict(image=rgb.astype(np.float32), mask=mask, z=z,
                          alpha=alpha.astype(np.float32), depth=depth,
                          disp=(1.0 / depth).astype(np.float32), c2w=c2w))
    return views


def jax_dumps(arrays):
    return [jmr.ViewDump(**a) for a in arrays]


def port_dumps(arrays):
    return [mr.ViewDump(**{k: torch.from_numpy(v) for k, v in a.items()})
            for a in arrays]


@pytest.fixture(scope="module")
def arrays():
    return make_arrays()


def assert_same(got, want):
    img, mask, disp = (t.numpy() for t in got)
    assert img.dtype == want[0].dtype and disp.dtype == want[2].dtype
    np.testing.assert_array_equal(mask, want[1])
    assert np.abs(img - want[0]).max() <= 1e-12
    assert np.abs(disp.astype(np.float64) - want[2]).max() <= 1e-12


@pytest.mark.parametrize("alpha_thresh,distance_thresh",
                         [(0.1, 0.01), (0.5, 0.05), (0.1, 0.002)])
def test_refine_view_matches_jax(arrays, alpha_thresh, distance_thresh):
    """Each source against all five views: several targets un-mask and
    re-paste pixels, so the live disparity map and the re-refinement gate
    are on the path."""
    jd, pd = jax_dumps(arrays), port_dumps(arrays)
    kw = dict(focal=FOCAL, cx=W / 2, cy=H / 2, alpha_thresh=alpha_thresh,
              distance_thresh=distance_thresh)
    freed = 0
    for src in (0, 2, 4):
        want = jmr.refine_view(jd[src], jd, **kw)
        got = mr.refine_view(pd[src], pd, **kw)
        assert_same(got, want)
        freed += int((arrays[src]["mask"] > 0.5).sum() - want[1].sum())
    assert freed > 50


def test_later_targets_re_refine(arrays):
    """A second target whose surface is a little closer passes the gate
    (`src_disp < 1/z`) on pixels the first already freed: the result
    differs from the first target's alone, in both packages alike."""
    near = dict(arrays[1], disp=(arrays[1]["disp"] * 1.004)
                .astype(np.float32))
    views = [arrays[0], arrays[1], near]
    kw = dict(focal=FOCAL, cx=W / 2, cy=H / 2, distance_thresh=0.02)
    jd, pd = jax_dumps(views), port_dumps(views)
    one = jmr.refine_view(jd[0], jd[:2], **kw)
    want = jmr.refine_view(jd[0], jd, **kw)
    assert_same(mr.refine_view(pd[0], pd, **kw), want)
    re_pasted = (one[1] < 0.5) & (want[2] != one[2])
    assert re_pasted.sum() > 10


def test_first_valid_sample_is_taken():
    """argmax of the integer cast takes the first of several valid samples,
    as np.argmax of the boolean does."""
    valid = torch.tensor([[0, 1, 1, 0, 1], [1, 1, 1, 1, 1], [0, 0, 0, 0, 1]],
                         dtype=torch.bool)
    assert torch.argmax(valid.to(torch.int32), dim=-1).tolist() == \
        np.argmax(valid.numpy(), axis=-1).tolist() == [1, 0, 4]


def test_refine_all_writes_jax_layout(arrays, tmp_path):
    jd, pd = jax_dumps(arrays[:3]), port_dumps(arrays[:3])
    kw = dict(focal=FOCAL, cx=W / 2, cy=H / 2, distance_thresh=0.02)
    names = ["a.png", "b.png", "c.png"]
    jmr.refine_all(jd, out_dir=tmp_path / "jax", names=names, **kw)
    mr.refine_all(pd, out_dir=tmp_path / "port", names=names, **kw)
    for sub in ("refined_images", "refined_images/label", "refined_disp"):
        for n in names:
            a = eval_render.read_png(tmp_path / "jax" / sub / n)
            b = eval_render.read_png(tmp_path / "port" / sub / n)
            assert a.dtype == b.dtype == np.uint8
            np.testing.assert_array_equal(b, a)
    freed = eval_render.read_png(tmp_path / "port" / "refined_images" /
                                 "label" / "a.png")
    assert (freed < 128).sum() > (arrays[0]["mask"] < 0.5).sum()


def _toy_field(pts, viewdirs):
    """A fixed analytic field: a soft ball of density and a colour ramp."""
    r2 = (pts ** 2).sum(-1, keepdim=True)
    return torch.cat([torch.sigmoid(pts), 8.0 * torch.exp(-2.0 * r2)], -1)


def test_load_view_dumps_reads_a_port_render_tree(tmp_path):
    poses = np.stack([_view_pose(v, 3)[:3] for v in range(3)])
    poses = torch.from_numpy(poses.astype(np.float32))
    cfg = RenderConfig(n_samples=6, n_importance=3, perturb=False)
    eval_render.render_path(poses, (12, 16, 14.0), _toy_field, cfg, near=1.0,
                            far=6.0, save_dir=tmp_path, save_alpha=True,
                            device="cpu")
    rng = np.random.RandomState(1)
    masks = [rng.uniform(-1, 1, (12, 16)).astype(np.float32)
             for _ in range(3)]
    want = jmr.load_view_dumps(tmp_path, masks)
    got = mr.load_view_dumps(tmp_path, masks, device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("image", "mask", "z", "alpha", "depth", "disp", "c2w"):
            a = getattr(g, k)
            b = getattr(w, k)
            assert a.dtype == torch.from_numpy(b).dtype, k
            np.testing.assert_array_equal(a.numpy(), b)


def test_weight_argmax_depth_matches_jax():
    rng = np.random.RandomState(2)
    z = np.sort(rng.uniform(1, 5, (6, 7, 9)), -1).astype(np.float32)
    wts = rng.randint(0, 4, (6, 7, 9)).astype(np.float32)   # with ties
    got = corr.weight_argmax_depth(torch.from_numpy(z), torch.from_numpy(wts))
    np.testing.assert_array_equal(got.numpy(),
                                  jcorr.weight_argmax_depth(z, wts))


@pytest.mark.parametrize("pair", [(0, 1), (0, 2), (3, 4)])
def test_reproject_correspondences_matches_jax(arrays, pair):
    a, b = (arrays[i] for i in pair)
    kw = dict(focal=FOCAL, cx=W / 2, cy=H / 2)
    uv_j, valid_j = jcorr.reproject_correspondences(
        a["depth"], a["c2w"], b["c2w"], b["depth"], **kw)
    uv, valid = corr.reproject_correspondences(
        torch.from_numpy(a["depth"]), torch.from_numpy(a["c2w"]),
        torch.from_numpy(b["c2w"]), torch.from_numpy(b["depth"]), **kw)
    assert uv.dtype == torch.float64
    # relative: points behind B project to ~1e12 through the 1e-9 clamp
    assert (np.abs(uv.numpy() - uv_j) / np.maximum(np.abs(uv_j), 1)).max() \
        <= 1e-9
    np.testing.assert_array_equal(valid.numpy(), valid_j)
    assert 0 < valid_j.sum() < valid_j.size
