"""The port's MVSeg products (`spinnerf_tpu_torch/pipeline/mvseg.py`)
against the JAX package's, on one semantic `NeRFField`'s parameters carried
from the JAX Trainer to the port's (`convert.fields_state_dicts`) on a
6-view 36 x 44 scene whose masks cover views 0, 2 and 4 (ground truth for
all in `label_full/`):

- `post_opening` equals cv2's MORPH_OPEN (and JAX's) exactly;
- `render_masks` (with and without the opening), `export_masks`' PNGs and
  `evaluate_masks` equal JAX's, except at pixels whose sigmoid(prob) * acc
  lies within 1e-5 of the 0.5 threshold (and, after the 3 x 3 opening,
  their 5 x 5 neighbourhood);
- `render_object_removed` within 1e-5 of JAX's (plain and mask-filtered),
  its random background drawn from the given `torch.Generator`.

The fields are the MLP at 2 octaves (`test_torch_train_step.py`) and the
renders take no importance samples: the importance sampler's last
deterministic sample sits on a discontinuity (its u = 1 against the CDF's
f32 total; `test_torch_lpips_patch.py::
test_frozen_density_seed_4_leaves_jax_at_the_cdf_end`), which moves a
frame's composited logits by up to 1 % here and would make the
comparison a test of that sampler instead."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.config import Config as JConfig
from spinnerf_tpu.data import synthetic
from spinnerf_tpu.pipeline import mvseg as jmv
from spinnerf_tpu.train.loop import Trainer as JTrainer
from spinnerf_tpu_torch.config import Config
from spinnerf_tpu_torch.convert import fields_state_dicts
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.eval.render import read_png
from spinnerf_tpu_torch.pipeline import mvseg as tmv
from spinnerf_tpu_torch.train.loop import Trainer

cv2 = pytest.importorskip("cv2")
torch.set_num_threads(1)


def test_post_opening_equals_cv2():
    rng = np.random.RandomState(0)
    for p in (0.3, 0.7):
        m = (rng.rand(40, 50) < p).astype(np.float32)
        m[5:15, 5:15] = 1
        got = tmv.post_opening(m)
        want = cv2.morphologyEx(m.astype(np.uint8), cv2.MORPH_OPEN,
                                np.ones((3, 3), np.uint8))
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, jmv.post_opening(m))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(scene dir, JAX Trainer, port Trainer) on the same random semantic
    field: scaled-up kernels, a sigma bias of -1 and a semantic bias of
    0.5, so that about a quarter of the pixels are "object" and the
    accumulated alpha varies."""
    d = synthetic.make_scene(tmp_path_factory.mktemp("scene"), n_views=6,
                             h=36, w=44, factor=1, mask_views=[0, 2, 4],
                             gt_mask_subdir="label_full")
    logs = tmp_path_factory.mktemp("logs")

    def cfg(cls, sub):
        return cls(expname="mv", basedir=str(logs / sub), datadir=str(d),
                   factor=1, no_ndc=True, mvseg=True,
                   masks_gt_subdir="label_full", no_tcnn=True,
                   fused_mlp=False, netdepth=2, netwidth=32,
                   netdepth_fine=2, netwidth_fine=32, multires=2,
                   multires_views=2, N_samples=16, N_importance=0,
                   N_rand=64, i_print=0, i_weights=0, i_video=0,
                   i_testset=0, i_feat=0, compute_dtype="float32",
                   llffhold=1000000, chunk=4096)
    jt = JTrainer(cfg(JConfig, "j"), log=lambda *a: None)
    tr = Trainer(cfg(Config, "t"), device="cpu", log=lambda *a: None)
    rng = np.random.RandomState(0)
    params = jax.tree.map(np.array, jt.state.params)
    for tree in params.values():
        for name, layer in tree["params"].items():
            k = layer["kernel"]
            layer["kernel"] = (rng.randn(*k.shape) * 3.0
                               / np.sqrt(k.shape[0])).astype(np.float32)
        tree["params"]["sigma_head"]["bias"][:] = -1.0
        tree["params"]["semantic_head"]["bias"][:] = 0.5
    jt.state.params = jax.tree.map(jnp.asarray, params)
    with torch.no_grad():
        for k, sd in fields_state_dicts(params).items():
            tr.fields[k].load_state_dict(sd, strict=True)
    return d, jt, tr


def _near_threshold(tr, poses, grow=0, **overrides):
    """Pixels whose sigmoid(prob) * acc (the port's render with the render
    config's `overrides`) is within 1e-5 of 0.5, grown by `grow` pixels."""
    ren = tmv._renderer(tr, 0, **overrides)
    near = []
    for c2w in poses:
        maps = ren(c2w)
        v = maps["acc"] / (1.0 + np.exp(-maps["prob"]))
        n = (np.abs(v - 0.5) < 1e-5).astype(np.float32)
        if grow:
            n = tllff.dilate_mask(n, 2 * grow + 1, 1)
        near.append(n > 0)
    return np.stack(near)


@pytest.mark.parametrize("opening", [False, True])
def test_render_masks_match_jax(pair, opening):
    _, jt, tr = pair
    poses = tr.scene.poses
    got = tmv.render_masks(tr, poses, opening=opening)
    want = jmv.render_masks(jt, jt.scene.poses, opening=opening)
    assert got.shape == want.shape == (6, 36, 44)
    assert got.dtype == np.float32
    assert 0.05 < want.mean() < 0.95
    far = ~_near_threshold(tr, poses, grow=2 if opening else 0)
    assert far.mean() > 0.99
    np.testing.assert_array_equal(got[far], want[far])


def test_evaluate_masks_matches_jax(pair):
    _, jt, tr = pair
    pred = tmv.render_masks(tr, tr.scene.poses)
    gt = tr.scene.masks_gt.copy()
    for g in (gt, gt[[0, 2, 4]]):
        got = tmv.evaluate_masks(pred[:len(g)], g)
        want = jmv.evaluate_masks(pred[:len(g)], g)
        assert set(got) == {"accuracy", "iou"}
        for k in got:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
    gt[1] = -1.0        # a view without ground truth is left out
    got = tmv.evaluate_masks(pred, gt)
    keep = [0, 2, 3, 4, 5]
    assert got["iou"] == pytest.approx(
        jmv.evaluate_masks(pred[keep], gt[keep])["iou"], abs=1e-6)
    assert np.isnan(tmv.evaluate_masks(pred[:1], gt[1:2])["iou"])


def test_export_masks_matches_jax(pair):
    d, jt, tr = pair
    kw = dict(opening=True, dilate_iterations=1)
    out_t, masks_t = tmv.export_masks(tr, "label_port", **kw)
    out_j, masks_j = jmv.export_masks(jt, "label_jax", **kw)
    assert out_t == d / "images" / "label_port"
    names = sorted(p.name for p in out_j.glob("*.png"))
    assert names == [f"view{i:03d}.png" for i in range(6)]
    assert sorted(p.name for p in out_t.glob("*.png")) == names
    # the opening reaches 2 pixels, then the 5 x 5 dilation 2 more
    far = ~_near_threshold(tr, tr.scene.poses, grow=4)
    for i, n in enumerate(names):
        a = read_png(out_t / n)
        b = cv2.imread(str(out_j / n), cv2.IMREAD_GRAYSCALE)
        np.testing.assert_array_equal(a[far[i]], b[far[i]])
    np.testing.assert_array_equal(masks_t[far], masks_j[far])
    sc = tllff.load_scene(d, factor=1, mask_subdir="label_port",
                          dilate_iterations=0)
    assert sc.masks.shape == (6, 36, 44)


def test_render_object_removed_matches_jax(pair):
    _, jt, tr = pair
    poses = tr.scene.poses[:2]
    for kw in (dict(), dict(mask_filter=True)):
        got = tmv.render_object_removed(tr, poses, **kw)
        want = jmv.render_object_removed(jt, jt.scene.poses[:2], **kw)
        assert got.shape == want.shape == (2, 36, 44, 3)
        if kw:
            far = ~_near_threshold(tr, poses, only_object=True)
            np.testing.assert_allclose(got[far], want[far], rtol=0,
                                       atol=1e-5)
            # every pixel white or the plain render
            white = np.all(got == 1.0, axis=-1)
            same = np.all(np.abs(got - plain) <= 1e-6, axis=-1)
            assert white.any() and (white | same).all()
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            plain = got
    bg = [tmv.render_object_removed(
        tr, poses, bg_generator=torch.Generator().manual_seed(3))
        for _ in range(2)]
    np.testing.assert_array_equal(bg[0], bg[1])
    colours = torch.rand(2, 3, generator=torch.Generator().manual_seed(3))
    acc = np.stack([tmv._renderer(tr, 0, only_object=True)(c)["acc"]
                    for c in poses])
    np.testing.assert_allclose(
        bg[0], plain + (1.0 - acc[..., None]) * colours.numpy()[:, None,
                                                               None],
        rtol=0, atol=1e-6)
