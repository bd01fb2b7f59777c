"""The ADE20k segmentation networks and the FID InceptionV3 of the port
(`models/segmentation.py`, `models/inception.py`) against the JAX
package's, with JAX's variables carried across by `convert` and every
BatchNorm perturbed from a seed (`test_torch_lama_nets.perturbed`):

- `ResNetDilated` + `PPMDecoder` (depth 18, and 50 once): the stage
  features and the logits within 1e-5 of max |value|;
- one MIT encoder / decoder file (the decoder with its deep supervision
  head) read alike by the port and by JAX's converters; the resnet_pl loss
  within 1e-6 and its gradient within 1e-5;
- `random_inception_params` equal to JAX's from the same seed;
  `inception_pool3` at 128^2 and 320^2 (both resize directions) within
  1e-5; one torchvision-format InceptionV3 file folded alike;
- `segmentation_class_stats` / `segmentation_aware_scores` equal."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models import inception as jinc
from spinnerf_tpu.models import segmentation as jseg
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.models import inception as tinc
from spinnerf_tpu_torch.models import segmentation as tseg

from test_torch_lama_nets import nchw, nhwc, perturbed, rel

torch.set_num_threads(1)


def _seg_pair(depth, hw, seed):
    model = jseg.SegmentationModel(depth=depth)
    x = np.random.RandomState(seed).rand(1, hw, hw, 3).astype(np.float32)
    v = perturbed(jax.jit(model.init)(jax.random.PRNGKey(seed),
                                      jnp.asarray(x)), seed)
    tmodel = tseg.SegmentationModel(depth, device="cpu")
    tmodel.load_state_dict(convert.segmentation_state_dict(v), strict=True)
    return model, v, tmodel.eval(), x


@pytest.mark.parametrize("depth,hw", [(18, 56), (50, 48)])
def test_segmentation_model_matches_jax(depth, hw):
    model, v, tmodel, x = _seg_pair(depth, hw, depth)
    xi = jseg.imagenet_normalize(jnp.asarray(x))
    want = np.asarray(jax.jit(model.apply)(v, xi))
    feats = jax.jit(lambda vv, a: jseg.ResNetDilated(depth=depth).apply(
        {"params": vv["params"]["encoder"],
         "batch_stats": vv["batch_stats"]["encoder"]}, a))(v, xi)
    with torch.no_grad():
        ti = tseg.imagenet_normalize(nchw(x))
        assert rel(nhwc(ti), xi) < 1e-6
        tf = tmodel.encoder(ti)
        got = nhwc(tmodel(ti))
    assert got.shape == (1, hw, hw, tseg.NUM_ADE20K_CLASSES)
    assert tf[-1].shape[2] == hw // 8          # output stride 8
    for a, b in zip(tf, feats):
        assert rel(nhwc(a), b) < 1e-5
    assert rel(got, want) < 1e-5


def test_mit_files_load_like_jax(tmp_path):
    """The MIT encoder and decoder files (the decoder with its deep
    supervision head) load strictly into the port and through JAX's
    converters to the same network."""
    model, v, tmodel, x = _seg_pair(18, 40, 5)
    enc_path, dec_path = tmp_path / "enc.pth", tmp_path / "dec.pth"
    torch.save(tmodel.encoder.state_dict(), enc_path)
    dec = dict(tmodel.decoder.state_dict())
    dec["cbr_deepsup.0.weight"] = torch.zeros(128, 256, 3, 3)
    dec["conv_last_deepsup.weight"] = torch.zeros(150, 128, 1, 1)
    torch.save({"state_dict": dec}, dec_path)
    pm, is_real = tseg.load_segmentation_model(enc_path, dec_path, depth=18,
                                               device="cpu")
    assert is_real
    jm, jv, _ = jseg.load_segmentation_model(str(enc_path), str(dec_path),
                                             depth=18)
    xi = jseg.imagenet_normalize(jnp.asarray(x))
    with torch.no_grad():
        got = nhwc(pm(tseg.imagenet_normalize(nchw(x))))
    assert rel(got, jax.jit(jm.apply)(jv, xi)) < 1e-5
    assert rel(got, jax.jit(model.apply)(v, xi)) < 1e-5


def test_resnet_pl_matches_jax(tmp_path):
    enc = jseg.ResNetDilated(depth=18)
    rng = np.random.RandomState(6)
    pred = rng.rand(2, 32, 40, 3).astype(np.float32)
    tgt = rng.rand(2, 32, 40, 3).astype(np.float32)
    v = perturbed(jax.jit(enc.init)(jax.random.PRNGKey(6),
                                    jnp.asarray(pred)), 6)
    te = tseg.ResNetDilated(18, device="cpu")
    te.load_state_dict(convert.segmentation_state_dict(v), strict=True)
    path = tmp_path / "enc18.pth"
    torch.save(te.state_dict(), path)
    jloss, _ = jseg.make_resnet_pl(depth=18, weights_path=str(path))
    tloss, _ = tseg.make_resnet_pl(depth=18, weights_path=path,
                                   device="cpu")
    want, wg = jax.value_and_grad(jloss)(jnp.asarray(pred), jnp.asarray(tgt))
    p = nchw(pred).requires_grad_(True)
    got = tloss(p, nchw(tgt))
    got.backward()
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert rel(nhwc(p.grad), wg) < 1e-5


def test_inception_random_params_equal_jax():
    jp = jinc.random_inception_params(3)
    want = convert.inception_state_dict(jax.tree.map(np.asarray, jp))
    got = tinc.random_inception_params(3)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    net = tinc.FIDInceptionV3(device="cpu")
    net.load_state_dict(want, strict=True)


@pytest.fixture(scope="module")
def inception_pair():
    return (jinc.random_inception_params(0),
            tinc.load_inception(seed=0, device="cpu"))


@pytest.mark.parametrize("side", [128, 320])
def test_inception_pool3_matches_jax(inception_pair, side):
    jp, net = inception_pair
    x = np.random.RandomState(side).rand(2, side, side + 8, 3).astype(
        np.float32)
    want = np.asarray(jax.jit(jinc.inception_pool3)(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = net(nchw(x)).numpy()
    assert got.shape == (2, tinc.FEATURE_DIM)
    assert rel(got, want) < 1e-5


def test_inception_torch_file_reads_like_jax(tmp_path):
    """A torchvision-format file (conv + BN per BasicConv2d) folds to the
    same parameters in both packages."""
    rng = np.random.RandomState(7)
    sd = {}
    for kind, name, specs in tinc.BLOCKS:
        for s in specs:
            pre = name if s[0] is None else f"{name}.{s[0]}"
            _, cin, cout, (kh, kw), _, _ = s
            sd[f"{pre}.conv.weight"] = torch.from_numpy(
                (rng.randn(cout, cin, kh, kw) / np.sqrt(cin * kh * kw))
                .astype(np.float32))
            sd[f"{pre}.bn.weight"] = torch.from_numpy(
                (rng.rand(cout) + 0.5).astype(np.float32))
            sd[f"{pre}.bn.bias"] = torch.from_numpy(
                (rng.randn(cout) * 0.1).astype(np.float32))
            sd[f"{pre}.bn.running_mean"] = torch.from_numpy(
                (rng.randn(cout) * 0.1).astype(np.float32))
            sd[f"{pre}.bn.running_var"] = torch.from_numpy(
                (rng.rand(cout) + 0.5).astype(np.float32))
    path = tmp_path / "pt_inception.pth"
    torch.save(sd, path)
    want = convert.inception_state_dict(jax.tree.map(
        np.asarray, jinc.load_inception_params_from_torch(path)))
    got = tinc.load_inception_params_from_torch(path)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_segmentation_stats_equal_jax():
    rng = np.random.RandomState(10)
    pred = rng.randint(0, 5, (16, 20))
    tgt = rng.randint(0, 5, (16, 20))
    assert tseg.segmentation_class_stats(pred, tgt, num_class=6) == \
        jseg.segmentation_class_stats(pred, tgt, num_class=6)
    a = rng.rand(16, 20, 3)
    b = rng.rand(16, 20, 3)
    assert tseg.segmentation_aware_scores(a, b, tgt, num_class=6) == \
        jseg.segmentation_aware_scores(a, b, tgt, num_class=6)
