"""The networks of LaMa training and its evaluation in the port
(`models/{batchnorm,discriminator,segmentation,inception,generators}.py`,
the training-mode `models/lama.py`) against the JAX package's, with JAX's
variables carried across by `convert` and every BatchNorm's statistics,
scale and bias perturbed from a seed:

- `BatchNorm2d` in train mode: output, input and parameter gradients
  within 1e-5, the updated running statistics within 1e-6 of flax's
  `mutable=["batch_stats"]`; eval mode is `nn.BatchNorm2d`'s bit for bit;
- `NLayerDiscriminator` (eval and train) and the pix2pixHD zoo: every
  output within 1e-5 of max |value|;
- the FFC generator in train mode: output (within 1e-5 of float64, 5e-5
  of JAX's, whose f32 output lies 2.2e-5 from float64), parameter
  gradients (within 1e-4 of float64, and of JAX's within JAX's own
  distance from float64) and the updated running statistics (1e-6)
  against flax.

`tests/test_torch_lama_segm.py` holds the ADE20k and Inception networks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flax.linen as fnn

from spinnerf_tpu.models import discriminator as jdisc
from spinnerf_tpu.models import generators as jgens
from spinnerf_tpu.models import lama as jlama
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.models import batchnorm as tbn
from spinnerf_tpu_torch.models import discriminator as tdisc
from spinnerf_tpu_torch.models import generators as tgens
from spinnerf_tpu_torch.models import lama as tlama

torch.set_num_threads(1)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def perturbed(variables, seed):
    """`variables` as numpy, every BN's scale, bias, mean and variance
    drawn from `seed` (scale and variance in [0.5, 1.5])."""
    rng = np.random.RandomState(seed)
    v = jax.tree.map(np.array, variables)

    def walk(tree, keys):
        for k in sorted(tree):
            node = tree[k]
            if not isinstance(node, dict):
                continue
            if keys <= set(node):
                for leaf in sorted(keys):
                    x = node[leaf]
                    node[leaf] = ((rng.rand(*x.shape) + 0.5) if leaf in (
                        "scale", "var") else rng.randn(*x.shape) * 0.1
                    ).astype(np.float32)
            else:
                walk(node, keys)
    walk(v["params"], {"scale", "bias"})
    walk(v.get("batch_stats", {}), {"mean", "var"})
    return v


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def test_batchnorm_train_and_eval_match_flax():
    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 6, 4) * 2 + 1.5).astype(np.float32)
    g = rng.randn(3, 5, 6, 4).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False)
    v = perturbed(bn.init(jax.random.PRNGKey(0), jnp.asarray(x)), 1)

    def loss(p, xx):
        y, st = bn.apply({"params": p, "batch_stats": v["batch_stats"]}, xx,
                         mutable=["batch_stats"])
        return jnp.sum(y * g), (y, st)
    (_, (want, st)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(v["params"], jnp.asarray(x))
    tb = tbn.BatchNorm2d(4)
    sd = {}
    convert.lama_bn_state(sd, "", v["params"], v["batch_stats"])
    tb.load_state_dict(sd)
    xt = nchw(x).requires_grad_(True)
    tb.train()
    y = tb(xt)
    (y * nchw(g)).sum().backward()
    assert rel(nhwc(y), want) < 1e-5
    assert rel(nhwc(xt.grad), gx) < 1e-5
    assert rel(tb.weight.grad, gp["scale"]) < 1e-5
    assert rel(tb.bias.grad, gp["bias"]) < 1e-5
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        assert np.abs(getattr(tb, name).numpy()
                      - np.asarray(st["batch_stats"][key])).max() < 1e-6
    # eval: nn.BatchNorm2d's inference forward, bit for bit
    ref = torch.nn.BatchNorm2d(4)
    ref.load_state_dict(tb.state_dict())
    tb.eval()
    ref.eval()
    with torch.no_grad():
        assert torch.equal(tb(nchw(x)), ref(nchw(x)))


@pytest.mark.parametrize("train", [False, True])
def test_nlayer_discriminator_matches_jax(train):
    x = np.random.RandomState(1).rand(2, 40, 48, 3).astype(np.float32)
    jd = jdisc.NLayerDiscriminator(ndf=8, n_layers=3)
    v = perturbed(jax.jit(jd.init)(jax.random.PRNGKey(0), jnp.asarray(x)),
                  2)
    td = tdisc.NLayerDiscriminator(ndf=8, n_layers=3, device="cpu")
    td.load_state_dict(convert.discriminator_state_dict(v), strict=True)
    if train:
        (logits, feats), st = jd.apply(v, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
        td.train()
    else:
        logits, feats = jd.apply(v, jnp.asarray(x))
        td.eval()
    with torch.no_grad():
        tl, tf = td(nchw(x))
    assert tl.shape == (2, 1) + tuple(np.asarray(logits).shape[1:3])
    assert rel(nhwc(tl), logits) < 1e-5
    assert len(tf) == len(feats) == 4
    for a, b in zip(tf, feats):
        assert rel(nhwc(a), b) < 1e-5
    if train:
        got = convert.discriminator_state_dict(
            {"params": v["params"], "batch_stats": jax.tree.map(
                np.asarray, st["batch_stats"])})
        for k, want in got.items():
            if "running" in k:
                assert (td.state_dict()[k] - want).abs().max() < 1e-6, k


def test_training_generator_matches_flax():
    """train mode: the batch statistics, the gradient through them, and
    the running statistics updated as flax's mutable batch_stats."""
    kw = dict(ngf=8, n_blocks=1, max_features=32)
    gen = jlama.FFCResNetGenerator(**kw)
    rng = np.random.RandomState(3)
    x = rng.rand(2, 32, 32, 4).astype(np.float32)
    g = rng.randn(2, 32, 32, 3).astype(np.float32)
    v = perturbed(jax.jit(gen.init)(jax.random.PRNGKey(0), jnp.asarray(x)),
                  3)

    def loss(p):
        y, st = gen.apply({"params": p, "batch_stats": v["batch_stats"]},
                          jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, st)
    (_, (want, st)), grads = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(v["params"])
    tgen = tlama.FFCResNetGenerator(**kw, device="cpu")
    tgen.load_state_dict(convert.lama_state_dict(v), strict=True)
    tgen.train()
    y = tgen(nchw(x))
    (y * nchw(g)).sum().backward()
    # train-mode BN on 2 x 4 x 4 maps amplifies f32 rounding: JAX's f32
    # output lies 2.2e-5 from float64 and some of its gradients 1.4e-2
    # (measured; XLA's f32 sums), the port's within 1e-5 and 1e-4. So the
    # port is held to float64, and to JAX within JAX's own distance from
    # float64 (plus 1e-4). The transpose convs' biases feed train-mode
    # BNs, which cancel them: their exact gradient is 0, and f32 leaves
    # noise there, held under 1e-3 of the largest gradient.
    t64 = tlama.FFCResNetGenerator(**kw, device="cpu").double()
    t64.load_state_dict(convert.lama_state_dict(v), strict=True)
    y64 = t64.train()(nchw(x).double())
    (y64 * nchw(g).double()).sum().backward()
    assert rel(nhwc(y), nhwc(y64)) < 1e-5
    assert rel(nhwc(y), want) < 5e-5
    jg = convert.lama_state_dict({"params": jax.tree.map(np.asarray, grads),
                                  "batch_stats": v["batch_stats"]})
    g64 = {n: p.grad.numpy() for n, p in t64.named_parameters()}
    top = max(np.abs(a).max() for a in g64.values())

    def err(a, b):
        return float(np.abs(np.asarray(a, np.float64) - b).max()
                     / np.abs(b).max())
    for name, p in tgen.named_parameters():
        got = p.grad.numpy()
        if np.abs(g64[name]).max() < 1e-10 * top:
            assert np.abs(got).max() < 1e-3 * top, name
            continue
        assert err(got, g64[name]) < 1e-4, name
        assert err(got, jg[name].numpy()) <= \
            err(jg[name].numpy(), g64[name]) + 1e-4, name
    new = convert.lama_state_dict({"params": v["params"],
                                   "batch_stats": jax.tree.map(
                                       np.asarray, st["batch_stats"])})
    sd = tgen.state_dict()
    for k, want_s in new.items():
        if "running" in k:
            assert (sd[k] - want_s).abs().max() < 1e-6, k
    # eval mode afterwards uses the updated statistics, as flax's applied
    # with the new batch_stats
    tgen.eval()
    ev = gen.apply({"params": v["params"], "batch_stats": st["batch_stats"]},
                   jnp.asarray(x))
    with torch.no_grad():
        assert rel(nhwc(tgen(nchw(x))), ev) < 1e-5


def _zoo_case(jmod, tmod, x, to_sd, seed):
    v = perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(seed),
                                     jnp.asarray(x)), seed)
    tmod.load_state_dict(to_sd(v), strict=True)
    return jax.jit(jmod.apply)(v, jnp.asarray(x)), tmod.eval()


@pytest.mark.parametrize("kind", ["pix2pixhd_global",
                                  "pix2pixhd_multidilated"])
def test_global_generators_match_jax(kind):
    kw = dict(ngf=8, n_downsampling=2, n_blocks=1, max_features=32)
    x = np.random.RandomState(8).rand(1, 32, 40, 4).astype(np.float32)
    want, tmod = _zoo_case(
        jgens.make_generator(kind, **kw),
        tgens.make_generator(kind, device="cpu", **kw), x,
        lambda v: convert.flax_state_dict(
            v, transpose=lambda n: n.startswith("up") and "_bn" not in n), 8)
    with torch.no_grad():
        got = nhwc(tmod(nchw(x)))
    assert got.shape == (1, 32, 40, 3)
    assert rel(got, want) < 1e-5


@pytest.mark.parametrize("kind,kw", [
    ("pix2pixhd_nlayer_multidilated", dict(ndf=8, n_layers=3)),
    ("ffc_nlayer", dict(ndf=8, n_layers=3))])
def test_zoo_discriminators_match_jax(kind, kw):
    x = np.random.RandomState(9).rand(2, 32, 32, 3).astype(np.float32)
    to_sd = (convert.ffc_discriminator_state_dict if kind == "ffc_nlayer"
             else convert.flax_state_dict)
    (logits, feats), tmod = _zoo_case(
        jgens.make_discriminator(kind, **kw),
        tgens.make_discriminator(kind, device="cpu", **kw), x, to_sd, 9)
    with torch.no_grad():
        tl, tf = tmod(nchw(x))
    assert rel(nhwc(tl), logits) < 1e-5
    for a, b in zip(tf, feats):
        assert rel(nhwc(a), b) < 1e-5
    for fac in (tgens.make_generator, tgens.make_discriminator):
        with pytest.raises(ValueError, match="Unknown"):
            fac("nope")
