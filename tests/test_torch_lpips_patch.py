"""The port's patch-LPIPS loss (`train/lpips_patch.py`) and the train step's
LPIPS term and frozen-density mode (`train/step.py`) against the JAX
package's, on a 64 x 80 scene with masks (16 x 20 patches at render factor
2 and patch factor 2), f32, both LPIPS loaded from the same
torchvision-format files of random weights.

- mask boxes, anchor ranges and targets equal JAX's exactly; the patch rays
  equal the JAX module's formula within 1e-6;
- the loss at JAX's views and anchors (derived from the same key) within
  1e-5 relative, on the small hash field and on `NeRFField`: the port
  renders the patches as one ray batch, JAX one patch at a time;
- a patch side under 16 raises ValueError where JAX's loss is NaN;
- one train step with the LPIPS term (step 301), and one with the frozen
  density (hash grid and `NeRFField`, over several frozen seeds; NeRFField
  at seed 4 leaves JAX at one importance sample on the sampler's CDF end,
  which its own test pins), at `test_torch_train_step.py`'s
  tolerances: loss terms within 1e-5 relative, gradients within 1e-4
  relative (max-normalised per parameter), parameters after Adam within
  1e-6; at step 300 the term is 0 and the update is the one without it."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spinnerf_tpu.core import rays as jrays
from spinnerf_tpu.core.rendering import RenderConfig as JRenderConfig
from spinnerf_tpu.data import llff, synthetic
from spinnerf_tpu.data import raybank as jraybank
from spinnerf_tpu.models.fields import NeRFField as JNeRF
from spinnerf_tpu.models.hashgrid import HashGridField as JField
from spinnerf_tpu.models.lpips import load_lpips as jload_lpips
from spinnerf_tpu.train import lpips_patch as jpatch
from spinnerf_tpu.train import schedule as jschedule
from spinnerf_tpu.train import step as jstep
from spinnerf_tpu_torch.convert import fields_state_dicts
from spinnerf_tpu_torch.core.rendering import RenderConfig as TRenderConfig
from spinnerf_tpu_torch.data import llff as tllff
from spinnerf_tpu_torch.data import raybank as traybank
from spinnerf_tpu_torch.models.fields import NeRFField as TNeRF
from spinnerf_tpu_torch.models.hashgrid import HashGridField as TField
from spinnerf_tpu_torch.models import lpips as tlpips
from spinnerf_tpu_torch.train import lpips_patch as tpatch
from spinnerf_tpu_torch.train import schedule as tschedule
from spinnerf_tpu_torch.train import step as tstep

torch.set_num_threads(1)

SMALL = dict(bound=4.0, n_levels=6, log2_table_size=13, base_res=4,
             finest_res_per_unit=64.0, hidden_dim=16, hidden_dim_color=16)
# 2 octaves: see `tests/test_torch_train_step.py`
SMALL_MLP = dict(depth=3, width=32, multires=2, multires_views=2)
RF, PLF = 2, 2
# the train step's Adam bound: see `tests/test_torch_train_step.py`
LRATE, DECAY = 1e-4, 0.001


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


# torchvision's VGG16 `features` index of each of the 13 convolutions
TV_CONV_INDEX = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)


def _write_lpips_files(d, seed=0):
    """Random lecun-scaled VGG16 weights (torchvision's `features.*`) and
    non-negative heads (`lin{i}.model.1.weight`) for both loaders."""
    rng = np.random.RandomState(seed)
    sd, c_in = {}, 3
    for idx, (ch, _, _) in zip(TV_CONV_INDEX, tlpips._VGG_PLAN):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            (rng.randn(ch, c_in, 3, 3) / np.sqrt(9 * c_in)).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.zeros(ch)
        c_in = ch
    torch.save(sd, d / "vgg16.pth")
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(
        rng.rand(1, c, 1, 1).astype(np.float32) / c)
        for i, c in enumerate(tlpips.FEATURE_CHANNELS)},
        d / "lpips_vgg_lin.pth")
    return str(d / "vgg16.pth"), str(d / "lpips_vgg_lin.pth")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The fit-mode scene (inpainted RGB), its port copy and the LPIPS
    pair."""
    d = synthetic.make_scene(tmp_path_factory.mktemp("scene"), n_views=5,
                             h=64, w=80, factor=1, n_points=300)
    jsc = llff.load_scene(d, factor=1)
    tsc = tllff.Scene(**{f.name: getattr(jsc, f.name)
                         for f in dataclasses.fields(llff.Scene)})
    files = _write_lpips_files(tmp_path_factory.mktemp("weights"))
    return (jsc, tsc, jload_lpips(*files),
            tlpips.load_lpips(*files, device="cpu"))


def _models(kind, jsc):
    """(JAX module, port field factory), f32; the hash grid with the scene's
    calibration, as the trainers pin it."""
    if kind == "nerf":
        return (JNeRF(**SMALL_MLP, compute_dtype=jnp.float32),
                lambda: TNeRF(**SMALL_MLP, compute_dtype=torch.float32,
                              device="cpu"))
    from spinnerf_tpu.train import loop as jloop
    jmodel = JField(**SMALL, impl="win_xla", compute_dtype=jnp.float32)
    jbank = jraybank.build_raybank(jsc, np.arange(len(jsc.images)))
    bounds, boxes = jloop._scene_hash_calibration(jbank, jmodel)
    return (jmodel.clone(page_bounds=bounds, dense_box=boxes),
            lambda: TField(**SMALL, compute_dtype=torch.float32,
                           page_bounds=bounds, dense_box=boxes, device="cpu"))


def _params(jmodel, seed):
    params = jstep.init_params(jmodel, jax.random.PRNGKey(seed),
                               n_importance=6)
    rng = np.random.RandomState(seed)
    for k in params:
        p = params[k]["params"]
        if "encoder" in p:     # a trained-looking table
            p["encoder"]["table"] = jnp.asarray(rng.randn(
                *p["encoder"]["table"].shape).astype(np.float32) * 0.3)
    return params


def _load(fields, params):
    with torch.no_grad():
        for k, sd in fields_state_dicts(
                jax.tree.map(np.asarray, params)).items():
            for name, p in fields[k].named_parameters():
                p.copy_(sd[name])


def _jax_draws(key, batch_size, n_views):
    """The views and anchor uniforms JAX's patch function derives from its
    key (`spinnerf_tpu/train/lpips_patch.py:135-142`)."""
    keys = jax.random.split(key, batch_size + 1)
    views = np.array(jax.random.permutation(keys[0], n_views)[:batch_size])
    u = np.stack([np.array(jax.random.uniform(
        jax.random.split(keys[i + 1])[0], (2,))) for i in range(batch_size)])
    return views, u


RCFG = dict(n_samples=12, n_importance=6, lindisp=True, white_bkgd=True)


def _patch_fns(jsc, tsc, jlp, tlp, jmodel, fields, batch_size, **kw):
    i_train = np.arange(len(jsc.images))
    common = dict(near=jsc.near, far=jsc.far, lpips_render_factor=RF,
                  patch_len_factor=PLF, batch_size=batch_size, **kw)
    # the train render's jitter and noise: the patch functions turn them off
    jfn = jpatch.make_patch_lpips_fn(
        jmodel, jsc, i_train, lpips=jlp,
        render=JRenderConfig(**RCFG, perturb=True, raw_noise_std=1.0),
        **common)
    tfn = tpatch.make_patch_lpips_fn(
        fields, tsc, i_train, lpips=tlp,
        render=TRenderConfig(**RCFG, perturb=True, raw_noise_std=1.0),
        **common)
    return jfn, tfn


def test_boxes_anchor_ranges_and_targets_match_jax(scene):
    jsc, _, _, _ = scene
    rng = np.random.RandomState(0)
    masks = (rng.rand(4, 30, 44) > 0.97).astype(np.float32)
    masks[1] = 0.0                      # empty: the full frame
    masks[2] *= -1.0                    # negated (LPIPS-mode) views count
    for rf in (1, 2, 3):
        np.testing.assert_array_equal(tpatch.mask_bboxes(masks, rf),
                                      jpatch.mask_bboxes(masks, rf))
    jfn = jpatch.make_patch_lpips_fn(
        JField(**SMALL), jsc, np.arange(1, 5), lpips=None,
        render=JRenderConfig(), near=jsc.near, far=jsc.far,
        lpips_render_factor=RF, patch_len_factor=PLF)
    ph, pw = tpatch.patch_size(jsc.hwf, RF, PLF)
    assert (ph, pw) == (16, 20)
    lo, hi = tpatch.anchor_ranges(jsc.masks[1:], RF, ph, pw)
    np.testing.assert_array_equal(lo, np.asarray(jfn.consts["lo"]))
    np.testing.assert_array_equal(hi, np.asarray(jfn.consts["hi"]))
    assert (hi >= lo).all() and (hi > lo).any()
    np.testing.assert_array_equal(tpatch.patch_targets(jsc.images[1:], RF),
                                  np.asarray(jfn.consts["targets"]))


@pytest.mark.parametrize("ndc", [False, True])
def test_patch_rays_match_jax_formula(scene, ndc):
    """The JAX module's pixel rays (`lpips_patch.py:98-113`: no half-pixel
    offset, NDC after the view directions) for three anchors."""
    jsc, _, _, _ = scene
    h, w, focal = jsc.hwf
    hh, ww, ff = h // RF, w // RF, focal / RF
    ph, pw = 16, 20
    anchors = np.array([[0, 0], [7, 3], [16, 20]])
    poses = jsc.poses[[0, 3, 4]].astype(np.float32)
    anchors_t = torch.from_numpy(anchors)
    ro, rd, vd = tpatch.patch_rays(
        torch.from_numpy(poses), anchors_t[:, 0:1] + torch.arange(ph),
        anchors_t[:, 1:2] + torch.arange(pw), (hh, ww, ff), ndc)
    for b, (r0, c0) in enumerate(anchors):
        rr = (r0 + jnp.arange(ph))[:, None] * jnp.ones((1, pw))
        cc = (c0 + jnp.arange(pw))[None, :] * jnp.ones((ph, 1))
        x = cc.reshape(-1).astype(jnp.float32)
        y = rr.reshape(-1).astype(jnp.float32)
        c2w = jnp.asarray(poses[b])
        dirs = jnp.stack([(x - ww * 0.5) / ff, -(y - hh * 0.5) / ff,
                          -jnp.ones_like(x)], -1)
        rays_d = dirs @ c2w[:3, :3].T
        rays_o = jnp.broadcast_to(c2w[:3, 3], rays_d.shape)
        if ndc:
            np.testing.assert_allclose(
                vd[b].numpy(), np.asarray(rays_d / jnp.linalg.norm(
                    rays_d, axis=-1, keepdims=True)), rtol=0, atol=1e-6)
            rays_o, rays_d = jrays.ndc_rays(hh, ww, ff, 1.0, rays_o, rays_d)
        else:
            assert vd is None
        np.testing.assert_allclose(ro[b].numpy(), np.asarray(rays_o),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(rd[b].numpy(), np.asarray(rays_d),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind,batch_size", [("hash", 2), ("nerf", 6)])
def test_patch_loss_matches_jax(scene, kind, batch_size):
    """batch 6 over 5 views takes view i % 5, as JAX does."""
    jsc, tsc, jlp, tlp = scene
    jmodel, make_field = _models(kind, jsc)
    params = _params(jmodel, 1)
    fields = torch.nn.ModuleDict({k: make_field() for k in params})
    _load(fields, params)
    jfn, tfn = _patch_fns(jsc, tsc, jlp, tlp, jmodel, fields, batch_size)
    key = jax.random.PRNGKey(7)
    want = float(jax.jit(jfn)(jfn.consts, params, key))
    views, u = _jax_draws(key, batch_size, len(jsc.images))
    got = tfn(views=views, u=u)
    assert np.isfinite(want) and want > 0
    assert rel(got.detach().numpy(), want) < 1e-5
    assert tfn.start_iter == jfn.start_iter == 300
    # the port's own draws: in range, deterministic for a seed
    g = [tfn(torch.Generator().manual_seed(3)).item() for _ in range(2)]
    assert g[0] == g[1] and np.isfinite(g[0])


def test_patch_under_16_raises_where_jax_gives_nan(scene):
    """A 60 x 80 frame at factors 2 and 2 gives 15 x 20 patches."""
    jsc, tsc, jlp, tlp = scene
    crop = dict(images=jsc.images[:, :60], masks=jsc.masks[:, :60],
                hwf=(60, 80, jsc.hwf[2]))
    jsc15 = dataclasses.replace(jsc, **crop)
    tsc15 = dataclasses.replace(tsc, **crop)
    jmodel, make_field = _models("nerf", jsc)
    params = _params(jmodel, 1)
    jfn = jpatch.make_patch_lpips_fn(
        jmodel, jsc15, np.arange(5), lpips=jlp, render=JRenderConfig(**RCFG),
        near=jsc.near, far=jsc.far, lpips_render_factor=RF,
        patch_len_factor=PLF, batch_size=1)
    assert np.isnan(float(jax.jit(jfn)(jfn.consts, params,
                                       jax.random.PRNGKey(0))))
    fields = torch.nn.ModuleDict({k: make_field() for k in params})
    with pytest.raises(ValueError, match="lpips_render_factor 2 and "
                       "patch_len_factor 2"):
        tpatch.make_patch_lpips_fn(
            fields, tsc15, np.arange(5), lpips=tlp,
            render=TRenderConfig(**RCFG), near=jsc.near, far=jsc.far,
            lpips_render_factor=RF, patch_len_factor=PLF)


def _grad_capture():
    """A pass-through transformation whose state holds the gradients."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return grads, grads
    return optax.GradientTransformation(init, update)


def _compare_step(jmodel, make_field, params, jsc, tsc, step_idx, *,
                  jkw=None, tkw=None):
    """One step of both packages from `params` on the fit-mode bank (clf,
    rgb and inp groups, perturb off): loss terms, gradients and the
    parameters after Adam. Returns the port's metrics."""
    jbank = jraybank.build_raybank(jsc, np.arange(5))
    tbank = traybank.build_raybank(tsc, np.arange(5), device="cpu")
    rcfg = dict(n_samples=12, n_importance=6, perturb=False)
    jcfg = jstep.TrainConfig(render=JRenderConfig(**rcfg), n_rand=64)
    tcfg = tstep.TrainConfig(render=TRenderConfig(**rcfg), n_rand=64)
    assert jstep._active_groups(jcfg, jbank) == ["clf", "rgb", "inp"]
    tx = optax.chain(_grad_capture(),
                     jschedule.make_optimizer(LRATE, DECAY))
    opt_state = tx.init(params)
    fields = torch.nn.ModuleDict({k: make_field() for k in params})
    _load(fields, params)
    jfn = jstep.make_train_step(jmodel, jcfg, jbank, tx, **(jkw or {}))
    opt = tschedule.make_optimizer(fields.named_parameters(), LRATE, DECAY)
    tfn = tstep.make_train_step(fields, tcfg, tbank, opt,
                                **{k: v(fields) for k, v in
                                   (tkw or {}).items()})
    params, opt_state, jm = jfn(jax.tree.map(jnp.copy, params), opt_state,
                                jax.random.PRNGKey(0), step_idx)
    jgrads = fields_state_dicts(jax.tree.map(np.asarray, opt_state[0]))
    opt.zero_grad()
    loss, tm = tfn.loss_fn(step_idx)
    loss.backward()
    assert set(tm) == set(jm)
    for name in jm:
        assert rel(tm[name].detach().numpy(), np.asarray(jm[name])) < 1e-5, \
            name
    for k in fields:
        for name, p in fields[k].named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            assert rel(g.numpy(), jgrads[k][name].numpy()) < 1e-4, (k, name)
    opt.step()
    jparams = fields_state_dicts(jax.tree.map(np.asarray, params))
    for k in fields:
        for name, p in fields[k].named_parameters():
            # Adam's first step is lr * g / (|g| + 1e-8): where JAX's |g| is
            # under 100 x eps it turns f32 summation noise in g (inside the
            # 1e-4 bound above) into up to ~10 % of lr (the patch term's
            # 1/100 weight puts ~0.02 % of the table there). Those entries
            # are held within lr, every other one within 1e-6.
            tight = np.abs(jgrads[k][name].numpy()) >= 1e-6
            d = np.abs(p.detach().numpy() - jparams[k][name].numpy())
            assert d[tight].max(initial=0) <= 1e-6, (k, name)
            assert d.max() <= LRATE, (k, name)
    return tm, fields


def test_lpips_step_matches_jax(scene):
    """Step 301 of the hash field with the patch term; the port takes
    JAX's views and anchors, derived from the step key's last split
    (`spinnerf_tpu/train/step.py:217`)."""
    jsc, tsc, jlp, tlp = scene
    jmodel, make_field = _models("hash", jsc)
    params = _params(jmodel, 1)
    bs = 2
    groups = 3
    k_lpips = jax.random.split(jax.random.PRNGKey(0), groups + 3)[-1]
    views, u = _jax_draws(k_lpips, bs, 5)
    jfn, _ = _patch_fns(jsc, tsc, jlp, tlp, jmodel,
                        torch.nn.ModuleDict({"coarse": make_field()}), bs)

    def port_lpips(fields):
        _, tfn = _patch_fns(jsc, tsc, jlp, tlp, jmodel, fields, bs)

        def fn(generator=None):
            return tfn(views=views, u=u)
        fn.start_iter = tfn.start_iter
        return fn

    tm, _ = _compare_step(jmodel, make_field, params, jsc, tsc, 301,
                          jkw=dict(lpips_fn=jfn),
                          tkw=dict(lpips_fn=port_lpips))
    assert float(tm["lpips_loss"].detach()) > 0


def test_lpips_term_waits_for_its_start_step(scene):
    """At step 300 the term is not computed: lpips_loss is 0 and the update
    equals the step's without the term."""
    jsc, tsc, jlp, tlp = scene
    jmodel, make_field = _models("hash", jsc)
    params = _params(jmodel, 1)
    tbank = traybank.build_raybank(tsc, np.arange(5), device="cpu")
    tcfg = tstep.TrainConfig(render=TRenderConfig(**RCFG, perturb=False),
                             n_rand=64)
    calls = []
    out = []
    for with_term in (True, False):
        fields = torch.nn.ModuleDict({k: make_field() for k in params})
        _load(fields, params)
        lp = None
        if with_term:
            _, tfn = _patch_fns(jsc, tsc, jlp, tlp, jmodel, fields, 2)

            def lp(generator=None):
                calls.append(1)
                return tfn(generator)
            lp.start_iter = tfn.start_iter
        opt = tschedule.make_optimizer(fields.named_parameters(), LRATE,
                                       DECAY)
        m = tstep.make_train_step(fields, tcfg, tbank, opt, lpips_fn=lp)(
            300)
        out.append((m, fields))
    (m1, f1), (m2, f2) = out
    assert not calls
    assert float(m1["lpips_loss"]) == 0.0 and "lpips_loss" not in m2
    assert float(m1["loss"]) == float(m2["loss"])
    for (k, a), b in zip(f1.state_dict().items(), f2.state_dict().values()):
        assert torch.equal(a, b), k


def _frozen_fns(jmodel, make_field, seed):
    """The frozen field of `seed` for both packages: JAX's raw function
    (its parameters as `consts`) and the port's field factory."""
    frozen_params = _params(jmodel, seed)["fine"]

    def jfrozen(p, pts, vd):
        return jmodel.apply(p, pts, vd)
    jfrozen.consts = frozen_params

    def port_frozen(_fields):
        f = make_field()
        f.load_state_dict(fields_state_dicts(
            {"f": jax.tree.map(np.asarray, frozen_params)})["f"])
        return f.requires_grad_(False)
    return jfrozen, port_frozen


# Frozen seeds the step holds at (seed 2, the first one held, keeps the ids
# "hash" and "nerf"). NeRFField at seed 4 is not among them: its last
# deterministic importance sample lands on a discontinuity of the sampler
# (test_frozen_density_seed_4_leaves_jax_at_the_cdf_end).
FROZEN_CASES = [pytest.param(kind, s, id=kind if s == 2 else f"{kind}-{s}")
                for kind, seeds in (("hash", (2, 0, 3, 4)), ("nerf", (2, 0, 3)))
                for s in seeds]


@pytest.mark.parametrize("kind,seed", FROZEN_CASES)
def test_frozen_density_step_matches_jax(scene, kind, seed):
    """The density of both passes is the frozen field's (other weights
    than the trained one's); the trained field's sigma head gets no
    gradient from the loss."""
    jsc, tsc, _, _ = scene
    jmodel, make_field = _models(kind, jsc)
    params = _params(jmodel, 1)
    jfrozen, port_frozen = _frozen_fns(jmodel, make_field, seed)
    tm, fields = _compare_step(jmodel, make_field, params, jsc, tsc, 1,
                               jkw=dict(frozen_raw_fn=jfrozen),
                               tkw=dict(frozen_raw_fn=port_frozen))
    if kind == "nerf":
        assert fields["fine"].sigma_head.weight.grad is None


def test_frozen_density_seed_4_leaves_jax_at_the_cdf_end(scene,
                                                         monkeypatch):
    """NeRFField's step with frozen seed 4 leaves JAX at one sample only.
    With perturb off the importance uniforms are linspace(0, 1), whose last,
    u = 1, equals the CDF's total in exact arithmetic, so it lands on the
    sampler's last bin at a point set by the f32 rounding of that total,
    which the two packages' cumsums round differently on some rays. Where
    that bin has zero weight (a CDF width of 1.4e-5) one ulp of the CDF
    moves the sample by 0.4 % of the bin; on one ray here (JAX's sample at
    the bin's edge, the port's 0.009 below it) that moves `trunk_0`'s
    gradient by 2.6e-4 of its largest entry. Given JAX's fine
    samples the port's step holds at every bound of
    `test_frozen_density_step_matches_jax`."""
    from spinnerf_tpu.core import rendering as jrendering
    from spinnerf_tpu_torch.core import rendering as trendering
    from spinnerf_tpu_torch.core import sampling as tsampling
    jsc, tsc, _, _ = scene
    jmodel, make_field = _models("nerf", jsc)
    params = _params(jmodel, 1)
    jfrozen, port_frozen = _frozen_fns(jmodel, make_field, 4)
    with pytest.raises(AssertionError, match="trunk_0.weight"):
        _compare_step(jmodel, make_field, params, jsc, tsc, 1,
                      jkw=dict(frozen_raw_fn=jfrozen),
                      tkw=dict(frozen_raw_fn=port_frozen))

    # the port's ray batch and its render, then JAX's render of that batch
    seen = {}
    render = trendering.render_rays

    def recording_render(batch, *a, **kw):
        seen["batch"] = {k: v.detach().numpy() for k, v in batch.items()}
        seen["res"] = render(batch, *a, **kw)
        return seen["res"]
    monkeypatch.setattr(tstep.rendering, "render_rays", recording_render)
    fields = torch.nn.ModuleDict({k: make_field() for k in params})
    _load(fields, params)
    tbank = traybank.build_raybank(tsc, np.arange(5), device="cpu")
    rcfg = dict(n_samples=12, n_importance=6, perturb=False)
    tstep.make_train_step(
        fields, tstep.TrainConfig(render=TRenderConfig(**rcfg), n_rand=64),
        tbank, tschedule.make_optimizer(fields.named_parameters(), LRATE,
                                        DECAY),
        frozen_raw_fn=port_frozen(fields)).loss_fn(1)
    monkeypatch.undo()

    def jfield(p):
        def fn(pts, vd):
            sigma = jfrozen(jfrozen.consts, pts, vd)[..., 3:4]
            return jmodel.apply(p, pts, vd, frozen_sigma=sigma)
        return fn
    jres = jrendering.render_rays(
        jax.random.PRNGKey(0), jax.tree.map(jnp.asarray, seen["batch"]),
        jfield(params["coarse"]), JRenderConfig(**rcfg),
        fine_field_fn=jfield(params["fine"]))
    tres = seen["res"]
    jz = np.asarray(jres.fine.z_vals)
    tz = tres.fine.z_vals.detach().numpy()
    # the coarse passes agree; the fine passes differ only at u = 1
    np.testing.assert_allclose(tres.coarse.z_vals.numpy(),
                               np.asarray(jres.coarse.z_vals), atol=1e-6)
    np.testing.assert_allclose(tres.coarse.weights.detach().numpy(),
                               np.asarray(jres.coarse.weights), atol=1e-6)
    far = np.argwhere(np.abs(tz - jz) > 1e-4)
    assert len(far)
    for ray, i in far:
        bins = (0.5 * (tres.coarse.z_vals[ray, 1:]
                       + tres.coarse.z_vals[ray, :-1])).numpy()
        for z in (tz[ray, i], jz[ray, i]):
            assert bins[-2] < z <= bins[-1] + 1e-6

    # on JAX's fine samples the port's step holds
    hierarchical = tsampling.hierarchical_z_vals

    def jax_samples(*a, **kw):
        _, z_samples = hierarchical(*a, **kw)
        return torch.from_numpy(jz), z_samples
    monkeypatch.setattr(trendering.sampling, "hierarchical_z_vals",
                        jax_samples)
    _compare_step(jmodel, make_field, params, jsc, tsc, 1,
                  jkw=dict(frozen_raw_fn=jfrozen),
                  tkw=dict(frozen_raw_fn=port_frozen))
