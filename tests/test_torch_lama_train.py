"""The port's LaMa training (`train/lama_{losses,trainer,loop}.py`) against
the JAX package's, on numpy-made inputs:

- the losses within 1e-6 relative, the R1 penalty within 1e-5, and the
  nearest mask resize to the logit grid (256 -> 19) equal to
  `jax.image.resize`'s half-pixel sampling;
- optax's `clip_by_global_norm` rule (no scaling under the norm);
- from JAX's initial `LamaTrainState` carried across by
  `convert.lama_train_state` (G ngf 8, 1 block, 32 features; D ndf 8, 2
  layers; batch 2, crop 32, the resnet_pl term on a depth-18 encoder):
  every metric within 1e-5 relative at step 1 and 1e-3 at step 4; G, D,
  their BN statistics and the EMA after step 1 (`_hold_step`), after each
  of steps 2-4 taken from JAX's state before it, and after 4 steps run on;
- TF32 off in every backward of the step, the flags restored after;
- `train_inpainter` writes metrics, grids and checkpoints and resumes.

The bounds are measured (torch 2.13 CPU): after step 1 the held entries
agree within 1.2e-7 (G) / 1.5e-8 (D), the EMA within 1.26 spacings. From
JAX's state 3, step 4's batch leaves both packages' f32 steps off float64
on G (the port's by up to 8.5e-6, JAX's by up to 4.5e-4 on 17 % of G's
entries), hence the float64 reference for those steps. Run on for 4
steps: G 4.03 lr apart (1.04e-3 where |mu| >= 1e-3 throughout, 2.9 % of
G), D 0.157 lr (6.7e-6 where |mu| >= 1e-5 throughout, 84 %), the
statistics 8.9e-4 / 5.2e-7, the EMA 3.7 spacings."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.models.discriminator import NLayerDiscriminator as JD
from spinnerf_tpu.models.lama import FFCResNetGenerator as JG
from spinnerf_tpu.models import segmentation as jseg
from spinnerf_tpu.train import lama_losses as jl
from spinnerf_tpu.train import lama_trainer as jt
from spinnerf_tpu_torch import convert
from spinnerf_tpu_torch.models import segmentation as tseg
from spinnerf_tpu_torch.models.discriminator import NLayerDiscriminator as TD
from spinnerf_tpu_torch.models.lama import FFCResNetGenerator as TG
from spinnerf_tpu_torch.train import lama_losses as tl
from spinnerf_tpu_torch.train import lama_trainer as tt

torch.set_num_threads(1)

GK = dict(ngf=8, n_blocks=1, max_features=32)
DK = dict(ndf=8, n_layers=2)
GEN_LR, DISC_LR = 1e-3, 1e-4


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).transpose(0, 3, 1, 2)))


def test_resize_mask_samples_half_pixel_centres():
    m = (np.random.RandomState(0).rand(2, 256, 256, 1) > 0.5).astype(
        np.float32)
    for hw in ((19, 19), (33, 17), (256, 256)):
        want = np.asarray(jl._resize_mask(jnp.asarray(m), hw))
        got = tl._resize_mask(nchw(m), hw).numpy().transpose(0, 2, 3, 1)
        np.testing.assert_array_equal(got, want)
    # torch's plain "nearest" samples elsewhere at 256 -> 19
    plain = torch.nn.functional.interpolate(nchw(m), (19, 19),
                                            mode="nearest")
    assert not torch.equal(plain, tl._resize_mask(nchw(m), (19, 19)))


def test_losses_match_jax():
    rng = np.random.RandomState(1)
    pred, tgt = rng.rand(2, 3, 32, 32), rng.rand(2, 3, 32, 32)
    mask = (rng.rand(2, 1, 32, 32) > 0.6).astype(np.float32)
    fake, real = rng.randn(2, 1, 19, 19) * 2, rng.randn(2, 1, 19, 19) * 2
    j = lambda a: jnp.asarray(np.asarray(a, np.float32).transpose(0, 2, 3, 1))
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    mask256 = (rng.rand(2, 1, 256, 256) > 0.5).astype(np.float32)
    pairs = [
        (jl.masked_l1(j(pred), j(tgt), j(mask), weight_known=10.,
                      weight_missing=0.5),
         tl.masked_l1(t(pred), t(tgt), t(mask), weight_known=10.,
                      weight_missing=0.5)),
        (jl.generator_adversarial_loss(j(fake), j(mask)),
         tl.generator_adversarial_loss(t(fake), t(mask))),
        (jl.generator_adversarial_loss(j(fake), j(mask256),
                                       extra_mask_weight=3.0),
         tl.generator_adversarial_loss(t(fake), t(mask256),
                                       extra_mask_weight=3.0)),
        (jl.generator_adversarial_loss(j(fake), j(mask256),
                                       use_unmasked=False),
         tl.generator_adversarial_loss(t(fake), t(mask256),
                                       use_unmasked=False)),
        (jl.discriminator_adversarial_loss(j(real), j(fake), j(mask256)),
         tl.discriminator_adversarial_loss(t(real), t(fake), t(mask256))),
        (jl.feature_matching_loss([j(pred), j(fake)], [j(tgt), j(real)]),
         tl.feature_matching_loss([t(pred), t(fake)], [t(tgt), t(real)])),
    ]
    for want, got in pairs:
        assert rel(float(got), float(want)) < 1e-6
    feats = lambda x: [x, x ** 2]
    want = jl.perceptual_loss(lambda p, x: feats(x), None, j(pred), j(tgt))
    got = tl.perceptual_loss(feats, t(pred), t(tgt))
    assert rel(float(got), float(want)) < 1e-6


def test_r1_penalty_matches_jax():
    x = np.random.RandomState(2).rand(2, 24, 32, 3).astype(np.float32)
    jd = JD(**DK)
    v = jax.tree.map(np.asarray, jax.jit(jd.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(x)))
    td = TD(**DK, device="cpu").eval()
    td.load_state_dict(convert.discriminator_state_dict(v), strict=True)
    want, wgrad = jax.value_and_grad(lambda p: jl.r1_gradient_penalty(
        lambda pp, a: jd.apply({"params": pp,
                                "batch_stats": v["batch_stats"]}, a),
        p, jnp.asarray(x)))(v["params"])
    got = tl.r1_gradient_penalty(td, nchw(x))
    got.backward()                       # the double backward through D
    assert rel(float(got), float(want)) < 1e-5
    jg = convert.discriminator_state_dict(
        {"params": jax.tree.map(np.asarray, wgrad),
         "batch_stats": v["batch_stats"]})
    for name, p in td.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # the head's
        assert np.abs(g.numpy() - jg[name].numpy()).max() <= \
            1e-4 * max(np.abs(jg[name].numpy()).max(), 1e-30), name


def test_clip_by_global_norm_is_optax_rule():
    import optax
    rng = np.random.RandomState(3)
    for scale in (0.01, 10.0):
        gs = [rng.randn(4, 3).astype(np.float32) * scale,
              rng.randn(5).astype(np.float32) * scale]
        ps = [torch.zeros(g.shape, requires_grad=True) for g in gs]
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g.copy())
        tt.clip_by_global_norm_(ps, 1.0)
        want, _ = optax.clip_by_global_norm(1.0).update(
            [jnp.asarray(g) for g in gs], optax.EmptyState())
        for p, w in zip(ps, want):
            assert rel(p.grad.numpy(), w) < 1e-6
        if scale < 1:
            assert all(np.array_equal(p.grad.numpy(), g)
                       for p, g in zip(ps, gs))


def _jax_dicts(jstate):
    """JAX's `LamaTrainState` as the port's state dicts: G, D, the EMA and
    both Adam moments of G and D ("gen_mu", "disc_nu", ...)."""
    gstats = jstate.gen_vars["batch_stats"]
    dstats = jstate.disc_vars["batch_stats"]
    sds = {"gen": convert.lama_state_dict(jstate.gen_vars),
           "disc": convert.discriminator_state_dict(jstate.disc_vars),
           "ema": convert.lama_state_dict({"params": jstate.ema_params,
                                           "batch_stats": gstats})}
    for tree, opt, to_sd, stats in (
            ("gen", jstate.gen_opt, convert.lama_state_dict, gstats),
            ("disc", jstate.disc_opt, convert.discriminator_state_dict,
             dstats)):
        adam = convert._adam_state(opt)
        for moment in ("mu", "nu"):
            sds[f"{tree}_{moment}"] = to_sd({"params": getattr(adam, moment),
                                             "batch_stats": stats})
    return {k: _np(v) for k, v in sds.items()}


def _np(sd):
    return {k: v.detach().numpy().astype(np.float64) for k, v in sd.items()}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    """JAX's state and the port's over 4 steps, with the resnet_pl term
    (depth 18, one MIT-format file read by both packages):
    - "jax": JAX's state before the first step (0) and after each (1-4);
    - "free": the port's, run on from JAX's initial state;
    - "anchored", "anchored64": the port's after step k taken from JAX's
      state k - 1, in f32 and in float64;
    - the TF32 flags that every backward through the free run's G and D
      saw, with both set on before each step, and the flags after."""
    rng = np.random.RandomState(4)
    imgs = rng.rand(4, 2, 32, 32, 3).astype(np.float32)
    masks = (rng.rand(4, 2, 32, 32, 1) > 0.6).astype(np.float32)
    enc = tseg.ResNetDilated(18, device="cpu")
    enc.reset_parameters(torch.Generator().manual_seed(1))
    path = tmp_path_factory.mktemp("w") / "enc18.pth"
    torch.save(enc.state_dict(), path)
    jpl, _ = jseg.make_resnet_pl(depth=18, weights_path=str(path))
    init, jstep = jt.make_lama_train_step(JG(**GK), JD(**DK),
                                          perceptual_fn=jpl)
    jstate = init(jax.random.PRNGKey(0), image_shape=(2, 32, 32, 3))

    def port(dtype=torch.float32):
        tpl, tenc = tseg.make_resnet_pl(depth=18, weights_path=path,
                                        device="cpu")
        tg, td = TG(device="cpu", **GK), TD(device="cpu", **DK)
        for mod in (tenc, tg, td):
            mod.to(dtype)
        tinit, tstep = tt.make_lama_train_step(tg, td, perceptual_fn=tpl)
        return tinit(0), tstep

    def load(jax_state, state):
        convert.lama_train_state(jax_state, state)
        for opt in (state.gen_opt, state.disc_opt):
            for p, s in opt.state.items():
                for k in ("exp_avg", "exp_avg_sq"):
                    s[k] = s[k].to(p.dtype)
        return state

    def snapshot(state, metrics):
        return {"gen": _np(state.gen.state_dict()),
                "disc": _np(state.disc.state_dict()), "ema": _np(state.ema),
                "metrics": {n: float(v) for n, v in metrics.items()}}

    free, fstep = port()
    anchored, astep = port()
    anchored64, astep64 = port(torch.float64)
    jstates = [jax.tree.map(np.asarray, jstate)]
    load(jstates[0], free)
    seen = []
    for p in list(free.gen.parameters()) + list(free.disc.parameters()):
        p.register_hook(lambda g: seen.append((
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)))
    out = {"jax": [_jax_dicts(jstates[0])], "jax_metrics": [None],
           "free": [None], "anchored": [None], "anchored64": [None],
           "flags_after": [], "flags_in_backward": seen,
           "n_params": len(list(free.gen.parameters())
                           + list(free.disc.parameters()))}
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        for k in range(4):
            x, m = tt.to_nchw(imgs[k], "cpu"), tt.to_nchw(masks[k], "cpu")
            for key, state, step, dtype in (
                    ("anchored", anchored, astep, torch.float32),
                    ("anchored64", anchored64, astep64, torch.float64)):
                load(jstates[k], state)
                out[key].append(snapshot(state, step(
                    state, x.to(dtype), m.to(dtype))))
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
            out["free"].append(snapshot(free, fstep(free, x, m)))
            out["flags_after"].append((
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32))
            jstate, jm = jstep(jstate, jnp.asarray(imgs[k]),
                               jnp.asarray(masks[k]), jax.random.PRNGKey(k))
            jstates.append(jax.tree.map(np.asarray, jstate))
            out["jax"].append(_jax_dicts(jstates[-1]))
            out["jax_metrics"].append({n: float(v) for n, v in jm.items()})
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    return out


@pytest.mark.parametrize("k,tol", [(1, 1e-5), (4, 1e-3)])
def test_train_step_metrics_match_jax(steps, k, tol):
    jm, tm = steps["jax_metrics"][k], steps["free"][k]["metrics"]
    assert set(tm) == set(jm) == {"g_l1", "g_adv", "g_fm", "g_perceptual",
                                  "g_total", "d_adv", "d_gp", "d_total"}
    for name in jm:
        assert np.isfinite(tm[name])
        assert rel(tm[name], jm[name]) < tol, name


def test_step_runs_backward_without_tf32(steps):
    """Both TF32 flags are off in every backward through G and D (a hook
    on each parameter reads them) and are restored after the step."""
    seen = steps["flags_in_backward"]
    assert len(seen) == 4 * steps["n_params"]
    assert set(seen) == {(False, False)}
    assert steps["flags_after"] == [(True, True)] * 4


def _param_names(sd):
    return [n for n in sd if "running" not in n and "num_batches" not in n]


def _ema_ulps(ema, jax_ema, gens, jax_gens):
    """Per EMA tensor, the port's EMA minus JAX's less what the parameters'
    own differences explain (r_i = d r_{i-1} + (1 - d)(p_i - p'_i) over
    the steps since both EMAs were equal, `gens` the port's parameters
    after each), in f32 spacings of the largest of the two EMAs and
    (1 - d) p. An EMA that missed an update, or decays at another rate,
    is off by (1 - d) times a parameter's move: hundreds of spacings."""
    out = {}
    for name in ema:
        r = np.zeros_like(ema[name])
        for g, jg in zip(gens, jax_gens):
            r = 0.999 * r + 0.001 * (g[name] - jg[name])
        scale = np.maximum(np.maximum(np.abs(ema[name]),
                                      np.abs(jax_ema[name])),
                           0.001 * np.abs(gens[-1][name]))
        out[name] = np.abs(ema[name] - jax_ema[name] - r) / np.spacing(
            scale.astype(np.float32))
    return out


def _hold_step(got, want, ref=None):
    """One step of the port against JAX's.

    Without `ref` (the first step, from JAX's initial state): the BN
    running statistics within 1e-6; each parameter within 1e-6 where
    JAX's first Adam moment |mu| >= 1e-5 (|g| >= 1e-4, far from Adam's
    eps: the step is lr times the gradient's sign) and within 2 lr
    everywhere (a gradient at f32 noise level may take Adam's +-lr step
    either way); the tight set at least 80 % of each tree.

    With `ref`, the port's float64 step from the same state (a later
    step, where Adam's step is a ratio of the moments and f32 gradient
    noise moves it): on the tight set the port within 2e-5 of float64,
    and within 4e-6 of JAX where JAX lies within 1e-6 of float64, a set
    that must cover 70 % of each tree (a skipped or wrong update in the
    port, float64's too, empties it); 2 lr everywhere.

    Both: the EMA within 4 f32 spacings of what the parameters' own
    differences explain (`_ema_ulps`)."""
    for tree, lr in (("gen", GEN_LR), ("disc", DISC_LR)):
        held_n = all_n = 0
        for name, w in want[tree].items():
            d = np.abs(got[tree][name] - w)
            if name not in _param_names(want[tree]):
                assert d.max() <= 1e-6, (tree, name)
                continue
            assert d.max() <= 2 * lr, (tree, name)
            held = np.abs(want[tree + "_mu"][name]) >= 1e-5
            if ref is None:
                assert d[held].max(initial=0) <= 1e-6, (tree, name)
            else:
                to_ref = np.abs(got[tree][name] - ref[tree][name])
                assert to_ref[held].max(initial=0) <= 2e-5, (tree, name)
                held &= np.abs(w - ref[tree][name]) <= 1e-6
                assert d[held].max(initial=0) <= 4e-6, (tree, name)
            held_n, all_n = held_n + held.sum(), all_n + held.size
        assert held_n >= (0.8 if ref is None else 0.7) * all_n, tree
    ulps = _ema_ulps(got["ema"], want["ema"], [got["gen"]], [want["gen"]])
    for name, u in ulps.items():
        assert u.max() <= 4, name


def test_one_step_state_matches_jax(steps):
    _hold_step(steps["free"][1], steps["jax"][1])


@pytest.mark.parametrize("k", [2, 3, 4])
def test_step_from_jax_state_matches_jax(steps, k):
    """Step k from JAX's state k - 1: Adam's bias corrections at count k,
    the running statistics and the EMA carried on."""
    _hold_step(steps["anchored"][k], steps["jax"][k],
               steps["anchored64"][k])


def test_four_steps_state_near_jax(steps):
    """Four steps run on from JAX's initial state. Entries whose gradient
    is at f32 noise level take Adam's +-lr step in one run and not in the
    other, and that moves G's later gradients: G within 6 lr, and within
    2 lr where |mu| >= 1e-3 after every step; D within lr / 2, and 2e-5
    where |mu| >= 1e-5 after every step; the running statistics within
    2e-3 (G) and 2e-6 (D); the EMA within 16 spacings (`_ema_ulps`)."""
    got, want = steps["free"][4], steps["jax"][4]
    for tree, bound, held_mu, held_bound, stats_bound in (
            ("gen", 6 * GEN_LR, 1e-3, 2 * GEN_LR, 2e-3),
            ("disc", DISC_LR / 2, 1e-5, 2e-5, 2e-6)):
        for name, w in want[tree].items():
            d = np.abs(got[tree][name] - w)
            if name not in _param_names(want[tree]):
                assert d.max() <= stats_bound, (tree, name)
                continue
            assert d.max() <= bound, (tree, name)
            held = np.ones(d.shape, bool)
            for k in range(1, 5):
                held &= np.abs(steps["jax"][k][tree + "_mu"][name]) >= held_mu
            assert d[held].max(initial=0) <= held_bound, (tree, name)
    ulps = _ema_ulps(got["ema"], want["ema"],
                     [steps["free"][k]["gen"] for k in range(1, 5)],
                     [steps["jax"][k]["gen"] for k in range(1, 5)])
    for name, u in ulps.items():
        assert u.max() <= 16, name


def test_train_inpainter_writes_and_resumes(tmp_path, capsys):
    from spinnerf_tpu_torch.eval.render import read_png, write_png
    from spinnerf_tpu_torch.train.lama_loop import train_inpainter
    rng = np.random.RandomState(5)
    src = tmp_path / "imgs"
    src.mkdir()
    for i in range(3):
        write_png(src / f"im{i}.png",
                  (rng.rand(40, 48, 3) * 255).astype(np.uint8))
    kw = dict(n_steps=3, batch_size=2, crop=32, i_print=1, i_vis=2,
              i_ckpt=100, gen_kwargs=GK, disc_kwargs=DK, device="cpu")
    lines = []
    state = train_inpainter(src, tmp_path / "exp", log=lines.append, **kw)
    assert state.step == 3
    rows = (tmp_path / "exp" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 3
    grid = read_png(tmp_path / "exp" / "visualizations" / "step_000002.png")
    assert grid.shape == (64, 128, 3)
    assert (tmp_path / "exp" / "checkpoints" / "ckpt_00000002.pt").exists()
    lines.clear()
    state = train_inpainter(src, tmp_path / "exp", log=lines.append,
                            **{**kw, "n_steps": 4})
    assert "resumed inpainter training from step 2" in lines
    assert state.step == 4
    assert len((tmp_path / "exp" / "metrics.jsonl").read_text()
               .splitlines()) == 4
