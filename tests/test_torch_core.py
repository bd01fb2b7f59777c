"""The port's rays, sampling, compositing, losses, encodings and activations
against the JAX package's on the same numpy inputs. f32 tolerance 1.5e-6
absolute (scaled by the magnitude where values exceed 1)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spinnerf_tpu.core import losses as jl
from spinnerf_tpu.core import rays as jr
from spinnerf_tpu.core import rendering as jrend
from spinnerf_tpu.core import sampling as js
from spinnerf_tpu.models import activations as jact
from spinnerf_tpu.models import embedding as jemb
from spinnerf_tpu_torch.core import losses as tl
from spinnerf_tpu_torch.core import rays as tr
from spinnerf_tpu_torch.core import rendering as trend
from spinnerf_tpu_torch.core import sampling as ts
from spinnerf_tpu_torch.models import activations as tact
from spinnerf_tpu_torch.models import embedding as temb

torch.set_num_threads(1)
TOL = 1.5e-6


def close(t, j, tol=TOL):
    t = t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = max(1.0, float(np.max(np.abs(j)))) if j.size else 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def c2w(rng):
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return np.concatenate([q, rng.randn(3, 1)], 1).astype(np.float32)


def test_get_rays(c2w):
    o_j, d_j = jr.get_rays(6, 8, 7.5, jnp.asarray(c2w))
    o_t, d_t = tr.get_rays(6, 8, 7.5, T(c2w))
    close(o_t, o_j)
    close(d_t, d_j)


def test_get_rays_at_coords_and_ndc(c2w, rng):
    coords = (rng.rand(20, 2) * [8, 6]).astype(np.float32)
    o_j, d_j = jr.get_rays_at_coords(6, 8, 7.5, jnp.asarray(c2w),
                                     jnp.asarray(coords))
    o_t, d_t = tr.get_rays_at_coords(6, 8, 7.5, T(c2w), T(coords))
    close(o_t, o_j)
    close(d_t, d_j)
    # forward-facing rays for the NDC warp
    o = rng.randn(20, 3).astype(np.float32) * 0.1
    d = np.concatenate([rng.randn(20, 2) * 0.2, -np.ones((20, 1))],
                       1).astype(np.float32)
    no_j, nd_j = jr.ndc_rays(6, 8, 7.5, 1.0, jnp.asarray(o), jnp.asarray(d))
    no_t, nd_t = tr.ndc_rays(6, 8, 7.5, 1.0, T(o), T(d))
    close(no_t, no_j)
    close(nd_t, nd_j)


def test_make_ray_batch(rng):
    o = rng.randn(5, 3).astype(np.float32)
    d = rng.randn(5, 3).astype(np.float32)
    dep = rng.rand(5).astype(np.float32)
    b_j = jr.make_ray_batch(jnp.asarray(o), jnp.asarray(d), 0.5, 4.0,
                            depths=jnp.asarray(dep), weights=jnp.asarray(dep))
    b_t = tr.make_ray_batch(T(o), T(d), 0.5, 4.0, depths=T(dep),
                            weights=T(dep))
    assert set(b_t) == set(b_j)
    for k in b_j:
        close(b_t[k], b_j[k])


@pytest.mark.parametrize("lindisp", [False, True])
@pytest.mark.parametrize("perturb", [False, True])
def test_stratified_z_vals(rng, lindisp, perturb):
    near = (0.5 + rng.rand(16)).astype(np.float32)
    far = (near + 2.0 + rng.rand(16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    z_j = js.stratified_z_vals(key, jnp.asarray(near), jnp.asarray(far), 12,
                               lindisp=lindisp, perturb=perturb)
    t_rand = jax.random.uniform(key, (16, 12), dtype=jnp.float32)
    z_t = ts.stratified_z_vals(T(near), T(far), 12, lindisp=lindisp,
                               perturb=perturb, t_rand=T(t_rand))
    close(z_t, z_j)


@pytest.mark.parametrize("det", [False, True])
def test_sample_pdf_and_hierarchical(rng, det):
    z = np.sort(rng.rand(16, 12) * 4 + 1, axis=1).astype(np.float32)
    w = rng.rand(16, 12).astype(np.float32)
    w[0] = 0.0                                   # an empty ray
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (16, 9), dtype=jnp.float32))
    mids = 0.5 * (z[:, 1:] + z[:, :-1])
    s_j = js.sample_pdf(None, jnp.asarray(mids), jnp.asarray(w[:, 1:-1]), 9,
                        u=jnp.asarray(u))
    s_t = ts.sample_pdf(T(mids), T(w[:, 1:-1]), 9, u=T(u))
    close(s_t, s_j)
    zc_j, zs_j = js.hierarchical_z_vals(key, jnp.asarray(z), jnp.asarray(w),
                                        9, det=det)
    zc_t, zs_t = ts.hierarchical_z_vals(T(z), T(w), 9, det=det,
                                        u=None if det else T(u))
    close(zs_t, zs_j)
    close(zc_t, zc_j)
    pts_j = js.ray_points(jnp.asarray(z[:, :3]), jnp.asarray(z[:, 3:6]),
                          jnp.asarray(z))
    close(ts.ray_points(T(z[:, :3]), T(z[:, 3:6]), T(z)), pts_j)


COMPOSITE_FLAGS = {
    "plain": {},
    "noise": dict(raw_noise_std=0.7),
    "white_bkgd": dict(white_bkgd=True),
    "semantic": dict(semantic=True, harsh_bg_remove=True),
    "only_object": dict(semantic=True, only_object=True),
    "only_object_threshold": dict(semantic=True, only_object=True,
                                  oo_threshold=0.3),
}


@pytest.mark.parametrize("flags", sorted(COMPOSITE_FLAGS))
def test_composite(rng, flags):
    kw = COMPOSITE_FLAGS[flags]
    raw = rng.randn(8, 10, 5).astype(np.float32)
    raw[0, :, 3] = -5.0                         # an empty ray (relu -> 0)
    z = np.sort(rng.rand(8, 10) * 3 + 1, axis=1).astype(np.float32)
    d = rng.randn(8, 3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    out_j = jrend.composite(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                            noise_key=key, **kw)
    noise = jax.random.normal(key, (8, 10), dtype=jnp.float32)
    raw_t = T(raw).requires_grad_()
    out_t = trend.composite(raw_t, T(z), T(d), noise=T(noise), **kw)
    for name in trend.RenderOutputs._fields:
        a, b = getattr(out_t, name), getattr(out_j, name)
        assert (a is None) == (b is None), name
        if b is not None:
            close(a, b)

    # gradients through rgb (weights attached) and rgb_sg (detached)
    def jloss(r):
        o = jrend.composite(r, jnp.asarray(z), jnp.asarray(d), noise_key=key,
                            **kw)
        return jnp.sum(o.rgb) + 2 * jnp.sum(o.rgb_sg) + jnp.sum(o.disp)
    g_j = jax.grad(jloss)(jnp.asarray(raw))
    (out_t.rgb.sum() + 2 * out_t.rgb_sg.sum() + out_t.disp.sum()).backward()
    close(raw_t.grad, g_j, tol=1e-5)


def test_render_rays_deterministic(rng):
    """Coarse + fine render with an analytic field, perturb off."""
    def jfield(p, vd):
        s = jnp.sum(p ** 2, -1, keepdims=True)
        return jnp.concatenate([jnp.sin(p), 2.0 - s], -1)

    def tfield(p, vd):
        s = torch.sum(p ** 2, -1, keepdim=True)
        return torch.cat([torch.sin(p), 2.0 - s], -1)

    o = (rng.randn(6, 3) * 0.1).astype(np.float32)
    d = rng.randn(6, 3).astype(np.float32)
    cfg_kw = dict(n_samples=10, n_importance=7, perturb=False)
    b_j = jr.make_ray_batch(jnp.asarray(o), jnp.asarray(d), 0.1, 2.0)
    b_t = tr.make_ray_batch(T(o), T(d), 0.1, 2.0)
    r_j = jrend.render_rays(jax.random.PRNGKey(0), b_j, jfield,
                            jrend.RenderConfig(**cfg_kw))
    r_t = trend.render_rays(b_t, tfield, trend.RenderConfig(**cfg_kw))
    for part in ("coarse", "fine"):
        for name in ("rgb", "disp", "acc", "depth", "weights", "z_vals"):
            close(getattr(getattr(r_t, part), name),
                  getattr(getattr(r_j, part), name))
    close(r_t.z_std, r_j.z_std)
    chunked = trend.render_rays_chunked(b_t, tfield,
                                        trend.RenderConfig(**cfg_kw), chunk=4)
    np.testing.assert_array_equal(chunked.fine.rgb.numpy(),
                                  r_t.fine.rgb.numpy())


def test_losses(rng):
    p = rng.rand(32, 3).astype(np.float32)
    q = rng.rand(32, 3).astype(np.float32)
    m = (rng.rand(32) > 0.5).astype(np.float32)
    close(tl.mse(T(p), T(q)), jl.mse(p, q))
    close(tl.mse(T(p), T(q), T(m)), jl.mse(p, q, m))
    close(tl.mse_to_psnr(torch.tensor(0.013)), jl.mse_to_psnr(0.013))
    logits = rng.randn(32).astype(np.float32) * 3
    close(tl.bce_with_logits(T(logits), T(m)), jl.bce_with_logits(logits, m))
    close(tl.bce_with_logits(T(logits), T(m), T(1 - m)),
          jl.bce_with_logits(logits, m, 1 - m))


@pytest.mark.parametrize("variant", [
    dict(), dict(weighted=True), dict(relative=True),
    dict(weighted=True, normalize=True), dict(weighted=True, relative=True)])
def test_depth_loss_variants(rng, variant):
    pred = rng.rand(40).astype(np.float32) * 4
    tgt = (rng.rand(40) * 4 + 0.5).astype(np.float32)
    wts = rng.rand(40).astype(np.float32)
    mask = (rng.rand(40) > 0.3).astype(np.float32)
    for msk in (None, mask):
        out_j = jl.depth_loss(pred, tgt, ray_weights=wts, mask=msk,
                              max_depth=4.5, **variant)
        out_t = tl.depth_loss(T(pred), T(tgt), ray_weights=T(wts),
                              mask=None if msk is None else T(msk),
                              max_depth=4.5, **variant)
        close(out_t, out_j)


def test_sigma_and_distortion_losses(rng):
    sig = np.abs(rng.randn(16, 12)).astype(np.float32) * 50
    sig[0, :] = 120.0                           # would overflow a plain exp
    close(tl.sigma_loss(T(sig)), jl.sigma_loss(jnp.asarray(sig)))
    w = rng.rand(16, 12).astype(np.float32) / 6
    z = np.sort(rng.rand(16, 12) * 3, axis=1).astype(np.float32)
    close(tl.distortion_loss(T(w), T(z)), jl.distortion_loss(w, z))


def test_encodings_and_trunc_exp(rng):
    d = rng.randn(50, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for deg in (1, 2, 3, 4):
        close(temb.sh_encoding(T(d), deg), jemb.sh_encoding(jnp.asarray(d), deg))
    x = rng.randn(7, 3).astype(np.float32)
    close(temb.positional_encoding(T(x), 4),
          jemb.positional_encoding(jnp.asarray(x), 4))
    v = np.array([-30.0, -1.0, 0.0, 2.0, 14.0, 20.0], np.float32)
    vt = T(v).requires_grad_()
    y = tact.trunc_exp(vt)
    y.sum().backward()
    close(y, jact.trunc_exp(jnp.asarray(v)), tol=1e-6)
    close(vt.grad, jax.grad(lambda a: jnp.sum(jact.trunc_exp(a)))(
        jnp.asarray(v)), tol=1e-6)
