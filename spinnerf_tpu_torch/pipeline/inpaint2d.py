"""The 2D inpainting stage: LaMa inference and the SPIn-NeRF multiscale
refiner (port of `spinnerf_tpu/pipeline/inpaint2d.py`).

Reference surface (`lama/bin/predict.py:38-107`,
`saicinpainting/evaluation/refinement.py`):
- `predict`: pad the image and mask to multiples of 8, one generator
  forward on the masked RGB and the mask, blend `pred * mask + image *
  (1 - mask)`;
- `refine_predict`: an image / mask pyramid (at most 3 levels, min side
  512, a 1.8 MP budget); at each level after the first the front's latent
  pair (z_l, z_g) is optimised with Adam (15 steps, lr 2e-3) against the
  previous level's result, downscaled by block means, plus a known-region
  anchor (`refinement.py:90-189`); SPIn-NeRF's patch dilates the mask 5 x 5
  five times first (`refinement.py:125-132`);
- `inpaint_directory`: the LaMa_test_images -> output directory contract
  the NeRF stages consume.

The images are numpy on the host; the generator runs on its module's
device. cv2's resizes and morphology are computed by `utils/resize.py` and
`data/llff.py::dilate_mask` with cv2's results; PNG files are read and
written by `eval/render.py`.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch import weights as wreg
from spinnerf_tpu_torch.data import llff
from spinnerf_tpu_torch.eval.render import write_png
from spinnerf_tpu_torch.models import lama
from spinnerf_tpu_torch.models.lpips import _f32_convs
from spinnerf_tpu_torch.utils.resize import area_resize, nearest_resize


def pad_to_modulo(img: np.ndarray, mod: int = 8):
    """Pad H and W up to multiples of `mod` by symmetric reflection
    (`saicinpainting/evaluation/data.py:29`). Returns (padded, (h, w))."""
    h, w = img.shape[:2]
    ph = (mod - h % mod) % mod
    pw = (mod - w % mod) % mod
    pad = [(0, ph), (0, pw)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad, mode="symmetric"), (h, w)


def dilate_mask(mask: np.ndarray, kernel: int = 5, iterations: int = 5):
    """cv2.dilate of the mask cast to uint8, as float32."""
    return llff.dilate_mask(mask.astype(np.uint8), kernel,
                            iterations).astype(np.float32)


def _net_input(img: np.ndarray, mask: np.ndarray):
    """(the generator's [1, 4, H8, W8] input as numpy, the padded binary
    mask [H8, W8, 1], the padded image, (h, w))."""
    img_p, (h, w) = pad_to_modulo(img)
    m_p, _ = pad_to_modulo(mask)
    m_p = (m_p > 0.5).astype(np.float32)[..., None]
    inp = np.concatenate([img_p * (1.0 - m_p), m_p], -1)
    return inp.transpose(2, 0, 1)[None], m_p, img_p, (h, w)


class Inpainter:
    """A generator on its device: `full`, `front` and `rear` take and give
    tensors there (NCHW), `refine_step` takes one Adam step of the latent
    refinement."""

    def __init__(self, gen: lama.FFCResNetGenerator):
        self.gen = gen
        self.device = next(gen.parameters()).device

    def tensor(self, a: np.ndarray):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=self.device)

    def full(self, inp):
        with torch.no_grad():
            return self.gen(inp)

    def front(self, inp):
        with torch.no_grad():
            return self.gen.front(inp)

    def rear(self, z):
        with torch.no_grad():
            return self.gen.rear(z)

    def refine_loss(self, z, ref, m_ref, image, m_full):
        """The refiner's loss at latents z: the mean absolute difference of
        the prediction's block means from `ref` [3, ph, pw] over the hole
        `m_ref` [1, ph, pw] (summed over channels, divided by the hole's
        pixels), plus that of the prediction from `image` [3, h, w] over
        the known region 1 - `m_full` [1, h, w] (`refinement.py:78-87`:
        without the anchor the latent walk drifts the prediction outside
        the hole, and the blend seams)."""
        (_, ph, pw), (_, h, w) = ref.shape, image.shape
        fy, fx = h // ph, w // pw
        pred = self.gen.rear(z)[0, :, :h, :w]
        pd = pred[:, :ph * fy, :pw * fx].reshape(3, ph, fy, pw, fx)
        pd = pd.mean(dim=(2, 4))
        hole = (torch.sum(torch.abs(pd - ref) * m_ref)
                / torch.clamp(torch.sum(m_ref), min=1.0))
        known = 1.0 - m_full
        anchor = (torch.sum(torch.abs(pred - image) * known)
                  / torch.clamp(torch.sum(known), min=1.0))
        return hole + anchor

    def refine_step(self, z, opt, ref, m_ref, image, m_full):
        """One step of `opt` (an Adam over the latents z) on `refine_loss`;
        the generator's parameters get no gradient. Returns the loss."""
        loss = self.refine_loss(z, ref, m_ref, image, m_full)
        with _f32_convs():
            grads = torch.autograd.grad(loss, z)
        for t, g in zip(z, grads):
            t.grad = g
        opt.step()
        return loss.detach()


def predict(gen: lama.FFCResNetGenerator, image: np.ndarray,
            mask: np.ndarray, *, inpainter: Inpainter | None = None
            ) -> np.ndarray:
    """One generator forward. image [H, W, 3] float in [0, 1], mask [H, W]
    (1 = hole). Returns the inpainted [H, W, 3] float32."""
    inpainter = inpainter or Inpainter(gen)
    inp, m_p, img_p, (h, w) = _net_input(image, mask)
    pred = inpainter.full(inpainter.tensor(inp))[0]
    pred = pred.permute(1, 2, 0).cpu().numpy()
    out = pred * m_p + img_p * (1.0 - m_p)
    return out[:h, :w]


def _build_pyramid(image, mask, *, min_side: int = 512,
                   px_budget: float = 1.8e6, max_scales: int = 3):
    """Image / mask pyramid, coarsest first (`refinement.py:192-243`): the
    finest level capped at `px_budget` pixels, then halved while both sides
    stay >= 2 * min_side, at most `max_scales` levels."""
    h, w = image.shape[:2]
    if h * w > px_budget:
        ratio = np.sqrt(px_budget / (h * w))
        h, w = int(h * ratio), int(w * ratio)
        image = area_resize(image, h, w)
        mask = area_resize(mask, h, w)
    levels = [(image, (mask > 0.5).astype(np.float32))]
    for _ in range(max_scales - 1):
        h, w = levels[-1][0].shape[:2]
        if min(h, w) < 2 * min_side:
            break
        im = area_resize(levels[-1][0], h // 2, w // 2)
        mk = area_resize(levels[-1][1], h // 2, w // 2)
        levels.append((im, (mk > 0.5).astype(np.float32)))
    return levels[::-1]


def refine_predict(gen: lama.FFCResNetGenerator, image: np.ndarray,
                   mask: np.ndarray, *, n_iters: int = 15, lr: float = 2e-3,
                   min_side: int = 512, px_budget: float = 1.8e6,
                   max_scales: int = 3, mask_dilate_iters: int = 5,
                   inpainter: Inpainter | None = None) -> np.ndarray:
    """Multiscale latent-refined inpainting (`refinement.py:245-309`, one
    device). The latents are optimised by `torch.optim.Adam(lr, betas=(0.9,
    0.999), eps=1e-8)`, which is optax's `adam(lr)`. Returns the inpainted
    image at the pyramid's finest size."""
    inpainter = inpainter or Inpainter(gen)
    levels = _build_pyramid(image, mask, min_side=min_side,
                            px_budget=px_budget, max_scales=max_scales)
    prev = None   # the previous level's result [ph, pw, 3]
    for img_l, mask_l in levels:
        if mask_dilate_iters > 0:
            mask_l = dilate_mask(mask_l, iterations=mask_dilate_iters)
        inp, m_p, _, (h, w) = _net_input(img_l, mask_l)
        z = inpainter.front(inpainter.tensor(inp))
        if prev is not None and n_iters > 0:
            ph, pw = prev.shape[:2]
            # the mask at the reference's scale, from the unpadded region
            # (the mod-8 padding would shift the loss window at the edges)
            m_ref = area_resize(m_p[:h, :w, 0], ph, pw) > 1e-6
            args = [inpainter.tensor(a) for a in (
                prev.transpose(2, 0, 1), m_ref[None].astype(np.float32),
                img_l.transpose(2, 0, 1), m_p[:h, :w].transpose(2, 0, 1))]
            z = tuple(t.detach().clone().requires_grad_() for t in z)
            opt = torch.optim.Adam(z, lr=lr, betas=(0.9, 0.999), eps=1e-8)
            for _ in range(n_iters):
                inpainter.refine_step(z, opt, *args)
        pred = inpainter.rear(z)[0].permute(1, 2, 0).cpu().numpy()
        prev = pred[:h, :w] * m_p[:h, :w] + img_l * (1 - m_p[:h, :w])
    return prev


def load_generator(checkpoint_path=None, device=None, **kwargs):
    """The big-lama generator (`kwargs` go to `FFCResNetGenerator`) on
    `device` (the card unless the caller asks for the CPU), frozen. Its
    weights come from `checkpoint_path`, else from `big-lama.ckpt` in
    `SPINNERF_WEIGHTS_DIR`: the file's `state_dict` (or the file itself),
    its `generator.` / `model.` keys with `generator.` stripped, loaded
    strictly. With neither, the weights are seeded random
    (`reset_parameters` from `torch.Generator().manual_seed(0)`): they
    work as a generator but are not the JAX package's flax init."""
    gen = lama.FFCResNetGenerator(device="cpu", **kwargs)
    if checkpoint_path is None:
        checkpoint_path = wreg.find("big_lama")
    if checkpoint_path is not None:
        ckpt = torch.load(checkpoint_path, map_location="cpu")
        sd = ckpt.get("state_dict", ckpt)
        gen.load_state_dict({k.removeprefix("generator."): v
                             for k, v in sd.items()
                             if k.startswith(("generator.", "model."))})
    else:
        gen.reset_parameters(torch.Generator().manual_seed(0))
    return gen.to(resolve_device(device)).requires_grad_(False)


def inpaint_directory(in_dir, out_dir, *, checkpoint_path=None,
                      refine: bool = False, inpainter: Inpainter | None = None,
                      device=None, **refine_kwargs):
    """LaMa's predict-CLI contract (`bin/predict.py:60-101`, SPIn-NeRF's
    staging names): each `<in_dir>/<name>.png|jpg|jpeg` (not `*_mask*`) with
    its mask `<in_dir>/label/<name>.png`, else `<in_dir>/<name>_mask*`,
    inpainted into `<out_dir>/<name>.png` (the output truncated to uint8, as
    the JAX package writes it). Pass `inpainter` to share one loaded
    generator across directories; else one is loaded on `device`."""
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    if inpainter is None:
        inpainter = Inpainter(load_generator(checkpoint_path, device))
    images = sorted(p for p in in_dir.iterdir()
                    if p.suffix.lower() in (".png", ".jpg", ".jpeg")
                    and "_mask" not in p.stem)
    for p in images:
        img = llff.imread_rgb8(p).astype(np.float32) / 255.0
        mp = in_dir / "label" / (p.stem + ".png")
        if not mp.exists():
            mp = next(iter(sorted(in_dir.glob(p.stem + "_mask*"))),
                      in_dir / (p.stem + "_mask.png"))
        if not mp.exists():
            raise FileNotFoundError(mp)
        m = (llff.imread_gray8(mp).astype(np.float32) / 255.0 > 0.5)
        m = m.astype(np.float32)
        if m.shape != img.shape[:2]:
            m = nearest_resize(m, *img.shape[:2])
        if refine:
            out = refine_predict(inpainter.gen, img, m, inpainter=inpainter,
                                 **refine_kwargs)
        else:
            out = predict(inpainter.gen, img, m, inpainter=inpainter)
        if out.shape[:2] != img.shape[:2]:
            out = area_resize(out, *img.shape[:2])
        write_png(out_dir / (p.stem + ".png"),
                  (np.clip(out, 0, 1) * 255).astype(np.uint8))
    return out_dir
