"""Mask refinement: shrink object masks to true occlusions by multi-view
reprojection through NeRF depth (port of
`spinnerf_tpu/pipeline/mask_refine.py`).

Reference algorithm (`mask_refinement.py:29-224`): for every masked pixel of a
source view, candidate surface depths are the render's z-samples with
significant alpha at/behind the rendered depth; each candidate is unprojected
to world and reprojected into target views. If the target pixel is unmasked
and its surface depth agrees (relative error < distance_thresh), the target's
surface is projected back into the source frame, a source neighbor-disparity
consistency check runs, and on success the pixel is un-masked with the target
color/disparity pasted in. Every (src, tgt) pair runs, vectorized over
pixels x candidate samples, as in the JAX package.

The views are tensors on one device (the card unless `device="cpu"`). The
geometry runs in float64 and each map keeps the dtype it was loaded in, as
the JAX package's numpy computes them: the decisions `< distance_thresh`
and the truncation of projected coordinates to pixel indices flip in
float32. The rotations are written out as products and sums
(`utils/correspondence.py`), so the card and the CPU give the same bits.

Camera model: NeRF-convention c2w poses (camera looks -z, y up) and the
z-sample parameterization of `core.rays` (z_val multiplies the pixel dir with
dz = -1), so depth == -z_cam of the surface point.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from spinnerf_tpu_torch import resolve_device
from spinnerf_tpu_torch.eval.render import read_png, write_png
from spinnerf_tpu_torch.utils.correspondence import project, unproject


@dataclass
class ViewDump:
    """Per-view render products (the `render_path` savedir contract), as
    tensors on one device."""
    image: torch.Tensor   # [H, W, 3] float32 in [0,1]
    mask: torch.Tensor    # [H, W] binary
    z: torch.Tensor       # [H, W, S] sample depths
    alpha: torch.Tensor   # [H, W, S]
    depth: torch.Tensor   # [H, W] rendered depth
    disp: torch.Tensor    # [H, W] rendered disparity
    c2w: torch.Tensor     # [4, 4] float64 NeRF-convention camera-to-world


def load_view_dumps(render_dir, masks, *, device=None) -> list[ViewDump]:
    """Load the artifact tree written by `eval.render.render_path` (rgb/,
    z/, alpha/, depth/, disp/, pose/) onto `device`; masks[i] ([H, W]
    array) is view i's object mask (|m| > 0.5)."""
    dev = resolve_device(device)
    render_dir = Path(render_dir)
    n = len(list((render_dir / "rgb").glob("*.png")))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    out = []
    for i in range(n):
        img = read_png(render_dir / "rgb" / f"{i:06d}.png")[..., :3]
        m = np.asarray(masks[i])
        out.append(ViewDump(
            image=put(img.astype(np.float32) / 255.0),
            mask=put((np.abs(m) > 0.5).astype(np.float32)),
            z=put(np.load(render_dir / "z" / f"{i:06d}.npy")),
            alpha=put(np.load(render_dir / "alpha" / f"{i:06d}.npy")),
            depth=put(np.load(render_dir / "depth" / f"{i:06d}.npy")),
            disp=put(np.load(render_dir / "disp" / f"{i:06d}.npy")),
            c2w=put(np.loadtxt(render_dir / "pose" / f"{i:06d}.txt")),
        ))
    return out


def _neighbour_disps(disp, ys, xs):
    """The 8 neighbours' values [8, n] of pixels (ys, xs) in `disp`, edge
    pixels repeated past the border (np.pad's "edge")."""
    pads = F.pad(disp[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
    return torch.stack([pads[ys + dy, xs + dx]
                        for dy in (0, 1, 2) for dx in (0, 1, 2)
                        if not (dy == 1 and dx == 1)])


def refine_view(src: ViewDump, targets: list[ViewDump], *, focal, cx, cy,
                alpha_thresh: float = 0.1, distance_thresh: float = 0.01):
    """Refine one source view against target views.

    Returns (image, mask, disp) — copies with refined pixels updated.
    """
    h, w = src.mask.shape
    img = src.image.clone()
    mask = src.mask.clone()
    disp = src.disp.clone()

    ys, xs = torch.nonzero(mask > 0.5, as_tuple=True)
    if len(ys) == 0:
        return img, mask, disp

    # candidate surface depths per masked pixel: significant alpha at/behind
    # the rendered depth (`mask_refinement.py:71-78`)
    z_pix = src.z[ys, xs]                       # [P, S]
    a_pix = src.alpha[ys, xs]                   # [P, S]
    a_max = a_pix.amax(dim=-1, keepdim=True)
    cand = ((a_pix >= alpha_thresh * a_max)
            & (z_pix >= src.depth[ys, xs][:, None]))

    u_a = xs.to(torch.float64)[:, None]
    v_a = ys.to(torch.float64)[:, None]
    world = unproject(u_a, v_a, z_pix.to(torch.float64), src.c2w,
                      focal, cx, cy)            # [P, S, 3]

    for tgt in targets:
        if tgt is src:
            continue
        u_b, v_b, z_b = project(world, tgt.c2w, focal, cx, cy)
        # truncation toward zero, then the clip (numpy's astype, then clip)
        ui = torch.clamp(u_b.to(torch.int64), 0, w - 1)
        vi = torch.clamp(v_b.to(torch.int64), 0, h - 1)
        in_bounds = (u_b >= 0) & (u_b < w) & (v_b >= 0) & (v_b < h) & (z_b > 0)

        tgt_unmasked = tgt.mask[vi, ui] < 0.5
        tgt_surf_z = 1.0 / torch.clamp(tgt.disp[vi, ui], min=1e-9)
        agree = ((z_b - tgt_surf_z).abs() / torch.clamp(z_b, min=1e-9)
                 < distance_thresh)
        valid = cand & in_bounds & tgt_unmasked & agree        # [P, S]

        has = valid.any(dim=-1)
        if not bool(has.any()):
            continue
        # the first valid sample (np.argmax of a boolean); argmax of the
        # integers returns the first of equal maxima
        first = torch.argmax(valid.to(torch.int32), dim=-1)    # [P]
        pi = torch.nonzero(has, as_tuple=True)[0]
        si = first[pi]

        # project the target's surface point back into the source frame
        tw = unproject(u_b[pi, si], v_b[pi, si], tgt_surf_z[pi, si],
                       tgt.c2w, focal, cx, cy)
        _, _, proj_z = project(tw, src.c2w, focal, cx, cy)

        # source neighbor-disparity consistency against the LIVE disp map
        # (`mask_refinement.py:195-205` reads src_disp as it is updated)
        neigh = _neighbour_disps(disp, ys[pi], xs[pi])
        nd = (1.0 / torch.clamp(proj_z, min=1e-9) - neigh).abs().amin(dim=0)
        ok = nd < distance_thresh
        pi = pi[ok]
        if len(pi) == 0:
            continue
        si = si[ok]
        proj_z = proj_z[ok]

        # re-refinement gate (`mask_refinement.py:194`): update while still
        # masked, OR when a later target sees a CLOSER agreeing surface
        # than the one already pasted (src_disp < 1/z_val)
        cand_disp = 1.0 / torch.clamp(proj_z, min=1e-9)
        keep = (mask[ys[pi], xs[pi]] > 0.5) | (disp[ys[pi], xs[pi]] < cand_disp)
        pi, si, cand_disp = pi[keep], si[keep], cand_disp[keep]
        if len(pi) == 0:
            continue

        img[ys[pi], xs[pi]] = tgt.image[vi[pi, si], ui[pi, si]]
        mask[ys[pi], xs[pi]] = 0.0
        disp[ys[pi], xs[pi]] = cand_disp.to(disp.dtype)

    return img, mask, disp


def refine_all(dumps: list[ViewDump], *, focal, cx, cy,
               alpha_thresh: float = 0.1, distance_thresh: float = 0.01,
               out_dir=None, names=None):
    """Refine every view; optionally write the reference's output layout
    (`refined_images/`, `refined_images/label/`, `refined_disp/`: 8-bit
    PNGs, values truncated as `(x * 255).astype(uint8)` truncates)."""
    results = [refine_view(src, dumps, focal=focal, cx=cx, cy=cy,
                           alpha_thresh=alpha_thresh,
                           distance_thresh=distance_thresh)
               for src in dumps]
    if out_dir is not None:
        out_dir = Path(out_dir)
        (out_dir / "refined_images" / "label").mkdir(parents=True,
                                                     exist_ok=True)
        (out_dir / "refined_disp").mkdir(parents=True, exist_ok=True)
        for i, (img, mask, disp) in enumerate(results):
            name = names[i] if names else f"{i:06d}.png"
            img, mask, disp = (t.cpu().numpy() for t in (img, mask, disp))
            write_png(out_dir / "refined_images" / name,
                      (img * 255).astype(np.uint8))
            write_png(out_dir / "refined_images" / "label" / name,
                      (mask * 255).astype(np.uint8))
            write_png(out_dir / "refined_disp" / name,
                      (np.clip(disp, 0, 1) * 255).astype(np.uint8))
    return results
