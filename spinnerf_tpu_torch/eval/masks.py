"""Learned object-mask generation for inpainting eval datasets (port of
`spinnerf_tpu/eval/masks.py`).

Parity: `lama/saicinpainting/evaluation/masks/mask.py:19-429`. The
reference segments each image with a detectron2 COCO-panoptic model, picks
"thing" instances below `max_object_area`, and for each proposes up to
`num_variants_per_mask` augmented masks (rescale / horizontal flip /
vertical + horizontal shift) that avoid covering foreground objects.

As in the JAX package, the learned segmenter is the ADE20k zoo
(`models/segmentation.py`, here on the card); semantic labels carry no
instance ids, so instances are the connected components (scipy) of each
non-"stuff" class (`ade20k_instances`). Any `instances_fn(image) -> [bool
masks]` plugs into `LearnedMaskGenerator`.

`ObjectMask`, `LearnedMaskGenerator` and `propose_random_square_crop` are
the JAX package's numpy code; its `cv2.resize(INTER_NEAREST)` calls are
`utils/resize.py::nearest_resize`, which gives cv2's result.
"""
from __future__ import annotations

import enum

import numpy as np

from spinnerf_tpu_torch.utils.countless import countless2d
from spinnerf_tpu_torch.utils.resize import nearest_resize


class RigidnessMode(enum.Enum):
    soft = 0
    rigid = 1


class ObjectMask:
    """A boolean mask stored as (bbox, cropped patch); supports the
    augmentations the reference applies (`mask.py:19-133`)."""

    def __init__(self, mask):
        self.height, self.width = mask.shape
        ys = mask.any(axis=1)
        xs = mask.any(axis=0)
        if ys.any():
            self.up = int(ys.argmax())
            self.down = int(len(ys) - ys[::-1].argmax())
            self.left = int(xs.argmax())
            self.right = int(len(xs) - xs[::-1].argmax())
            self.mask = mask[self.up:self.down, self.left:self.right].copy()
        else:
            self._clean()

    def _clean(self):
        self.up = self.down = self.left = self.right = 0
        self.mask = np.zeros((0, 0), bool)

    def copy(self):
        import copy
        return copy.deepcopy(self)

    def area(self):
        return int(self.mask.sum())

    def horizontal_flip(self):
        self.mask = self.mask[:, ::-1]
        return self

    def rescale(self, factor):
        if self.mask.size == 0:
            return self
        h = max(1, int(round(self.mask.shape[0] * factor)))
        w = max(1, int(round(self.mask.shape[1] * factor)))
        scaled = nearest_resize(self.mask.astype(np.uint8), h, w) > 0
        yc = self.up + (self.down - self.up) / 2
        xc = self.left + (self.right - self.left) / 2
        sub = ObjectMask(scaled)
        if sub.mask.size == 0:
            self._clean()
            return self
        self.mask = sub.mask
        mh, mw = self.mask.shape
        self.up = int(round(yc - mh / 2))
        self.down = self.up + mh
        self.left = int(round(xc - mw / 2))
        self.right = self.left + mw
        return self

    def shift(self, vertical=0, horizontal=0):
        self.up += vertical
        self.down += vertical
        self.left += horizontal
        self.right += horizontal
        return self

    def crop_to_canvas(self, vertical=True, horizontal=True):
        if vertical:
            if self.up >= self.height or self.down <= 0:
                self._clean()
            else:
                cut_up = max(-self.up, 0)
                cut_down = max(self.down - self.height, 0)
                if cut_up:
                    self.mask = self.mask[cut_up:]
                    self.up = 0
                if cut_down:
                    self.mask = self.mask[:-cut_down]
                    self.down = self.height
        if horizontal and self.mask.size >= 0:
            if self.left >= self.width or self.right <= 0:
                self._clean()
            else:
                cut_left = max(-self.left, 0)
                cut_right = max(self.right - self.width, 0)
                if cut_left:
                    self.mask = self.mask[:, cut_left:]
                    self.left = 0
                if cut_right:
                    self.mask = self.mask[:, :-cut_right]
                    self.right = self.width
        return self

    def restore_full_mask(self):
        c = self.copy().crop_to_canvas()
        out = np.zeros((self.height, self.width), bool)
        if c.mask.size:
            out[c.up:c.down, c.left:c.right] = c.mask
        return out


# ---------------------------------------------------------------------------
# learned segmenter: ADE20k zoo -> instance masks
# ---------------------------------------------------------------------------

# ADE20k classes treated as scene "stuff" (never object candidates): wall,
# building, sky, floor, tree, ceiling, road, grass, earth, mountain, water,
# field, rock, path, sand, sea, river (0-based MIT ids)
_ADE20K_STUFF = frozenset({0, 1, 2, 3, 4, 5, 6, 9, 13, 16, 21, 26, 29, 34,
                           46, 52, 60})


def ade20k_instances(weights_path=None, *, decoder_path=None,
                     min_area_frac: float = 0.005,
                     stuff_ids=_ADE20K_STUFF, seed: int = 0, device=None):
    """`instances_fn(image [H, W, 3] in [0, 1]) -> [bool masks]` from the
    ADE20k zoo on `device` (the card unless the caller asks for the CPU).
    MIT weights, both the encoder and the ppm_deepsup decoder, come from
    `$SPINNERF_WEIGHTS_DIR` (`weights.py`); a missing half stays seeded
    random (architecture-exercising only: its labels are then not object
    classes). Instances are the connected components of each non-"stuff"
    class."""
    import torch
    from scipy import ndimage

    from spinnerf_tpu_torch.models.segmentation import (
        imagenet_normalize, load_segmentation_model)

    model, _ = load_segmentation_model(weights_path, decoder_path,
                                       seed=seed, device=device)
    dev = next(model.parameters()).device

    def instances_fn(image):
        x = torch.as_tensor(np.asarray(image, np.float32), device=dev)
        with torch.no_grad():
            logits = model(imagenet_normalize(x.permute(2, 0, 1)[None]))
        labels = torch.argmax(logits[0], dim=0).cpu().numpy()
        masks = []
        min_area = min_area_frac * labels.size
        for cls in np.unique(labels):
            if int(cls) in stuff_ids:
                continue
            comp, n = ndimage.label(labels == cls)
            for i in range(1, n + 1):
                m = comp == i
                if m.sum() >= min_area:
                    masks.append(m)
        return masks

    return instances_fn


# ---------------------------------------------------------------------------
# mask proposal (reference SegmentationMask parity)
# ---------------------------------------------------------------------------

class LearnedMaskGenerator:
    """Propose plausible object-removal masks for an image
    (`mask.py:140-407` with the same defaults)."""

    def __init__(self, instances_fn, *,
                 rigidness_mode=RigidnessMode.rigid,
                 max_object_area=0.3, min_mask_area=0.02,
                 downsample_levels=6, num_variants_per_mask=4,
                 max_mask_intersection=0.5, max_foreground_coverage=0.5,
                 max_foreground_intersection=0.5, max_hidden_area=0.2,
                 max_scale_change=0.25, horizontal_flip=True,
                 max_vertical_shift=0.1, position_shuffle=True, seed=0):
        self.instances_fn = instances_fn
        self.rigidness_mode = RigidnessMode(rigidness_mode)
        self.max_object_area = max_object_area
        self.min_mask_area = min_mask_area
        self.downsample_levels = downsample_levels
        self.num_variants_per_mask = num_variants_per_mask
        self.max_mask_intersection = max_mask_intersection
        self.max_foreground_coverage = max_foreground_coverage
        self.max_foreground_intersection = max_foreground_intersection
        self.max_hidden_area = max_hidden_area
        self.max_scale_change = max_scale_change
        self.horizontal_flip = horizontal_flip
        self.max_vertical_shift = max_vertical_shift
        self.position_shuffle = position_shuffle
        self.rng = np.random.RandomState(seed)

    # -- placement-search helpers (run on the COUNTLESS-downsampled masks) --

    def _downsample(self, mask):
        h, w = mask.shape
        th = 1 << max(int(h - 1).bit_length(), self.downsample_levels)
        tw = 1 << max(int(w - 1).bit_length(), self.downsample_levels)
        m = nearest_resize(mask.astype(np.uint8), th, tw)
        for _ in range(max(tw.bit_length() - 1 - self.downsample_levels, 0)):
            if min(m.shape) <= 1:
                break
            m = countless2d(m)
        return m > 0

    def _augmentation_params(self):
        return {
            "scaling_factor": self.rng.uniform(1 - self.max_scale_change,
                                               1 + self.max_scale_change),
            "horizontal_flip": (bool(self.rng.randint(2))
                                if self.horizontal_flip else False),
            "vertical_shift": self.rng.uniform(-self.max_vertical_shift,
                                               self.max_vertical_shift),
        }

    @staticmethod
    def _intersection(mask_array, obj):
        if obj.mask.size == 0:
            return np.zeros((0, 0), bool)
        return mask_array[obj.up:obj.down, obj.left:obj.right] & obj.mask

    def _masks_ok(self, aug, total_area, prev_masks):
        for existing in prev_masks:
            inter = self._intersection(existing, aug).sum()
            if existing.sum() and inter / existing.sum() > \
                    self.max_mask_intersection:
                return False
            if total_area and 1 - (aug.area() - inter) / total_area > \
                    self.max_mask_intersection:
                return False
        return True

    def _foreground_ok(self, aug, foreground):
        for fg in foreground:
            inter = self._intersection(fg, aug).sum()
            if fg.sum() and inter / fg.sum() > self.max_foreground_coverage:
                return False
            if aug.area() and inter / aug.area() > \
                    self.max_foreground_intersection:
                return False
        return True

    def _move_mask(self, mask, foreground):
        """Search augmented placements on the downsampled grid; return the
        accepted parameter sets (`mask.py:271-349`)."""
        orig = ObjectMask(mask)
        chosen_masks, chosen_params = [], []
        scale_lower = 0.0
        for _ in range(self.num_variants_per_mask):
            params = self._augmentation_params()
            params["scaling_factor"] = min(
                params["scaling_factor"],
                2 * min(orig.up, orig.height - orig.down) / orig.height + 1.0,
                2 * min(orig.left, orig.width - orig.right) / orig.width
                + 1.0)
            params["scaling_factor"] = max(params["scaling_factor"],
                                           scale_lower)
            aug = orig.copy().rescale(params["scaling_factor"])
            if params["horizontal_flip"]:
                aug.horizontal_flip()
            total = aug.area()
            if total == 0:
                scale_lower = 1.0
                continue

            # bound the vertical shift so at most max_hidden_area of the
            # object leaves the canvas
            v_area = aug.mask.sum(axis=1) / total
            hid_up = int(np.searchsorted(v_area.cumsum(),
                                         self.max_hidden_area))
            hid_down = int(np.searchsorted(v_area[::-1].cumsum(),
                                           self.max_hidden_area))
            params["vertical_shift"] = float(np.clip(
                params["vertical_shift"],
                -(aug.up + hid_up) / aug.height,
                (aug.height - aug.down + hid_down) / aug.height))
            aug.shift(vertical=int(round(aug.height
                                         * params["vertical_shift"])))
            aug.crop_to_canvas(vertical=True, horizontal=False)
            if aug.mask.size == 0:
                continue

            remaining_hidden = self.max_hidden_area - (1 - aug.area() / total)
            h_area = aug.mask.sum(axis=0) / total
            hid_left = int(np.searchsorted(h_area.cumsum(), remaining_hidden))
            hid_right = int(np.searchsorted(h_area[::-1].cumsum(),
                                            remaining_hidden))
            shifts = np.arange(-hid_left,
                               aug.width - (aug.right - aug.left)
                               + hid_right + 1)
            shifts = -(aug.left - shifts)
            if self.position_shuffle:
                self.rng.shuffle(shifts)

            for hshift in shifts:
                cand = aug.copy().shift(horizontal=int(hshift))
                cand.crop_to_canvas()
                if cand.mask.size == 0 or cand.area() == 0:
                    continue
                if self._masks_ok(cand, total, [mask] + chosen_masks) and \
                        self._foreground_ok(cand, foreground):
                    chosen_masks.append(cand.restore_full_mask())
                    params["horizontal_shift"] = float(hshift) / cand.width
                    chosen_params.append(dict(params))
                    break
            else:
                break
        return chosen_params

    def get_masks(self, image):
        """image [H, W, 3] float in [0,1] -> list of [H, W] uint8 masks."""
        instances = self.instances_fn(image)
        h, w = np.asarray(image).shape[:2]
        total = float(h * w)

        candidates = [m for m in instances
                      if m.sum() / total < self.max_object_area]
        scene_small = [self._downsample(m) for m in instances]

        mask_set = []
        for cand in candidates:
            small = self._downsample(cand)
            if not small.any():
                continue
            if self.rigidness_mode is RigidnessMode.soft:
                foreground = [small]
            else:
                foreground = scene_small
            for params in self._move_mask(small, foreground):
                aug = ObjectMask(cand).rescale(params["scaling_factor"])
                if params["horizontal_flip"]:
                    aug.horizontal_flip()
                aug.shift(
                    vertical=int(round(aug.height
                                       * params["vertical_shift"])),
                    horizontal=int(round(aug.width
                                         * params["horizontal_shift"])))
                full = aug.restore_full_mask().astype(np.uint8)
                if full.mean() <= self.min_mask_area:
                    continue
                mask_set.append(full)
        return mask_set


def propose_random_square_crop(mask, min_overlap=0.5, rng=None):
    """Square crop window overlapping >= min_overlap of the mask
    (`mask.py:410-429`; mask==1 is the hole)."""
    rng = rng or np.random
    height, width = mask.shape
    ys, xs = np.where(mask > 0.5)
    if height < width:
        crop = height
        left, right = xs.min(), xs.max()
        ow = right - left
        lo = max(0, min(width - crop - 1, left + ow * min_overlap - crop))
        hi = max(lo + 1, min(width - crop, left + ow * min_overlap))
        x0 = int(rng.randint(int(lo), int(hi)))
        return x0, 0, x0 + crop, height
    crop = width
    top, bottom = ys.min(), ys.max()
    oh = bottom - top
    lo = max(0, min(height - crop - 1, top + oh * min_overlap - crop))
    hi = max(lo + 1, min(height - crop, top + oh * min_overlap))
    y0 = int(rng.randint(int(lo), int(hi)))
    return 0, y0, width, y0 + crop
