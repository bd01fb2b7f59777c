"""LLFF-style scenes: the `Scene` container and the view split (port of
`spinnerf_tpu/data/llff.py`). Loading a scene from disk is not ported yet
(ROADMAP.md queue A); callers hand `Trainer` a `Scene` of numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Scene:
    """A loaded scene, everything as numpy (host) arrays."""
    images: np.ndarray            # [N, H, W, 3] float32 in [0,1]
    poses: np.ndarray             # [N, 3, 4] c2w (LLFF world frame)
    bounds: np.ndarray            # [N, 2] per-view near/far
    render_poses: np.ndarray      # [M, 3, 4] spiral/eval path
    hwf: tuple                    # (H, W, focal)
    i_holdout: int                # closest-to-mean view
    masks: np.ndarray | None = None            # [N, H, W]; >0 inpaint region,
    #                                            <0 view excluded from masked sup.
    inpainted_depths: np.ndarray | None = None  # [N, H, W] float32 in [0,1]
    mask_indices: list = field(default_factory=list)
    masks_gt: np.ndarray | None = None         # [N, H, W] GT masks (MVSeg eval)
    scale: float = 1.0            # world rescale applied (1/(min_bd*bd_factor))

    @property
    def near(self) -> float:
        return float(self.bounds.min()) * 0.9

    @property
    def far(self) -> float:
        return float(self.bounds.max()) * 1.0


def train_test_split(n_images: int, *, n_gt: int = 0, train_gt: bool = False,
                     llffhold: int = 0, n_train: int | None = None,
                     train_scene=None, test_scene=None):
    """The reference's view split: N_gt object-removed GT views come first
    and become the test set; with llffhold > 0 and no N_gt the holdout views
    stay inside i_train; `test_scene` overrides the holdout (a single
    negative index means none) and `train_scene` restricts training, both
    before the N_gt logic. Returns (i_train, i_test)."""
    i_all = np.arange(n_images)
    if llffhold > 0:
        i_test = i_all[::llffhold]
    else:
        i_test = np.array([], dtype=int)
    if test_scene:
        i_test = np.asarray(list(test_scene), dtype=int)
        if len(i_test) and i_test[0] < 0:
            i_test = np.array([], dtype=int)
    if train_scene:
        i_train = np.asarray([i for i in train_scene if i not in i_test],
                             dtype=int)
    else:
        i_train = i_all
    if n_gt > 0:
        if train_gt:
            i_test = i_train
            i_train = i_train[:n_gt]
        else:
            i_test = i_train[:n_gt]
            i_train = (i_train[n_gt:] if n_train is None
                       else i_train[n_gt:n_gt + n_train])
    return np.asarray(i_train), np.asarray(i_test)
