"""Extra render-path generators (port of `spinnerf_tpu/utils/renderpath.py`,
parity: `DS_NeRF/utils/generate_renderpath.py`).

`generate_renderpath` produces a small circular orbit around given poses —
the `--render_mypath` mode's camera path (`run_nerf.py:1124-1127`).
"""
from __future__ import annotations

import numpy as np

from spinnerf_tpu_torch.data.llff import _normalize, view_matrix


def generate_renderpath(poses, focal, *, sc: float = 1.0, n: int = 40,
                        rad_scale: float = 0.1):
    """Circular path around each given pose (concatenated).

    Args:
      poses: [M, 3, 4] anchor c2w poses.
      focal: look-at distance.
    Returns: [M*n, 3, 4] float32.
    """
    out = []
    for pose in np.asarray(poses):
        center = pose[:3, 3]
        up = pose[:3, 1]
        forward = pose[:3, 2]
        radius = rad_scale * sc
        right = _normalize(np.cross(up, forward))
        true_up = _normalize(np.cross(forward, right))
        target = center - focal * sc * forward
        for th in np.linspace(0, 2 * np.pi, n, endpoint=False):
            c = center + radius * (np.cos(th) * right + np.sin(th) * true_up)
            z = _normalize(c - target)
            out.append(view_matrix(z, up, c))
    return np.stack(out).astype(np.float32)
