"""Live training control (port of `spinnerf_tpu/utils/live_control.py`): the
training loop polls a JSON control file between steps, at `i_print`, in place
of the reference's tkinter GUI thread, which changes `args` while the loop
runs (`DS_NeRF/run_nerf.py:928-960`). Same live knobs, no threads:

    echo '{"render_factor": 4, "i_video": 2000}' > <expdir>/control.json
"""
from __future__ import annotations

import json
import os

MUTABLE_KEYS = {"feat_weight", "i_video", "i_testset", "i_weights", "i_print",
                "render_factor", "white_bkgd", "i_feat"}


class LiveControl:
    def __init__(self, cfg, *, log=print):
        self.cfg = cfg
        self.path = cfg.exp_dir() / "control.json"
        self.log = log
        self._mtime = None

    def poll(self):
        """Apply the control file if it changed since the last poll; returns
        the dict applied. Keys outside `MUTABLE_KEYS` and values that do not
        convert to the option's type are logged and skipped."""
        try:
            mtime = os.stat(self.path).st_mtime
        except FileNotFoundError:
            return {}
        if mtime == self._mtime:
            return {}
        self._mtime = mtime
        try:
            data = json.loads(self.path.read_text())
        except (json.JSONDecodeError, OSError) as e:
            self.log(f"[control] ignoring unreadable control file: {e}")
            return {}
        applied = {}
        for k, v in data.items():
            if k not in MUTABLE_KEYS:
                self.log(f"[control] key not mutable: {k}")
                continue
            cur = getattr(self.cfg, k, None)
            if cur is not None and type(cur) is not type(v):
                try:
                    v = type(cur)(v)
                except (TypeError, ValueError):
                    self.log(f"[control] bad value for {k}: {v!r}")
                    continue
            setattr(self.cfg, k, v)
            applied[k] = v
        if applied:
            self.log(f"[control] applied {applied}")
        return applied
