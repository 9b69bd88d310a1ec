"""Terminal progress bar for hapi fit/evaluate/predict loops (a copy of
paddle_tpu/hapi/progressbar.py).

Reference parity: python/paddle/hapi/progressbar.py (ProgressBar used by
ProgBarLogger). Kept dependency-free; prints `step/total - key: value` lines.
"""
from __future__ import annotations

import sys
import time


class ProgressBar:
    def __init__(self, num=None, width=30, verbose=1, start=True, file=sys.stdout):
        self._num = num
        self._width = width
        self._verbose = verbose
        self._file = file
        self._last_update = 0.0
        self._start_time = time.time() if start else None

    def start(self):
        self._start_time = time.time()

    def update(self, current_num, values=None):
        if self._verbose == 0:
            return
        now = time.time()
        # throttle redraws in verbose=1 mode (every step prints in verbose=2)
        if self._verbose == 1 and current_num != self._num and now - self._last_update < 0.05:
            return
        self._last_update = now
        msg = f"step {current_num}"
        if self._num:
            msg += f"/{self._num}"
        if self._start_time is not None and current_num:
            per_step = (now - self._start_time) / current_num
            if per_step >= 1:
                msg += f" - {per_step:.0f}s/step"
            elif per_step >= 1e-3:
                msg += f" - {per_step * 1e3:.0f}ms/step"
            else:
                msg += f" - {per_step * 1e6:.0f}us/step"
        for k, v in values or []:
            if isinstance(v, (list, tuple)):
                v = v[0] if len(v) == 1 else list(v)
            if isinstance(v, float):
                msg += f" - {k}: {v:.4f}"
            else:
                msg += f" - {k}: {v}"
        end = "\n" if (self._verbose == 2 or current_num == self._num) else "\r"
        print(msg, end=end, file=self._file)
        self._file.flush()
