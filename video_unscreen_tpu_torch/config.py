"""Config loading: the JSON schema of `configs/*.json`.

Top-level scalars (`fg_exist_thr`, `colorfiltering_update_duration`,
`colorfiltering_train_iters`, `objectremoval.*`) plus one sub-dict per
agent, as in `video_unscreen_tpu/config.py:load_config`.
"""

from __future__ import annotations

import json


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
