"""Config loading: the JSON schema of `configs/*.json`.

Top-level scalars (`fg_exist_thr`, `colorfiltering_update_duration`,
`colorfiltering_train_iters`, `objectremoval.*`) plus one sub-dict per
agent, as in `video_unscreen_tpu/config.py`. The drivers add a `data`
section whose root comes from `--data_root` or $UNSCREEN_DATA_ROOT.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Optional

import torch


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def select_device(device_id: Optional[int] = None) -> Optional[torch.device]:
    """The CUDA device this process runs on, from `device_id` or
    $UNSCREEN_DEVICE_ID (which `tools/unscreen.sh` exports per worker),
    made the current device. None when neither names a card that exists:
    the caller's default placement stands."""
    if device_id is None:
        raw = os.environ.get("UNSCREEN_DEVICE_ID")
        if raw is None or not raw.strip().lstrip("-").isdigit():
            return None
        device_id = int(raw)
    if not (torch.cuda.is_available()
            and 0 <= device_id < torch.cuda.device_count()):
        return None
    torch.cuda.set_device(device_id)
    return torch.device("cuda", device_id)


def default_data_root() -> str:
    return os.environ.get("UNSCREEN_DATA_ROOT", "./data")


def attach_data_section(cfg: dict, video_id: str, mode: str,
                        data_root: Optional[str] = None,
                        frame_range: Optional[str] = None,
                        src_tmpl: str = "*.*") -> dict:
    """A copy of `cfg` with the `data` section the drivers read: the clip
    under `<root>/src_img/<video_id>`, artifacts under
    `<root>/test_<mode>_img/<video_id>`, `frame_range` "a-b" as [a, b]."""
    root = data_root or default_data_root()
    data = {
        "video_id": video_id,
        "range": ([int(i) for i in frame_range.split("-")]
                  if frame_range else None),
        "src_img_dir": osp.join(root, "src_img", video_id),
        "src_img_tmpl": src_tmpl,
        "dst_img_dir": osp.join(root, f"test_{mode}_img", video_id),
        "dst_vid_dir": osp.join(root, "video"),
    }
    cfg = dict(cfg)
    cfg["data"] = data
    return cfg
