"""Slab-index checkpoint/resume for long video jobs (copy of
``dspfun_tpu/utils/checkpoint.py``).

The reference has no computation-state persistence; its manual resume
story is --offset/--frames seeking (SURVEY.md section 5).  motion, scan
and zoom take ``--resume-file <path>``: after each slab, chunk or frame
is written the state file records its index, and a rerun with the same
flags appends output from the recorded point.
"""

from __future__ import annotations

import json
import os

__all__ = ["load_state", "save_state"]


def load_state(path: str) -> dict:
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def save_state(path: str, state: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
    os.replace(tmp, path)
