"""Progress reporting and artifact publishing.

Counterpart of the parts of `clip_diffusion_tpu.utils.progress` that
`sample.py` uses: the task-state keys (`current_batch`, `current_step`,
`current_result`) in a thread-safe store and the local-disk uploader.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict


class TaskState:
    """Thread-safe task-state dict."""

    def __init__(self):
        self._lock = threading.Lock()
        self._state: Dict[str, Any] = {}

    def store(self, key: str, value: Any) -> None:
        with self._lock:
            self._state[key] = value

    def get(self, key: str, default=None):
        with self._lock:
            return self._state.get(key, default)


_GLOBAL_STATE = TaskState()


def store_task_state(key: str, value: Any) -> None:
    _GLOBAL_STATE.store(key, value)


def get_task_state(key: str, default=None):
    return _GLOBAL_STATE.get(key, default)


class LocalUploader:
    """Artifacts stay on local disk under `base_dir`; `upload` returns a
    file:// URL."""

    def __init__(self, base_dir: str = "output_images"):
        os.makedirs(base_dir, exist_ok=True)

    def upload(self, path: str, minutes: int = 10) -> str:
        return "file://" + os.path.abspath(path)

