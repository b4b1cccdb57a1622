"""Progress reporting and artifact publishing.

Counterpart of `clip_diffusion_tpu.utils.progress`: the task-state keys
(`new_prompt`, `current_batch`, `current_step`, `current_result`,
`current_iteration`) in a thread-safe store that a serving layer polls,
and the artifact uploaders.  `LocalUploader` keeps artifacts on disk and
returns file:// URLs, or `<url_base>/files/<relpath>` URLs that
`runtime/server.py` serves.  The Firebase and Imgur uploaders import their
SDKs only when built and are chosen by `default_uploader` when their
environment variables (`FIREBASE_CREDENTIAL_PATH` with
`FIREBASE_STORAGE_URL`, `IMGUR_CLIENT_ID`) are set.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional


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

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return dict(self._state)


_GLOBAL_STATE = TaskState()


def store_task_state(key: str, value: Any) -> None:
    _GLOBAL_STATE.store(key, value)


def get_task_state(key: str, default=None):
    return _GLOBAL_STATE.get(key, default)


class Uploader:
    """Artifact publishing hook: `upload(path, minutes)` -> a URL valid for
    at least `minutes`."""

    def upload(self, path: str, minutes: int = 10) -> str:  # pragma: no cover
        raise NotImplementedError


class LocalUploader(Uploader):
    """Artifacts stay on local disk under `base_dir`.  `upload` returns a
    file:// URL, or, with `url_base` (the HTTP server passes its own
    http://host:port), `<url_base>/files/<relpath>` for paths under
    `base_dir`, which the server's /files/ endpoint serves."""

    def __init__(self, base_dir: str = "output_images", url_base: Optional[str] = None):
        self.base_dir = base_dir
        self.url_base = url_base
        os.makedirs(base_dir, exist_ok=True)

    def upload(self, path: str, minutes: int = 10) -> str:
        abspath = os.path.abspath(path)
        if self.url_base:
            root = os.path.abspath(self.base_dir)
            if abspath.startswith(root + os.sep):
                rel = os.path.relpath(abspath, root).replace(os.sep, "/")
                return f"{self.url_base.rstrip('/')}/files/{rel}"
        return "file://" + abspath


class FirebaseUploader(Uploader):
    """Firebase Storage with signed URLs.  Needs `firebase_admin` and
    `FIREBASE_CREDENTIAL_PATH`, `FIREBASE_STORAGE_URL`."""

    def __init__(self):
        import datetime

        import firebase_admin
        from firebase_admin import credentials, storage

        if not firebase_admin._apps:
            cred = credentials.Certificate(os.environ["FIREBASE_CREDENTIAL_PATH"])
            firebase_admin.initialize_app(
                cred, {"storageBucket": os.environ["FIREBASE_STORAGE_URL"]})
        self._storage = storage
        self._dt = datetime

    def upload(self, path: str, minutes: int = 10) -> str:
        blob = self._storage.bucket().blob(os.path.basename(path))
        blob.upload_from_filename(path)
        return blob.generate_signed_url(expiration=self._dt.timedelta(minutes=minutes))


class ImgurUploader(Uploader):
    """Imgur anonymous upload.  Needs `pyimgur` and `IMGUR_CLIENT_ID`."""

    def __init__(self):
        import pyimgur

        self._client = pyimgur.Imgur(os.environ["IMGUR_CLIENT_ID"])

    def upload(self, path: str, minutes: int = 10) -> str:
        return self._client.upload_image(path, title=None).link


def default_uploader(base_dir: str = "output_images") -> Uploader:
    """Firebase when configured, else Imgur when configured, else local: a
    cloud uploader whose SDK is missing or fails to start falls through to
    the next."""
    if os.environ.get("FIREBASE_CREDENTIAL_PATH") and os.environ.get("FIREBASE_STORAGE_URL"):
        try:
            return FirebaseUploader()
        except Exception:  # noqa: BLE001 - missing SDK, bad credentials: next choice
            pass
    if os.environ.get("IMGUR_CLIENT_ID"):
        try:
            return ImgurUploader()
        except Exception:  # noqa: BLE001
            pass
    return LocalUploader(base_dir)

