"""HTTP serving layer: the JSON API of `clip_diffusion_tpu.runtime.server`.

    POST /guided_sample     kwargs of sample.guided_diffusion_sample; an
                            optional "model_type" picks a registered
                            finetuned UNet (通用/景觀/建築)
    POST /latent_sample     kwargs of sample.latent_diffusion_sample
    GET  /model_types       registered model-type names
    GET  /task_state        the progress keys, plus busy/error/result
    GET  /seed              -> {"seed": "<uint32 as string>"}
    POST /change_settings   Config fields -> applied to later requests
    GET  /random_prompt
    GET  /chosen_image?choice=N   PNG bytes of a latent output
    GET  /files/<relpath>   artifact bytes under the output directory
                            (progress PNGs, final images, GIFs): jobs
                            launched here publish their URLs through a
                            LocalUploader pointing at this endpoint
    POST /analyze_image     {"image_b64": ...} -> top-3 styles and media

Status codes as in the JAX package: 409 when a job is already running, 400
for an unknown model_type, 500 when a registered model_type fails to load,
403 for a /files/ path outside the output directory, 404 for an unknown
endpoint or file, 503 for /analyze_image without an analyzer.

Jobs run one at a time on a background worker thread, on the server's
device, which the server passes to every job (a client cannot move a job
elsewhere).  PyTorch's grad mode is per thread: the worker starts with
grad enabled, which the guided job's guidance gradient needs, and
/analyze_image runs under `torch.inference_mode` on its handler thread.
"""

from __future__ import annotations

import base64
import functools
import io
import json
import os
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote, urlparse

import torch
from PIL import Image

from clip_diffusion_tpu_torch import sample as sample_mod
from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.parallel import serving
from clip_diffusion_tpu_torch.runtime.registry import UNetRegistry, UnknownModelType
from clip_diffusion_tpu_torch.utils.device import resolve_device
from clip_diffusion_tpu_torch.utils.image_io import image_to_array
from clip_diffusion_tpu_torch.utils.progress import (
    _GLOBAL_STATE,
    LocalUploader,
    store_task_state,
)


class _Worker:
    """One background job slot."""

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self.result = None
        self.error = None

    def launch(self, fn, kwargs) -> bool:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self.result = None
            self.error = None
            # reset the progress keys before the thread starts: a client
            # polling right after the POST must not see the previous job's
            store_task_state("current_result", None)
            store_task_state("current_step", None)

            def run():
                try:
                    self.result = fn(**kwargs)
                except Exception:  # noqa: BLE001 - reported through /task_state
                    self.error = traceback.format_exc()

            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
            return True

    @property
    def busy(self) -> bool:
        return self._thread is not None and self._thread.is_alive()


_MIME = {".png": "image/png", ".gif": "image/gif", ".jpg": "image/jpeg",
         ".jpeg": "image/jpeg", ".json": "application/json"}


class ClipDiffusionServer:
    """The HTTP server over the sampling entry points.

    `models` (a `zoo.ZooModels`) sets the default guided job, the analyzer
    (`serving.make_analyzer`) and the device; else `device` (default
    `cuda`).  `registry` defaults to a `UNetRegistry` for the zoo's UNet
    (else for the default one on that device) that discovers the port's
    weights root."""

    def __init__(self, host="127.0.0.1", port=8080, config: Optional[Config] = None,
                 guided_fn=None, latent_fn=None, analyzer=None, models=None,
                 registry=None, output_dir: str = "output_images", device=None):
        self.config = config or Config()
        if device is None and models is not None:
            device = next(models.unet.parameters()).device
        self.device = resolve_device(device)
        # the artifacts root that GET /files/ serves and jobs write into
        self.files_root = os.path.abspath(output_dir)
        self.models = models
        if guided_fn is None and models is not None:
            guided_fn = functools.partial(sample_mod.guided_diffusion_sample, models=models)
        self.guided_fn = guided_fn or sample_mod.guided_diffusion_sample
        self.latent_fn = latent_fn or sample_mod.latent_diffusion_sample
        if analyzer is None and models is not None:
            analyzer = serving.make_analyzer(models)
        self.analyzer = analyzer
        if registry is None:
            registry = (UNetRegistry(models.unet) if models is not None
                        else UNetRegistry(device=self.device)).discover()
        self.registry = registry
        self.worker = _Worker()
        self._serving = False
        self.httpd = ThreadingHTTPServer((host, port), _handler(self))
        # built after bind, so that port 0 has resolved
        self.uploader = LocalUploader(self.files_root, url_base=f"http://{host}:{self.port}")

    def _job_kwargs(self, kwargs: dict) -> dict:
        """A job's kwargs: artifacts into the served root as /files/ URLs
        (the client may choose otherwise), on the server's device (it may
        not)."""
        return {"uploader": self.uploader, "output_dir": self.files_root, **kwargs,
                "device": self.device}

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def serve_forever(self):
        self._serving = True
        self.httpd.serve_forever()

    def start_background(self):
        self._serving = True
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        """Stop serving (when it was) and close the socket."""
        if self._serving:
            self.httpd.shutdown()
        self.httpd.server_close()


def _handler(server: ClipDiffusionServer):
    """The request handler class bound to `server`."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _json(self, code, obj):
            self._bytes(code, "application/json", json.dumps(obj).encode())

        def _bytes(self, code, content_type, data):
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _body(self):
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n) or b"{}")

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/seed":
                self._json(200, {"seed": serving.get_seed()})
            elif url.path == "/task_state":
                state = _GLOBAL_STATE.snapshot()
                state["busy"] = server.worker.busy
                state["error"] = server.worker.error
                state["result"] = server.worker.result
                self._json(200, state)
            elif url.path == "/model_types":
                self._json(200, {"model_types": server.registry.names()})
            elif url.path == "/random_prompt":
                ptype = parse_qs(url.query).get("type", ["景觀"])[0]
                self._json(200, {"prompt": serving.get_random_prompt(ptype)})
            elif url.path == "/chosen_image":
                choice = int(parse_qs(url.query).get("choice", ["0"])[0])
                try:
                    data = serving.get_chosen_image(choice, server.files_root)
                except FileNotFoundError:
                    self._json(404, {"error": "no such image"})
                    return
                self._bytes(200, "image/png", data)
            elif url.path.startswith("/files/"):
                self._serve_file(url.path[len("/files/"):])
            else:
                self._json(404, {"error": "unknown endpoint"})

        def _serve_file(self, relpath):
            """Artifact bytes under `server.files_root`; the resolved path
            must stay under it (no ../ escapes, no symlinks out)."""
            root = os.path.realpath(server.files_root)
            full = os.path.realpath(os.path.join(root, unquote(relpath)))
            if full != root and not full.startswith(root + os.sep):
                self._json(403, {"error": "path outside artifact root"})
                return
            if not os.path.isfile(full):
                self._json(404, {"error": "no such file"})
                return
            with open(full, "rb") as f:
                data = f.read()
            ext = os.path.splitext(full)[1].lower()
            self._bytes(200, _MIME.get(ext, "application/octet-stream"), data)

        def _launch(self, fn, kwargs):
            ok = server.worker.launch(fn, server._job_kwargs(kwargs))
            self._json(200 if ok else 409, {"started": ok} if ok else {"error": "busy"})

        def do_POST(self):
            url = urlparse(self.path)
            if url.path == "/guided_sample":
                kwargs = self._body()
                model_type = kwargs.pop("model_type", None)
                if model_type is not None:
                    try:
                        custom = server.registry.load(model_type)
                    except UnknownModelType as e:
                        self._json(400, {"error": str(e)})
                        return
                    except Exception as e:  # noqa: BLE001 - a broken server asset
                        self._json(500, {"error": f"model_type {model_type!r} failed to load: "
                                                  f"{e}"})
                        return
                    if custom is not None:
                        kwargs["custom_model_params"] = custom
                self._launch(server.guided_fn, {**kwargs, "config": server.config})
            elif url.path == "/latent_sample":
                self._launch(server.latent_fn, self._body())
            elif url.path == "/change_settings":
                server.config = serving.change_settings(server.config, **self._body())
                self._json(200, {"ok": True})
            elif url.path == "/analyze_image":
                if server.analyzer is None:
                    self._json(503, {"error": "analyzer not configured"})
                    return
                raw = base64.b64decode(self._body()["image_b64"])
                img = image_to_array(Image.open(io.BytesIO(raw)))
                with torch.inference_mode():
                    self._json(200, server.analyzer(img))
            else:
                self._json(404, {"error": "unknown endpoint"})

    return Handler
