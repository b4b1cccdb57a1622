"""The port's HTTP server, its UNet registry, the uploaders and the
bootstrap, held to the behaviour tests/test_server.py and
tests/test_registry.py check in the JAX package: the same endpoints and
status codes (compared with the JAX server on the same requests), the
/files/ traversal guard, the live progress URL, the registry's cache,
aliases, discovery and strict load, 400/500 for model_type errors, and a
model_type that changes the images.  Everything runs on the CPU
(`device="cpu"`) at tiny sizes.
"""

import base64
import http.client
import io
import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from clip_diffusion_tpu.runtime.server import ClipDiffusionServer as JaxServer
from clip_diffusion_tpu_torch import config as tconfig
from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip.model import CLIP_PRESETS, CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.convert import release_unet_state_dict
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.runtime import bootstrap
from clip_diffusion_tpu_torch.runtime.registry import UNetRegistry, UnknownModelType
from clip_diffusion_tpu_torch.runtime.server import ClipDiffusionServer
from clip_diffusion_tpu_torch.utils import progress

TOWER = "tinysv"
CLIP_PRESETS.setdefault(TOWER, tiny_clip_config(TOWER))
UCFG = UNetConfig.tiny(64)


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(1)


def _get(srv, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}{path}") as r:
        if r.headers.get("Content-Type") == "application/json":
            return json.loads(r.read())
        return r.read()


def _post(srv, path, obj):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(obj).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait(srv, timeout=120.0):
    t0 = time.time()
    while srv.worker.busy and time.time() - t0 < timeout:
        time.sleep(0.02)
    assert not srv.worker.busy, "job did not finish"


def _png_b64():
    buf = io.BytesIO()
    Image.new("RGB", (16, 16), (255, 0, 0)).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture()
def server(tmp_path):
    calls = {}

    def fake_guided(**kwargs):
        calls["guided"] = dict(kwargs, grad_enabled=torch.is_grad_enabled())
        time.sleep(0.2)
        return {"images": ["a.png"], "gif_urls": ["file://x"], "seed": 1}

    def fake_latent(**kwargs):
        calls["latent"] = kwargs
        return {"grid_url": "file://g", "images": [], "seed": 2}

    def fake_analyzer(img):
        calls["analyzer"] = (img.shape, torch.is_inference_mode_enabled())
        return {"styles": [[90.0, "oil"]], "media": [[80.0, "painting"]]}

    srv = ClipDiffusionServer(port=0, guided_fn=fake_guided, latent_fn=fake_latent,
                              analyzer=fake_analyzer, output_dir=str(tmp_path / "out"),
                              registry=UNetRegistry(device="cpu"), device="cpu")
    srv.start_background()
    srv._calls = calls
    yield srv
    srv.shutdown()


def test_seed_endpoint(server):
    assert 0 <= int(_get(server, "/seed")["seed"]) < 2**32


def test_random_prompt(server):
    assert len(_get(server, "/random_prompt")["prompt"]) > 5


def test_guided_launch_and_busy(server):
    """200 then 409 while busy; the job gets the client's kwargs, the
    server's config, artifacts and device (a client "device" is overridden),
    and runs with grad enabled on the worker thread."""
    code, out = _post(server, "/guided_sample", {"prompt": "a cat", "steps": 5, "device": "meta"})
    assert code == 200 and out["started"]
    code2, _ = _post(server, "/guided_sample", {"prompt": "x"})
    assert code2 == 409
    _wait(server)
    state = _get(server, "/task_state")
    assert not state["busy"] and state["result"]["seed"] == 1 and state["error"] is None
    call = server._calls["guided"]
    assert call["prompt"] == "a cat" and call["steps"] == 5
    assert call["device"] == torch.device("cpu") and call["config"] is server.config
    assert call["uploader"] is server.uploader and call["output_dir"] == server.files_root
    assert call["grad_enabled"] is True


def test_latent_launch_on_the_server_device(server):
    code, out = _post(server, "/latent_sample", {"prompt": "a dog"})
    assert code == 200 and out["started"]
    _wait(server)
    assert server._calls["latent"]["device"] == torch.device("cpu")
    assert _get(server, "/task_state")["result"]["seed"] == 2


def test_change_settings(server):
    code, _ = _post(server, "/change_settings", {"clip_guidance_scale": 5})
    assert code == 200 and server.config.clip_guidance_scale == 5


def test_analyze_image_under_inference_mode(server):
    code, out = _post(server, "/analyze_image", {"image_b64": _png_b64()})
    assert code == 200 and out["styles"][0][1] == "oil"
    assert server._calls["analyzer"] == ((16, 16, 3), True)


def test_unknown_endpoint(server):
    code, _ = _post(server, "/nope", {})
    assert code == 404
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(server, "/nope")
    assert e.value.code == 404


def test_job_error_is_reported(tmp_path):
    def broken(**kwargs):
        raise ValueError("boom")

    srv = ClipDiffusionServer(port=0, guided_fn=broken, registry=UNetRegistry(device="cpu"),
                              output_dir=str(tmp_path), device="cpu")
    srv.start_background()
    try:
        assert _post(srv, "/guided_sample", {"prompt": "x"})[0] == 200
        _wait(srv)
        state = _get(srv, "/task_state")
        assert "ValueError: boom" in state["error"] and state["result"] is None
    finally:
        srv.shutdown()


def test_same_status_codes_as_the_jax_server(tmp_path):
    """The same requests to both servers (same fakes, no analyzer, an empty
    registry) answer the same codes and JSON keys."""
    fake = lambda **kw: {"seed": 3}
    kwargs = dict(port=0, guided_fn=fake, latent_fn=fake, output_dir=str(tmp_path))
    (tmp_path / "p.png").write_bytes(b"png")
    ours = ClipDiffusionServer(registry=UNetRegistry(device="cpu"), device="cpu", **kwargs)
    jax = JaxServer(**kwargs)
    requests = [("POST", "/guided_sample", {"prompt": "x", "model_type": "nope"}),
                ("POST", "/guided_sample", {"prompt": "x", "model_type": "通用"}),
                ("POST", "/latent_sample", {}), ("POST", "/analyze_image", {"image_b64": ""}),
                ("POST", "/change_settings", {"clip_guidance_scale": 3}), ("POST", "/nope", {}),
                ("GET", "/seed", None), ("GET", "/model_types", None),
                ("GET", "/chosen_image?choice=7", None), ("GET", "/files/p.png", None),
                ("GET", "/files/../x", None), ("GET", "/files/absent.png", None),
                ("GET", "/nope", None)]
    answers = {}
    for srv in (ours, jax):
        srv.start_background()
        try:
            for i, (method, path, body) in enumerate(requests):
                conn = http.client.HTTPConnection("127.0.0.1", srv.port)
                conn.request(method, path, json.dumps(body).encode() if body is not None else None)
                r = conn.getresponse()
                data = r.read()
                keys = sorted(json.loads(data)) if r.getheader("Content-Type") == \
                    "application/json" else data
                answers.setdefault((i, method, path), []).append((r.status, keys))
                conn.close()
                _wait(srv)
        finally:
            srv.shutdown()
    for key, (a, b) in answers.items():
        assert a == b, key
    assert [a[0] for a, _ in answers.values()] == [400, 200, 200, 503, 200, 404, 200, 200, 404,
                                                   200, 403, 404, 404]


def test_files_endpoint_serves_and_blocks_traversal(tmp_path):
    (tmp_path / "guided").mkdir()
    payload = b"\x89PNG fake png bytes"
    (tmp_path / "guided" / "p.png").write_bytes(payload)
    (tmp_path.parent / "secret.txt").write_text("outside")
    srv = ClipDiffusionServer(port=0, guided_fn=lambda **k: None, latent_fn=lambda **k: None,
                              output_dir=str(tmp_path), registry=UNetRegistry(device="cpu"),
                              device="cpu")
    srv.start_background()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port)
        conn.request("GET", "/files/guided/p.png")
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("Content-Type") == "image/png"
        assert r.read() == payload
        url = srv.uploader.upload(str(tmp_path / "guided" / "p.png"))
        assert url == f"http://127.0.0.1:{srv.port}/files/guided/p.png"
        with urllib.request.urlopen(url) as resp:
            assert resp.read() == payload
        for evil in ("/files/../secret.txt", "/files/%2e%2e/secret.txt", "/files//etc/hostname"):
            conn.request("GET", evil)
            r = conn.getresponse()
            assert r.status in (403, 404), evil
            r.read()
    finally:
        srv.shutdown()


# --------------------------------------------------------------------------
# real tiny guided runs
# --------------------------------------------------------------------------

def tiny_config():
    return tconfig.Config(
        width=64, height=64, num_cutout_batches=1, guidance_dtype="float32",
        clip_guidance_scale=1000.0, denoise_scale=100.0, range_scale=10.0,
        LPIPS_scale=0.0, MS_SSIM_scale=0.0, chosen_clip_models=(TOWER,),
        cutout_schedules=tconfig.CutoutSchedules(
            num_overview_cuts=tconfig.create_schedule((2,), (1000,)),
            num_inner_cuts=tconfig.create_schedule((2,), (1000,)),
            inner_cut_size_power=tconfig.create_schedule((5,), (1000,)),
            cut_gray_portion=tconfig.create_schedule((0.5,), (1000,)),
        ),
    )


def _tiny_zoo():
    unet = UNetModel(UCFG)
    unet.load_state_dict(zoo.host_init_state_dict(unet, from_jax.unet_rule, 9, torch.float32))
    clip = CLIPModel(CLIP_PRESETS[TOWER])
    clip.load_state_dict(zoo.host_init_state_dict(clip, from_jax.clip_rule, 7, torch.float32))
    return zoo.ZooModels(unet.requires_grad_(False), {TOWER: clip.requires_grad_(False)})


def _save_finetune(path, seed):
    """A tiny UNet release file, every weight perturbed by `seed`."""
    unet = UNetModel(UCFG)
    sd = zoo.host_init_state_dict(unet, from_jax.unet_rule, 9, torch.float32)
    g = torch.Generator().manual_seed(seed)
    sd = {k: v + 0.02 * torch.randn(v.shape, generator=g) for k, v in sd.items()}
    torch.save(release_unet_state_dict(sd), path)
    return sd


def test_live_progress_image_fetchable_over_http(tmp_path):
    """A real tiny guided run through the server: /task_state's
    current_result is an http URL under /files/ that returns PNG bytes, and
    the final GIFs are fetchable the same way."""
    srv = ClipDiffusionServer(port=0, config=tiny_config(), models=_tiny_zoo(),
                              registry=UNetRegistry(device="cpu"), output_dir=str(tmp_path))
    assert srv.device == torch.device("cpu") and srv.analyzer is None  # no tiny banks
    srv.start_background()
    try:
        code, out = _post(srv, "/guided_sample", {"prompt": "a test", "steps": 5, "seed": 3})
        assert code == 200 and out["started"]
        progress_url = None
        for _ in range(2400):
            state = _get(srv, "/task_state")
            progress_url = progress_url or state.get("current_result")
            if not state["busy"]:
                break
            time.sleep(0.05)
        assert not state["busy"] and state["error"] is None, state["error"]
        assert progress_url.startswith(f"http://127.0.0.1:{srv.port}/files/")
        with urllib.request.urlopen(progress_url) as r:
            assert r.read()[:8] == b"\x89PNG\r\n\x1a\n"
        for gif_url in state["result"]["gif_urls"]:
            with urllib.request.urlopen(gif_url) as r:
                assert r.read()[:6] in (b"GIF87a", b"GIF89a")
    finally:
        srv.shutdown()


@pytest.fixture()
def two_finetunes(tmp_path):
    root = tmp_path / "weights"
    root.mkdir()
    p1, p2 = root / "guided_unet_custom_landscape.pt", root / "guided_unet_custom_building.pt"
    return str(root), (str(p1), _save_finetune(p1, 1)), (str(p2), _save_finetune(p2, 2))


def _registry(**kw):
    return UNetRegistry(UNetModel(UCFG), **kw)


def test_registry_load_cache_and_aliases(two_finetunes):
    _, (p1, sd1), (p2, _) = two_finetunes
    reg = _registry()
    reg.register("landscape", p1)
    reg.register("building", p2)
    got = reg.load("landscape")
    for k, v in sd1.items():
        assert torch.equal(got[k], v) and got[k].device.type == "cpu"
    assert reg.load("landscape") is got
    other = reg.load("building")
    assert any(not torch.equal(got[k], other[k]) for k in got)
    for name in ("通用", "default", "general", None):
        assert reg.load(name) is None
    with pytest.raises(UnknownModelType):
        reg.load("nonexistent")
    with pytest.raises(FileNotFoundError):
        reg.register("x", p1 + ".absent")


def test_registry_discover_and_reference_aliases(two_finetunes, monkeypatch):
    root, _, _ = two_finetunes
    reg = _registry().discover(root)
    names = reg.names()
    assert {"landscape", "building", "景觀", "建築", "通用"} <= set(names)
    assert reg.load("景觀") is reg.load("landscape")
    assert reg.load("建築") is reg.load("building")
    monkeypatch.setenv(zoo.TORCH_ROOT_ENV, root)  # the zoo's root by default
    assert "landscape" in _registry().discover().names()


def test_registry_rejects_mismatched_checkpoint(tmp_path):
    import dataclasses

    _save_finetune(tmp_path / "bad.pt", 3)
    reg = UNetRegistry(UNetModel(dataclasses.replace(UCFG, model_channels=64)))
    reg.register("bad", str(tmp_path / "bad.pt"))
    with pytest.raises(RuntimeError, match="does not match"):
        reg.load("bad")


def test_server_registry_follows_the_zoo_unet(two_finetunes, monkeypatch, tmp_path):
    """With no registry given, the server's registry holds finetunes to the
    zoo's UNet (its config, dtype and device) and discovers the zoo's
    weights root; a registry takes its device from the UNet it is given."""
    root, (_, sd1), _ = two_finetunes
    monkeypatch.setenv(zoo.TORCH_ROOT_ENV, root)
    models = _tiny_zoo()
    srv = ClipDiffusionServer(port=0, guided_fn=lambda **kw: {}, models=models,
                              output_dir=str(tmp_path))
    try:
        got = srv.registry.load("景觀")
        for k, v in sd1.items():
            assert torch.equal(got[k], v) and got[k].dtype == torch.float32
        models.unet.to(torch.bfloat16)
        with pytest.raises(ValueError, match="dtype"):
            zoo.with_unet_state_dict(models, got)
    finally:
        srv.shutdown()
    with pytest.raises(ValueError, match="device"):
        UNetRegistry(UNetModel(UCFG), device="cpu")


def test_registry_concurrent_first_load_loads_once(two_finetunes, monkeypatch):
    _, (p1, _), _ = two_finetunes
    reg = _registry()
    reg.register("landscape", p1)
    calls = []
    real = UNetRegistry._load_checkpoint

    def slow(self, path):
        calls.append(path)
        time.sleep(0.2)
        return real(self, path)

    monkeypatch.setattr(UNetRegistry, "_load_checkpoint", slow)
    results = [None] * 6
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, reg.load("landscape")))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(calls) == 1 and all(r is results[0] for r in results)


def test_server_model_type_selection(two_finetunes):
    root, _, _ = two_finetunes
    calls = []

    def fake_guided(**kwargs):
        calls.append(kwargs)
        return {"seed": len(calls)}

    srv = ClipDiffusionServer(port=0, guided_fn=fake_guided, registry=_registry().discover(root),
                              device="cpu")
    srv.start_background()
    try:
        assert {"landscape", "building", "通用", "景觀"} <= set(_get(srv, "/model_types")["model_types"])
        for body in ({"prompt": "a", "model_type": "landscape"},
                     {"prompt": "b", "model_type": "building"},
                     {"prompt": "c", "model_type": "通用"}, {"prompt": "d"}):
            assert _post(srv, "/guided_sample", body)[0] == 200
            _wait(srv)
        code, out = _post(srv, "/guided_sample", {"prompt": "e", "model_type": "nope"})
        assert code == 400 and "unknown model_type" in out["error"]
        la, lb = calls[0]["custom_model_params"], calls[1]["custom_model_params"]
        assert any(not torch.equal(la[k], lb[k]) for k in la)
        assert "custom_model_params" not in calls[2] and "custom_model_params" not in calls[3]
        assert all("model_type" not in c for c in calls)
    finally:
        srv.shutdown()


def test_server_answers_500_on_corrupt_checkpoint(tmp_path):
    (tmp_path / "broken.pt").write_bytes(b"not a checkpoint")
    reg = _registry()
    reg.register("broken", str(tmp_path / "broken.pt"))
    srv = ClipDiffusionServer(port=0, guided_fn=lambda **kw: {}, registry=reg, device="cpu")
    srv.start_background()
    try:
        code, out = _post(srv, "/guided_sample", {"prompt": "x", "model_type": "broken"})
        assert code == 500 and "failed to load" in out["error"]
        assert "broken" in _get(srv, "/model_types")["model_types"]  # still serving
    finally:
        srv.shutdown()


def test_server_500_on_internal_keyerror_not_400(two_finetunes, monkeypatch):
    _, (p1, _), _ = two_finetunes
    reg = _registry()
    reg.register("landscape", p1)

    def broken_load(self, path):
        raise KeyError("missing tensor input_blocks.3.0.in_layers.0.weight")

    monkeypatch.setattr(UNetRegistry, "_load_checkpoint", broken_load)
    srv = ClipDiffusionServer(port=0, guided_fn=lambda **kw: {}, registry=reg, device="cpu")
    srv.start_background()
    try:
        code, out = _post(srv, "/guided_sample", {"prompt": "x", "model_type": "landscape"})
        assert code == 500 and "failed to load" in out["error"]
        code, out = _post(srv, "/guided_sample", {"prompt": "x", "model_type": "nope"})
        assert code == 400 and "unknown model_type" in out["error"]
    finally:
        srv.shutdown()


def test_server_model_type_changes_images(two_finetunes, tmp_path):
    """Two registered finetunes give different images through the real
    guided path, and the shared zoo's UNet is left as it was."""
    root, _, _ = two_finetunes
    models = _tiny_zoo()
    before = {k: v.clone() for k, v in models.unet.state_dict().items()}
    srv = ClipDiffusionServer(port=0, config=tiny_config(), models=models,
                              registry=_registry().discover(root),
                              output_dir=str(tmp_path / "out"))
    srv.start_background()
    try:
        imgs = {}
        for mt in ("landscape", "building", "通用"):
            code, _ = _post(srv, "/guided_sample",
                            {"prompt": "a test prompt", "model_type": mt, "steps": 3, "seed": 11})
            assert code == 200
            _wait(srv)
            assert srv.worker.error is None, srv.worker.error
            imgs[mt] = np.asarray(Image.open(srv.worker.result["images"][0]))
        assert not np.array_equal(imgs["landscape"], imgs["building"])
        assert not np.array_equal(imgs["landscape"], imgs["通用"])
        for k, v in models.unet.state_dict().items():
            assert torch.equal(v, before[k]), k
    finally:
        srv.shutdown()


# --------------------------------------------------------------------------
# uploaders, utils, bootstrap
# --------------------------------------------------------------------------

_CLOUD_ENV = ("FIREBASE_CREDENTIAL_PATH", "FIREBASE_STORAGE_URL", "IMGUR_CLIENT_ID")


def test_default_uploader_local_without_environment(tmp_path, monkeypatch):
    for k in _CLOUD_ENV:
        monkeypatch.delenv(k, raising=False)
    up = progress.default_uploader(str(tmp_path / "up"))
    assert type(up) is progress.LocalUploader and os.path.isdir(tmp_path / "up")
    assert up.upload(str(tmp_path / "a.png")) == "file://" + str(tmp_path / "a.png")
    assert isinstance(up, progress.Uploader)


def test_default_uploader_picks_firebase_then_imgur(tmp_path, monkeypatch):
    seen = []

    class Blob:
        def __init__(self, name):
            self.name = name

        def upload_from_filename(self, path):
            seen.append(("firebase", path))

        def generate_signed_url(self, expiration):
            return f"https://storage.test/{self.name}?ttl={int(expiration.total_seconds())}"

    firebase = types.ModuleType("firebase_admin")
    firebase._apps = []
    firebase.initialize_app = lambda cred, opts: firebase._apps.append((cred, opts))
    firebase.credentials = types.SimpleNamespace(Certificate=lambda path: ("cert", path))
    firebase.storage = types.SimpleNamespace(
        bucket=lambda: types.SimpleNamespace(blob=Blob))
    monkeypatch.setitem(sys.modules, "firebase_admin", firebase)
    monkeypatch.setitem(sys.modules, "firebase_admin.credentials", firebase.credentials)
    monkeypatch.setitem(sys.modules, "firebase_admin.storage", firebase.storage)
    pyimgur = types.ModuleType("pyimgur")
    pyimgur.Imgur = lambda cid: types.SimpleNamespace(
        upload_image=lambda path, title=None: types.SimpleNamespace(
            link=f"https://imgur.test/{cid}/{os.path.basename(path)}"))
    monkeypatch.setitem(sys.modules, "pyimgur", pyimgur)

    monkeypatch.setenv("FIREBASE_CREDENTIAL_PATH", "/cred.json")
    monkeypatch.setenv("FIREBASE_STORAGE_URL", "bucket.test")
    monkeypatch.setenv("IMGUR_CLIENT_ID", "cid")
    up = progress.default_uploader(str(tmp_path))
    assert isinstance(up, progress.FirebaseUploader)
    assert up.upload("/x/p.png", minutes=3) == "https://storage.test/p.png?ttl=180"
    assert seen == [("firebase", "/x/p.png")]
    assert firebase._apps == [(("cert", "/cred.json"), {"storageBucket": "bucket.test"})]

    monkeypatch.delenv("FIREBASE_STORAGE_URL")
    up = progress.default_uploader(str(tmp_path))
    assert isinstance(up, progress.ImgurUploader)
    assert up.upload("/x/p.png") == "https://imgur.test/cid/p.png"

    monkeypatch.setitem(sys.modules, "pyimgur", None)  # the SDK is missing: local
    assert type(progress.default_uploader(str(tmp_path))) is progress.LocalUploader


def test_local_uploader_url_base_and_task_state_snapshot(tmp_path):
    up = progress.LocalUploader(str(tmp_path), url_base="http://h:1/")
    assert up.upload(str(tmp_path / "g" / "a.png")) == "http://h:1/files/g/a.png"
    assert up.upload("/elsewhere/a.png") == "file:///elsewhere/a.png"
    state = progress.TaskState()
    state.store("k", 1)
    snap = state.snapshot()
    snap["k"] = 2
    assert state.get("k") == 1


def test_dirs_and_image_to_array(tmp_path):
    from clip_diffusion_tpu_torch.utils.dirs import list_images, make_dir
    from clip_diffusion_tpu_torch.utils.image_io import image_to_array

    d = make_dir(str(tmp_path / "d"))
    for name in ("b.png", "a.png", "c.jpg"):
        Image.new("RGB", (2, 3), (255, 0, 0)).save(os.path.join(d, name))
    assert [os.path.basename(p) for p in list_images(d)] == ["a.png", "b.png"]
    assert [os.path.basename(p) for p in list_images(d, "jpg")] == ["c.jpg"]
    assert make_dir(d, remove_old=True) == d and os.listdir(d) == []
    arr = image_to_array(Image.new("RGBA", (2, 3), (255, 0, 0, 10)))
    assert arr.shape == (3, 2, 3) and arr.dtype == np.float32
    assert np.array_equal(arr[0, 0], [1.0, 0.0, 0.0])


def test_build_service_tiny_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    srv = bootstrap.build_service(tiny=True, port=0, device="cpu", with_latent=True)
    try:
        assert srv.device == torch.device("cpu") and srv.analyzer is None
        assert srv.config.chosen_clip_models == ()
        assert srv.latent_fn.keywords["pipe"] is not None
        assert srv.models is None and srv.guided_fn is tsample.guided_diffusion_sample
        assert srv.registry.names() == ["default", "general", "通用"]
    finally:
        srv.shutdown()


def test_build_service_defaults_to_cuda(monkeypatch):
    """No device and no GPU: the service refuses rather than serve from the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap.build_service(tiny=True, port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ClipDiffusionServer(port=0, guided_fn=lambda **kw: {}, registry=UNetRegistry(device="cpu"))
