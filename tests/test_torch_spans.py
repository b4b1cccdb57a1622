"""The port's span recorder (`utils.profiling.annotate`) on the CPU: off
outside a profile, spans with their nesting, request and thread under a
CPU `torch.profiler`, the bounded buffer and the per-name totals, and the
spans of a tiny guided trajectory and a tiny latent request.  Imports
neither JAX nor the JAX package."""

import functools
import sys
import threading
import time
from collections import Counter

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from clip_diffusion_tpu_torch import config as tconfig
from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.models.esrgan import upscale
from clip_diffusion_tpu_torch.models.unet import UNetConfig, UNetModel
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws, guided_sample
from clip_diffusion_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """A fresh recorder for each test, one thread of torch."""
    torch.set_num_threads(1)
    rec = profiling.Recorder()
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_annotate_off_is_the_shared_noop():
    first, second = profiling.annotate("a"), profiling.annotate("b")
    assert first is second
    with first:
        with second:
            torch.ones(2).sum()
    assert profiling.spans() == [] and profiling.dropped() == 0 and profiling.totals() == {}


def test_spans_nest_with_parent_request_and_thread():
    other = []

    def worker():
        with profiling.annotate("w"):
            other.append(threading.get_ident())

    with _cpu_profile() as prof:
        with profiling.annotate("root"):
            with profiling.annotate("mid"):
                with profiling.annotate("leaf"):
                    torch.ones(4).sum()
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=30)
            with profiling.annotate("mid"):
                pass
        with profiling.annotate("root"):
            pass
    assert not th.is_alive()
    got = profiling.spans()
    by = {}
    for s in got:
        by.setdefault(s.name, []).append(s)
    assert [s.name for s in got] == ["leaf", "mid", "w", "mid", "root", "root"]
    root1, root2 = by["root"]
    mid1, mid2 = by["mid"]
    (leaf,), (w,) = by["leaf"], by["w"]
    me = threading.get_ident()
    assert root1.parent is None and root1.request == root1.id
    assert root2.parent is None and root2.request == root2.id != root1.id
    assert mid1.parent == mid2.parent == root1.id and leaf.parent == mid1.id
    assert {mid1.request, mid2.request, leaf.request} == {root1.id}
    assert {s.thread for s in (root1, root2, mid1, mid2, leaf)} == {me}
    assert w.thread == other[0] != me and w.parent is None and w.request == w.id
    assert root1.start_ns <= mid1.start_ns <= leaf.start_ns <= leaf.end_ns <= mid1.end_ns
    assert mid1.end_ns <= mid2.start_ns <= mid2.end_ns <= root1.end_ns <= root2.start_ns
    names = {e.key for e in prof.key_averages()}
    assert {"root", "mid", "leaf"} <= names  # each span is also a record_function region


def test_span_buffer_is_bounded_and_counts_drops(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder(capacity=3))
    with _cpu_profile():
        for i in range(5):
            with profiling.annotate(f"s{i}"):
                pass
    assert [s.name for s in profiling.spans()] == ["s2", "s3", "s4"]
    assert profiling.dropped() == 2


@pytest.mark.parametrize("capacity", [1 << 16, 100])
def test_threads_record_without_losing_a_span_or_a_drop(monkeypatch, capacity):
    """More threads than cores, switching often: every span is kept or
    counted as dropped, and each thread's spans nest on its own stack."""
    monkeypatch.setattr(profiling, "_RECORDER", profiling.Recorder(capacity=capacity))
    n_threads, per_thread = 16, 200

    def work():
        for _ in range(per_thread):
            with profiling.annotate("outer"):
                with profiling.annotate("inner"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    got = profiling.spans()
    total = n_threads * per_thread * 2
    assert len(got) == min(total, capacity) and profiling.dropped() == total - len(got)
    outer = {s.id: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner" and s.parent in outer:
            assert outer[s.parent].thread == s.thread and s.request == s.parent


def test_totals_by_name():
    with _cpu_profile():
        for _ in range(2):
            with profiling.annotate("a"):
                time.sleep(0.01)
        with profiling.annotate("b"):
            pass
    totals = profiling.totals()
    assert set(totals) == {"a", "b"}
    assert totals["a"][0] == 2 and totals["b"][0] == 1
    assert totals["a"][1] >= 0.02
    spans = profiling.spans()
    assert totals["a"][1] == pytest.approx(
        sum(s.end_ns - s.start_ns for s in spans if s.name == "a") / 1e9)


# ---------------- the program's spans ----------------

def _tiny_guided(steps=4):
    """The tiny float32 UNet and two tiny ViT towers of one resolution (one
    cutout group), `steps` DDIM steps, histogram threshold."""
    unet = UNetModel(UNetConfig.tiny(64))
    unet.load_state_dict(zoo.host_init_state_dict(unet, from_jax.unet_rule, 1, torch.float32))
    clips = {}
    for i, name in enumerate(("tiny0", "tiny1")):
        clip = CLIPModel(tiny_clip_config(name))
        clip.load_state_dict(zoo.host_init_state_dict(clip, from_jax.clip_rule, 2 + i,
                                                      torch.float32))
        clips[name] = clip.requires_grad_(False)
    models = zoo.ZooModels(unet.requires_grad_(False), clips)
    config = tconfig.Config(
        width=64, height=64, num_cutout_batches=1, guidance_dtype="float32",
        chosen_clip_models=("tiny0", "tiny1"),
        cutout_schedules=tconfig.CutoutSchedules(
            num_overview_cuts=tconfig.create_schedule((2,), (1000,)),
            num_inner_cuts=tconfig.create_schedule((1,), (1000,)),
            inner_cut_size_power=tconfig.create_schedule((5,), (1000,)),
            cut_gray_portion=tconfig.create_schedule((0.5,), (1000,))))
    return zoo.build_pipeline(models, config, [("a prompt", 1.0)], SamplerConfig(steps=steps))


def test_guided_trajectory_spans():
    """Each span of the guided path at its nesting and count: one
    `guided.step` per position inside the one `guided.sample`, in each
    step one UNet, one cutouts per perceptor group, one tower per
    perceptor, one backward and one update, and `guided.progress` at the
    progress positions; tracing off records nothing."""
    pipe = _tiny_guided(steps=4)
    seen = []
    guided_sample(pipe, TorchDraws(3, "cpu"), progress_callback=lambda p, x: seen.append(p),
                  progress_every=2)
    assert profiling.spans() == [] and seen == [0, 2]
    with _cpu_profile():
        guided_sample(pipe, TorchDraws(3, "cpu"), progress_callback=lambda p, x: None,
                      progress_every=2)
    spans = profiling.spans()
    counts = Counter(s.name for s in spans)
    assert counts == {"guided.sample": 1, "guided.step": 4, "guided.unet": 4,
                      "guided.cutouts": 4, "guided.tower": 8, "guided.backward": 4,
                      "guided.update": 4, "guided.progress": 2}
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.name == "guided.sample"]
    parent_of = {"guided.step": "guided.sample", "guided.unet": "guided.step",
                 "guided.cutouts": "guided.step", "guided.tower": "guided.step",
                 "guided.backward": "guided.step", "guided.update": "guided.step",
                 "guided.progress": "guided.step"}
    for s in spans:
        assert s.request == root.id and s.thread == root.thread
        if s is not root:
            assert by_id[s.parent].name == parent_of[s.name], s.name
            outer = by_id[s.parent]
            assert outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    # within a step: the UNet, then cutouts and towers, then the backward, then the update
    first = min((s for s in spans if s.name == "guided.step"), key=lambda s: s.start_ns)
    order = [s.name for s in sorted(spans, key=lambda s: s.start_ns) if s.parent == first.id]
    assert order == ["guided.unet", "guided.cutouts", "guided.tower", "guided.tower",
                     "guided.backward", "guided.update", "guided.progress"]


@pytest.fixture(scope="module")
def tiny_latent():
    models = zoo.build_latent_models(tiny=True, param_dtype=torch.float32, device="cpu")
    pipe, text_encode = zoo.build_latent_pipeline(models)
    return pipe, text_encode, zoo.build_esrgan(tiny=True, device="cpu")


def test_latent_request_spans(tiny_latent, tmp_path):
    """One `latent.request` holding two `latent.text` (the prompt's and the
    empty prompt's encodings), one `latent.step` per CFG step, one
    `latent.decode` per iteration, a `latent.png` per iteration, one for
    the grid and one per upscale, and one `latent.upscale` per image."""
    pipe, text_encode, esrgan = tiny_latent
    with _cpu_profile():
        tsample.latent_diffusion_sample(
            prompt="spans", seed=5, diffusion_steps=3, num_iterations=2, num_batches=2,
            sample_width=32, sample_height=32, pipe=pipe, text_encode=text_encode,
            upscaler=functools.partial(upscale, esrgan), output_dir=str(tmp_path),
            device="cpu")
    spans = profiling.spans()
    assert Counter(s.name for s in spans) == {
        "latent.request": 1, "latent.text": 2, "latent.step": 6, "latent.decode": 2,
        "latent.png": 2 + 1 + 4, "latent.upscale": 4}
    by_id = {s.id: s for s in spans}
    (root,) = [s for s in spans if s.name == "latent.request"]
    for s in spans:
        assert s.request == root.id
        if s is not root:
            assert by_id[s.parent] is root, s.name
