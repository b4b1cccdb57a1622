"""Keyed draws and mid-trajectory resume in the port, on the CPU.

`TorchDraws` is a function of its key: the same draw whatever was drawn
before, row views equal to rows of the whole batch and rows that do not
depend on the batch drawn with them, `fold` for sub-batches.  On that rests `guided_diffusion_sample`'s sub-batches (each
its own draws) and resume through `SamplingState`: 2 + 3 steps equal 5
straight, bit for bit, in one process and in a new one, and the port's
resumed trajectory agrees with the JAX package's.
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from clip_diffusion_tpu.pipeline import guided as jg
from clip_diffusion_tpu.utils.checkpoint import SamplingState as JSamplingState
from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
from clip_diffusion_tpu_torch.guidance.cutouts import CutoutSpec
from clip_diffusion_tpu_torch.pipeline import guided as tg
from clip_diffusion_tpu_torch.pipeline.guided import TorchDraws
from clip_diffusion_tpu_torch.utils.checkpoint import SamplingState
from clip_diffusion_tpu_torch.utils.image_io import array_to_image
from test_torch_guided import JaxReplayDraws, tiny_port_config
from test_torch_parallel import jax_tiny_pipeline
from torch_ranks import AUG_FIELDS, tiny_port_models

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = [("a lighthouse on a cliff", 1.0)]
SPEC = CutoutSpec(cut_size=32, max_overview=4, max_inner=3)


def _cut_tensors(cd):
    return [cd.crop] + [getattr(cd.aug, f) for f in AUG_FIELDS]


def _same_cuts(a, b):
    return all(torch.equal(u, v) for u, v in zip(_cut_tensors(a), _cut_tensors(b)))


# ---------------- the keyed-draws contract ----------------

def test_draws_are_a_function_of_their_key():
    """The same (purpose, step, group) gives the same numbers whatever was
    drawn before and in whatever order the groups come."""
    torch.set_num_threads(1)
    shape = (2, 8, 8, 3)
    a = TorchDraws(5, "cpu")
    noise = a.step_noise(3, shape)
    cuts = a.cutouts(3, 1, 2, 2, SPEC, 2, 3)
    b = TorchDraws(5, "cpu")
    b.initial_noise(shape)
    b.step_noise(1, shape)
    b.cutouts(3, 0, 2, 2, SPEC, 2, 3)  # the other group first
    assert _same_cuts(b.cutouts(3, 1, 2, 2, SPEC, 2, 3), cuts)
    assert torch.equal(b.step_noise(3, shape), noise)
    assert torch.equal(a.step_noise(3, shape), noise)  # asked again
    # other steps, groups, purposes and seeds draw other numbers
    assert not torch.equal(a.step_noise(2, shape), noise)
    assert not torch.equal(a.inpaint_noise(3, shape), noise)
    assert not torch.equal(TorchDraws(6, "cpu").step_noise(3, shape), noise)
    assert not _same_cuts(a.cutouts(3, 0, 2, 2, SPEC, 2, 3), cuts)


def test_row_views_are_rows_of_the_whole_batch():
    """A row view draws the rows the whole batch drew there, and a row's
    draws do not depend on how many rows are drawn with it."""
    torch.set_num_threads(1)
    whole, shape = TorchDraws(9, "cpu"), (4, 8, 8, 3)
    for lo, hi in ((0, 1), (1, 3), (2, 4)):
        view = TorchDraws(9, "cpu").rows(lo, hi)
        part = (hi - lo,) + shape[1:]
        assert torch.equal(view.initial_noise(part), whole.initial_noise(shape)[lo:hi])
        assert torch.equal(view.step_noise(4, part), whole.step_noise(4, shape)[lo:hi])
        assert torch.equal(view.inpaint_noise(4, part), whole.inpaint_noise(4, shape)[lo:hi])
        got = view.cutouts(4, 2, hi - lo, 2, SPEC, 3, 2)
        want = whole.cutouts(4, 2, 4, 2, SPEC, 3, 2)
        assert all(torch.equal(g, w[lo:hi]) for g, w in zip(_cut_tensors(got), _cut_tensors(want)))
    assert torch.equal(TorchDraws(9, "cpu").step_noise(4, (2,) + shape[1:]),
                       whole.step_noise(4, shape)[:2])
    assert _same_cuts(TorchDraws(9, "cpu").cutouts(4, 2, 1, 2, SPEC, 3, 2),
                      TorchDraws(9, "cpu").rows(0, 1).cutouts(4, 2, 1, 2, SPEC, 3, 2))
    with pytest.raises(ValueError, match="asked for 3 rows"):
        TorchDraws(9, "cpu").rows(1, 3).step_noise(0, (3, 8, 8, 3))
    with pytest.raises(ValueError, match=r"rows \[3, 2\)"):
        TorchDraws(9, "cpu").rows(3, 2)


def test_fold_and_key_data():
    """fold(sub) draws of its own, the same each time and under a row view;
    key_data carries a 64-bit seed through uint32 words."""
    torch.set_num_threads(1)
    base, shape = TorchDraws(11, "cpu"), (2, 4, 4, 3)
    f1 = base.fold(1)
    assert torch.equal(f1.step_noise(2, shape), TorchDraws(11, "cpu").fold(1).step_noise(2, shape))
    assert not torch.equal(f1.step_noise(2, shape), base.step_noise(2, shape))
    assert not torch.equal(f1.step_noise(2, shape), base.fold(2).step_noise(2, shape))
    assert torch.equal(base.rows(0, 1).fold(1).step_noise(2, (1, 4, 4, 3)),
                       f1.step_noise(2, shape)[:1])
    assert f1.seed >= 2**32  # a derived seed uses both words
    words = f1.key_data()
    assert words.dtype == np.uint32 and words.shape == (2,)
    back = TorchDraws.from_key_data(words, "cpu")
    assert back.seed == f1.seed
    assert torch.equal(back.initial_noise(shape), f1.initial_noise(shape))


# ---------------- sub-batches and resume on the tiny pipeline ----------------

@pytest.fixture(scope="module")
def models():
    torch.set_num_threads(1)
    return tiny_port_models("cpu")


def _pipe(models, mode="ddim", steps=5):
    return tzoo.build_pipeline(models, tiny_port_config(), PROMPT,
                               SamplerConfig(mode=mode, steps=steps, eta=0.8))


def test_sub_batches_draw_their_own(models, tmp_path):
    """guided_diffusion_sample(num_batches=2, images_per_dispatch=1): image
    k is sub-batch k run alone with the draws fold(k) (the base draws for
    k = 0); nothing of sub-batch 0 reaches sub-batch 1."""
    torch.set_num_threads(1)
    out = tsample.guided_diffusion_sample(
        prompt=PROMPT[0][0], steps=3, seed=5, num_batches=2, images_per_dispatch=1,
        config=tiny_port_config(), models=models, output_dir=str(tmp_path), device="cpu")
    pipe = tzoo.build_pipeline(models, tiny_port_config(), PROMPT, SamplerConfig(steps=3, eta=0.8))
    pngs = []
    for k, draws in enumerate((TorchDraws(5, "cpu"), TorchDraws(5, "cpu").fold(1))):
        final, _ = tg.guided_sample(pipe, draws, batch_size=1)
        alone = np.asarray(array_to_image((final[0].numpy() + 1) / 2))
        with Image.open(out["images"][k]) as im:
            png = np.asarray(im.convert("RGB"))
        np.testing.assert_array_equal(png, alone)
        pngs.append(png)
    assert np.abs(pngs[0].astype(int) - pngs[1].astype(int)).max() > 0


@pytest.mark.parametrize("mode", ["ddim", "plms"])
def test_resume_is_bit_exact(models, mode, tmp_path):
    """2 steps, the state through .npz, then 3 more with draws=None: the
    frames of the resumed positions, the final image and the state equal
    the straight 5-step run's; the frames before the resume stay zero."""
    torch.set_num_threads(1)
    pipe = _pipe(models, mode)
    full, full_frames, full_state = tg.guided_sample(pipe, TorchDraws(7, "cpu"), batch_size=2,
                                                     return_state=True)
    assert full_state.step == -1
    _, head_frames, state = tg.guided_sample(pipe, TorchDraws(7, "cpu"), batch_size=2,
                                             stop_after=2, return_state=True)
    assert state.step == 5 - 1 - 2 and state.history_count == (2 if mode == "plms" else 0)
    assert torch.equal(head_frames[:2], full_frames[:2])
    path = str(tmp_path / "state.npz")
    state.save(path)
    loaded = SamplingState.load(path)
    assert torch.equal(loaded.x, state.x) and loaded.step == state.step
    resumed, frames, end = tg.guided_sample(pipe, None, batch_size=2, resume_state=loaded,
                                            return_state=True)
    assert torch.equal(resumed, full)
    assert torch.equal(frames[2:], full_frames[2:])
    assert not frames[:2].any()
    assert torch.equal(end.x, full_state.x) and end.history_count == full_state.history_count
    assert torch.equal(end.eps_history, full_state.eps_history)


_CHILD = textwrap.dedent("""
    import sys
    import torch
    torch.set_num_threads(1)
    sys.path.insert(0, "tests")
    from clip_diffusion_tpu_torch import zoo
    from clip_diffusion_tpu_torch.config import Config, CutoutSchedules, create_schedule
    from clip_diffusion_tpu_torch.diffusion.sampling import SamplerConfig
    from clip_diffusion_tpu_torch.pipeline.guided import guided_sample
    from clip_diffusion_tpu_torch.utils.checkpoint import SamplingState
    from torch_ranks import AUG_FIELDS, tiny_port_models

    state_path, mode, out_path = sys.argv[1:4]
    config = Config(
        width=64, height=64, num_cutout_batches=1, guidance_dtype="float32",
        clip_guidance_scale=1000.0, denoise_scale=100.0, range_scale=10.0,
        LPIPS_scale=0.0, MS_SSIM_scale=0.0,
        cutout_schedules=CutoutSchedules(
            num_overview_cuts=create_schedule((2,), (1000,)),
            num_inner_cuts=create_schedule((2,), (1000,)),
            inner_cut_size_power=create_schedule((5,), (1000,)),
            cut_gray_portion=create_schedule((0.5,), (1000,))))
    pipe = zoo.build_pipeline(tiny_port_models("cpu"), config, [("a lighthouse on a cliff", 1.0)],
                              SamplerConfig(mode=mode, steps=5, eta=0.8))
    final, _ = guided_sample(pipe, None, batch_size=2, resume_state=SamplingState.load(state_path))
    torch.save(final, out_path)
""")


@pytest.mark.parametrize("mode", ["ddim", "plms"])
def test_resume_in_a_new_process_is_bit_exact(models, mode, tmp_path):
    """A new process rebuilds the tiny models from their seeds, reads the
    state file and resumes with draws=None: equal to the straight run."""
    torch.set_num_threads(1)
    pipe = _pipe(models, mode)
    assert pipe.config == tiny_port_config()  # the child writes this config out
    full, _ = tg.guided_sample(pipe, TorchDraws(13, "cpu"), batch_size=2)
    _, _, state = tg.guided_sample(pipe, TorchDraws(13, "cpu"), batch_size=2, stop_after=3,
                                   return_state=True)
    state_path, out_path = str(tmp_path / "state.npz"), str(tmp_path / "final.pt")
    state.save(state_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _CHILD, state_path, mode, out_path], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert torch.equal(torch.load(out_path), full)


def test_resume_under_other_draws_raises(models):
    torch.set_num_threads(1)
    pipe = _pipe(models)
    _, _, state = tg.guided_sample(pipe, TorchDraws(5, "cpu"), stop_after=2, return_state=True)
    with pytest.raises(ValueError, match="different draws key"):
        tg.guided_sample(pipe, TorchDraws(6, "cpu"), resume_state=state)
    with pytest.raises(ValueError, match="different draws key"):
        tg.guided_sample(pipe, TorchDraws(5, "cpu").fold(1), resume_state=state)
    # the matching draws are fine
    _, _, after = tg.guided_sample(pipe, TorchDraws(5, "cpu"), resume_state=state, stop_after=1,
                                   return_state=True)
    assert after.step == state.step - 1
    with pytest.raises(ValueError, match="draws are required"):
        tg.guided_sample(pipe, None)


class KeyedReplay(JaxReplayDraws):
    """The JAX draws, with the JAX key's words as the draws' key."""

    def __init__(self, key):
        super().__init__(key)
        self.words = np.asarray(key, np.uint32)

    def key_data(self):
        return self.words


def test_resumed_trajectory_matches_jax(tmp_path):
    """JAX runs 2 of 5 DDIM steps and saves its SamplingState; the port
    reads that .npz (the same names) and resumes with the JAX draws
    replayed, against JAX's own resume: 2e-4, the trajectory's tolerance.
    The port's own 2-step state agrees with JAX's too."""
    torch.set_num_threads(1)
    jpipe, jparams, models = jax_tiny_pipeline(5)
    key = jax.random.PRNGKey(17)
    _, _, jstate = jg.guided_sample(jpipe, jparams, key, batch_size=1, stop_after=2,
                                    return_state=True)
    path = str(tmp_path / "jax_state.npz")
    jstate.save(path)
    jfinal, jframes = jg.guided_sample(jpipe, jparams, None, batch_size=1,
                                       resume_state=JSamplingState.load(path))

    tpipe = tzoo.build_pipeline(models, tiny_port_config(), [("a test prompt", 1.0)],
                                SamplerConfig(steps=5, eta=0.8))
    state = SamplingState.load(path)
    np.testing.assert_array_equal(state.key_data, np.asarray(key, np.uint32))
    tfinal, tframes = tg.guided_sample(tpipe, KeyedReplay(key), batch_size=1, resume_state=state)
    np.testing.assert_allclose(tframes.numpy(), np.asarray(jframes), atol=2e-4)
    np.testing.assert_allclose(tfinal.numpy(), np.asarray(jfinal), atol=2e-4)

    _, _, own = tg.guided_sample(tpipe, KeyedReplay(key), batch_size=1, stop_after=2,
                                 return_state=True)
    assert own.step == jstate.step and own.history_count == jstate.history_count
    np.testing.assert_allclose(own.x.numpy(), np.asarray(jstate.x), atol=2e-4)
