"""Parity of the port's resize, augment and cutout modules with the JAX
package, on the same inputs and the JAX package's own random draws.

Also home of `jax_cut_draws`, the replay of the JAX key chain of
`make_cutouts_batch` into the port's `CutDraws` (used by the guided tests).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from clip_diffusion_tpu.guidance import cutouts as jcut
from clip_diffusion_tpu.ops import augment as jaug
from clip_diffusion_tpu.ops import resize as jres
from clip_diffusion_tpu_torch.guidance import cutouts as tcut
from clip_diffusion_tpu_torch.ops import augment as taug
from clip_diffusion_tpu_torch.ops import resize as tres


def _t(a):
    return torch.from_numpy(np.array(a))


def jax_cut_draws(gkey, batch, repeats, spec, n_ov, n_in, dtype=jnp.float32):
    """The JAX package's draws for `make_cutouts_batch(images, gkey, ...)`
    (split per image x repeat, then k_inner/k_aug, then per slot), with the
    active slots selected, as a port `CutDraws`."""
    cfg = spec.augment_cfg
    s = spec.cut_size
    keys = jax.random.split(gkey, batch * repeats).reshape(batch, repeats, 2)
    crop, flip, noise, affine, gray, jitter = ([] for _ in range(6))
    for i in range(batch):
        for r in range(repeats):
            k_inner, k_aug = jax.random.split(keys[i, r])
            crop.append([
                [jax.random.uniform(k, ()) for k in jax.random.split(ki, 3)]
                for ki in jax.random.split(k_inner, spec.max_inner)
            ])
            for ka in jax.random.split(k_aug, spec.max_total):
                k7 = jax.random.split(ka, 7)
                flip.append(jax.random.bernoulli(k7[0], cfg.flip_p))
                noise.append([jax.random.normal(k7[j], (s, s, 3), dtype) for j in (1, 3, 5)])
                k1, k2, k3 = jax.random.split(k7[2], 3)
                max_t = cfg.translate * s
                affine.append([
                    jax.random.uniform(k1, (), minval=-cfg.degrees, maxval=cfg.degrees)
                    * (jnp.pi / 180.0),
                    jax.random.uniform(k2, (), minval=-max_t, maxval=max_t),
                    jax.random.uniform(k3, (), minval=-max_t, maxval=max_t),
                ])
                gray.append(jax.random.bernoulli(k7[4], cfg.grayscale_p))
                kb, kc, ks, kh = jax.random.split(k7[6], 4)
                lo, hi = 1.0 - cfg.jitter, 1.0 + cfg.jitter
                jitter.append([
                    jax.random.uniform(kb, (), minval=lo, maxval=hi),
                    jax.random.uniform(kc, (), minval=lo, maxval=hi),
                    jax.random.uniform(ks, (), minval=lo, maxval=hi),
                    jax.random.uniform(kh, (), minval=-cfg.jitter, maxval=cfg.jitter),
                ])
    lead = (batch, repeats, spec.max_total)
    act = tcut.active_slots(spec, n_ov, n_in)

    def pick(x, tail=()):
        return _t(np.asarray(x).reshape(lead + tail))[:, :, act]

    aug = taug.AugmentDraws(
        flip=pick(flip), noise=pick(noise, (3, s, s, 3)), affine=pick(affine, (3,)),
        gray=pick(gray), jitter=pick(jitter, (4,)),
    )
    crop = _t(np.asarray(crop).reshape(batch, repeats, spec.max_inner, 3))[:, :, :n_in]
    return tcut.CutDraws(crop=crop, aug=aug)


def test_axis_resize_weights_match():
    torch.set_num_threads(1)
    for start, size, pad in ((3.0, 17.0, 0), (-4.0, 40.0, 4), (0.0, 32.0, 0)):
        for method in ("cubic", "linear"):
            j = np.asarray(jres.axis_resize_weights(24, 32, start, size, method, pad))
            t = tres.axis_resize_weights(24, 32, start, size, method, pad).numpy()
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)  # f32 rounding


def test_crop_and_pad_resize_match():
    """f32 matmul sums in another order: atol 1e-5 on [0, 1] images."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (48, 40, 3)).astype(np.float32)
    j = np.asarray(jres.crop_resize(jnp.asarray(img), 5.0, 7.0, 30.0, 30.0, 16))
    t = tres.crop_resize(_t(img), 5.0, 7.0, 30.0, 30.0, 16).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)
    j = np.asarray(jres.pad_to_square_resize(jnp.asarray(img), 16))
    t = tres.pad_to_square_resize(_t(img), 16).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)
    # a batch of crops equals the crops one at a time
    ys, xs, ss = [2.0, 9.0], [0.0, 4.0], [20.0, 36.0]
    tb = tres.crop_resize(_t(img), _t(ys), _t(xs), _t(ss), _t(ss), 16).numpy()
    for i in range(2):
        ji = np.asarray(jres.crop_resize(jnp.asarray(img), ys[i], xs[i], ss[i], ss[i], 16))
        np.testing.assert_allclose(tb[i], ji, atol=1e-5)


def test_affine_shear_matches():
    """The 3-shear warp against JAX's, f32 on [0, 1] images: atol 1e-5."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 1, (3, 24, 24, 3)).astype(np.float32)
    theta = np.asarray([0.1, -0.17, 0.0])
    ty = np.asarray([0.7, -1.2, 0.0])
    tx = np.asarray([-0.4, 1.1, 0.3])
    t = taug._affine_shear(_t(img), _t(theta), _t(ty), _t(tx)).numpy()
    for i in range(3):
        j = np.asarray(jaug._affine_shear(jnp.asarray(img[i]), theta[i], ty[i], tx[i]))
        np.testing.assert_allclose(t[i], j, atol=1e-5)


def test_augment_batch_matches_with_jax_draws():
    """The full stack with the JAX package's draws: atol 1e-5 (f32 sums)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(2)
    imgs = rng.uniform(0, 1, (4, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    j = np.asarray(jaug.augment_batch(jnp.asarray(imgs), key))
    spec = tcut.CutoutSpec(cut_size=16, max_overview=4, max_inner=0)
    # augment_batch splits its key per image exactly as the cutout engine
    # splits k_aug per slot, so replay it through the k_aug branch
    keys = jax.random.split(key, 4)
    draws = []
    for k in keys:
        k7 = jax.random.split(k, 7)
        k1, k2, k3 = jax.random.split(k7[2], 3)
        kb, kc, ks, kh = jax.random.split(k7[6], 4)
        cfg = spec.augment_cfg
        draws.append(dict(
            flip=jax.random.bernoulli(k7[0], cfg.flip_p),
            noise=[jax.random.normal(k7[i], (16, 16, 3), jnp.float32) for i in (1, 3, 5)],
            affine=[jax.random.uniform(k1, (), minval=-10.0, maxval=10.0) * (jnp.pi / 180.0),
                    jax.random.uniform(k2, (), minval=-0.8, maxval=0.8),
                    jax.random.uniform(k3, (), minval=-0.8, maxval=0.8)],
            gray=jax.random.bernoulli(k7[4], cfg.grayscale_p),
            jitter=[jax.random.uniform(kb, (), minval=0.9, maxval=1.1),
                    jax.random.uniform(kc, (), minval=0.9, maxval=1.1),
                    jax.random.uniform(ks, (), minval=0.9, maxval=1.1),
                    jax.random.uniform(kh, (), minval=-0.1, maxval=0.1)],
        ))
    aug = taug.AugmentDraws(*(_t(np.asarray([d[f] for d in draws]))
                              for f in ("flip", "noise", "affine", "gray", "jitter")))
    t = taug.augment_batch(_t(imgs), aug).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)


def test_make_cutouts_batch_matches_padded_jax_run():
    """Only the active slots are evaluated; their cuts and weights equal the
    JAX padded run's active slots (f32 sums: atol 2e-5), and the inactive
    slots carry zero weight there."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(4)
    images = rng.uniform(-1, 1, (2, 40, 48, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    repeats, max_ov, max_in = 2, 5, 3
    jspec = jcut.CutoutSpec(cut_size=16, max_overview=max_ov, max_inner=max_in)
    tspec = tcut.CutoutSpec(cut_size=16, max_overview=max_ov, max_inner=max_in)
    # (n_ov, n_in): the <=4 overview variants, plain copies, no overview
    for n_ov, n_in, power, gray in ((3, 2, 5.0, 0.5), (5, 3, 2.0, 0.3), (0, 3, 1.0, 0.0)):
        jc, jw = jcut.make_cutouts_batch(
            jnp.asarray(images), key, jnp.int32(n_ov), jnp.int32(n_in),
            jnp.float32(power), jnp.float32(gray), jspec, repeats=repeats,
        )
        jc = np.asarray(jc).reshape(2, repeats, max_ov + max_in, 16, 16, 3)
        jw = np.asarray(jw).reshape(2, repeats, max_ov + max_in)
        act = tcut.active_slots(tspec, n_ov, n_in).numpy()
        draws = jax_cut_draws(key, 2, repeats, tspec, n_ov, n_in)
        tc, tw = tcut.make_cutouts_batch(
            _t(images), draws, n_ov, n_in, float(np.float32(power)),
            float(np.float32(gray)), tspec, repeats=repeats,
        )
        tc = tc.numpy().reshape(2, repeats, n_ov + n_in, 16, 16, 3)
        tw = tw.numpy().reshape(2, repeats, n_ov + n_in)
        np.testing.assert_allclose(tc, jc[:, :, act], atol=2e-5)
        np.testing.assert_array_equal(tw, jw[:, :, act])
        inactive = np.setdiff1d(np.arange(max_ov + max_in), act)
        assert np.all(jw[:, :, inactive] == 0)
        np.testing.assert_allclose(tw.sum(axis=(1, 2)), 1.0, rtol=1e-6)


def test_inner_slot_zero_always_gray():
    """The reference's `<=`: with gray portion 0, inner slot 0 is gray."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(6)
    image01 = _t(rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))
    spec = tcut.CutoutSpec(cut_size=8, max_overview=0, max_inner=3, augment=False)
    crop = _t(rng.uniform(0, 1, (1, 3, 3)))
    cuts = tcut._inner_cuts(image01, crop, 3, 1.0, 0.0, spec)[0]
    assert torch.allclose(cuts[0, ..., 0], cuts[0, ..., 1])
    assert not torch.allclose(cuts[1, ..., 0], cuts[1, ..., 1])


def test_torch_draws_shapes():
    """The generator-backed draws have the shapes the transforms take."""
    gen = torch.Generator().manual_seed(0)
    spec = tcut.CutoutSpec(cut_size=8, max_overview=4, max_inner=4)
    d = tcut.draw_cutouts(gen, 2, 3, spec, 2, 4, "cpu")
    assert d.crop.shape == (2, 3, 4, 3)
    assert d.aug.noise.shape == (2, 3, 6, 3, 8, 8, 3)
    assert d.aug.affine.shape == (2, 3, 6, 3) and d.aug.jitter.shape == (2, 3, 6, 4)
    assert d.aug.flip.dtype == torch.bool
    assert float(d.aug.affine[..., 0].abs().max()) <= np.deg2rad(10.0)
