"""The port's LPIPS (VGG16) against the JAX package at its full widths, and
the zoo's random init of LPIPS and the aesthetic heads against the JAX
zoo's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clip_diffusion_tpu.models import aesthetic as ja
from clip_diffusion_tpu.models.lpips import LPIPS as JLPIPS
from clip_diffusion_tpu.zoo import _host_init
from clip_diffusion_tpu_torch import zoo as tzoo
from clip_diffusion_tpu_torch.models import aesthetic as ta
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.lpips import LPIPS


def _jax_lpips_init(model):
    return lambda: model.init(jax.random.PRNGKey(1000), jnp.ones((1, 64, 64, 3)),
                              jnp.ones((1, 64, 64, 3)))


@pytest.fixture(scope="module")
def lpips_pair():
    """JAX LPIPS with the JAX zoo's random init (seed 1000), and the port's
    LPIPS from the port zoo with the same seed."""
    torch.set_num_threads(1)
    jmodel = JLPIPS(dtype=jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, _host_init(_jax_lpips_init(jmodel), param_dtype=jnp.float32, seed=1000))
    tmodel = tzoo.build_lpips(device="cpu")
    return jmodel, params, tmodel


def test_lpips_host_init_equals_jax_zoo(lpips_pair):
    """build_lpips's default seed and leaf order give the JAX zoo's VGG16
    and lin weights (14,716,160 of them), carried by from_jax."""
    _, params, tmodel = lpips_pair
    want = from_jax.to_state_dict(params, LPIPS(), from_jax.lpips_rule)
    got = tmodel.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    assert sum(v.numel() for v in got.values()) == 14716160
    assert all(not p.requires_grad for p in tmodel.parameters())


def test_lpips_and_gradient_match(lpips_pair):
    """LPIPS at 64x64 with the full VGG16 widths: a batch of 2 against a
    target of batch 1, the value and its gradient with respect to x.  f32
    through 13 convolutions in another sum order: rtol 1e-5 on the value,
    atol 1e-4 of the gradient's scale."""
    torch.set_num_threads(1)
    jmodel, params, tmodel = lpips_pair
    rng = np.random.default_rng(0)
    y = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)
    x = np.clip(y + rng.normal(0, 0.4, (2, 64, 64, 3)), -1, 1).astype(np.float32)

    def jloss(a):
        return jnp.sum(jmodel.apply(params, a, jnp.asarray(y)))

    jval = np.asarray(jax.jit(lambda a: jmodel.apply(params, a, jnp.asarray(y)))(jnp.asarray(x)))
    jgrad = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tval = tmodel(xt, torch.from_numpy(y))
    (tgrad,) = torch.autograd.grad(tval.sum(), xt)
    assert tval.shape == jval.shape == (2,)
    np.testing.assert_allclose(tval.detach().numpy(), jval, rtol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=1e-4 * float(np.abs(jgrad).max()))
    same = tmodel(torch.from_numpy(y), torch.from_numpy(y))
    np.testing.assert_allclose(same.detach().numpy(), 0.0, atol=1e-7)


@pytest.mark.parametrize("position,name", [(0, "ViT-B/32"), (2, "ViT-L/14")])
def test_aesthetic_host_init_equals_jax_zoo(position, name):
    """The zoo's aesthetic head for the tower at `position` of
    chosen_clip_models: float32, seed + 100 + position, the JAX zoo's
    weights."""
    seed = 5
    head = ja.make_aesthetic_predictor(name)
    ref = _host_init(lambda: head.init(jax.random.PRNGKey(0), jnp.ones((1, ja.CLIP_DIMS[name]))),
                     param_dtype=jnp.float32, seed=seed + 100 + position)
    tmodel = ta.make_aesthetic_predictor(name)
    sd = tzoo.host_init_state_dict(tmodel, from_jax.aesthetic_rule, seed + 100 + position,
                                   torch.float32)
    want = from_jax.to_state_dict(jax.tree_util.tree_map(np.asarray, ref), tmodel,
                                  from_jax.aesthetic_rule)
    assert sd.keys() == want.keys()
    for k in sd:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
