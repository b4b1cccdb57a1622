"""Stable Diffusion XL base 1.0 in the port against the plain float32
reference `port_bench/reference/sdxl.py` on the CPU: the UNet with a
depth per level, linear projections, the label embedding and fixed-width
heads; both text towers (hidden state after a given block without
`ln_final`, the pooled projection, exact GELU against QuickGELU) and the
conditioner's context and vector; the KL-f8 encode and decode with the
scale factor; a whole tiny request through `sample.latent_diffusion_sample`
against the reference's CFG DDIM loop on the same keyed draws; and at the
published widths on `meta` each module's parameter count against the
benchmark's configuration file and the attention calls of a forward.
The JAX package has no SDXL, so there is no JAX twin here.  TF32 is off;
every comparison is float32 against float32."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from clip_diffusion_tpu_torch import sample as tsample
from clip_diffusion_tpu_torch import zoo
from clip_diffusion_tpu_torch.models.clip.model import CLIPTextModel
from clip_diffusion_tpu_torch.models.ldm import unet as tunet
from clip_diffusion_tpu_torch.models.ldm.autoencoder import KLModel
from clip_diffusion_tpu_torch.models.ldm.unet import LDMUNet
from port_bench.reference import sdxl as ref

CONFIG = os.path.join(os.path.dirname(__file__), "..", "port_bench", "configs",
                      "latent-sdxl-base-1024.json")


@pytest.fixture(autouse=True)
def _cpu_float32():
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _randomize(module, seed):
    """Every parameter drawn from the seed, none left at zero: weights ~
    N(0, 1/fan_in), vectors 0.1 N(0, 1), plus 1 for norm scales (the
    one-dimensional weights)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            noise = torch.randn(p.shape, generator=g)
            if p.dim() > 1:
                p.copy_(noise * p[0].numel() ** -0.5)
            else:
                p.copy_(noise * 0.1 + float(name.endswith("weight")))
    return module.requires_grad_(False).eval()


def _twin(port, build_ref):
    """The reference module holding the port module's parameters."""
    r = build_ref()
    r.load_state_dict(port.state_dict(), strict=True)
    return r.requires_grad_(False).eval()


def _unet_kwargs(cfg):
    keys = ("in_channels", "out_channels", "model_channels", "num_res_blocks", "attention_ds",
            "channel_mult", "num_head_channels", "transformer_depth", "context_dim",
            "adm_in_channels", "use_linear_in_transformer")
    return {k: getattr(cfg, k) for k in keys}


def _text_kwargs(cfg):
    return {k: getattr(cfg, k) for k in ("width", "heads", "layers", "embed_dim", "act")}


def _cond_group(c: zoo.SDXLConfig, size=(1024, 1024)):
    return {"clip_l_layer": c.clip_l_layer, "clip_g_layer": c.clip_g_layer,
            "original_size": list(size), "crop_coords_top_left": [0, 0],
            "target_size": list(size), "size_embed_dim": c.size_embed_dim}


def _vae_group(c):
    keys = ("z_channels", "embed_dim", "ch", "ch_mult", "num_res_blocks", "attn_resolutions",
            "resolution", "out_ch", "scale_factor")
    return {k: getattr(c, k) for k in keys}


def test_tiny_unet_matches_reference():
    """Depths (0, 1, 2) per level with attention at levels 1 and 2 (the
    middle block takes 2), linear proj_in/proj_out, 16-wide heads (4 at
    64 channels, 8 at 128) and the label embedding of y: the port's
    `_forward` within 2e-5 of the reference's largest |eps| (float32 on
    both sides; only the order of sums differs).  y matters: another
    vector changes eps."""
    cfg = zoo.SDXLConfig.tiny().unet
    unet = _randomize(LDMUNet(cfg), 0)
    heads = [m.heads for m in unet.modules() if isinstance(m, tunet.CrossAttention)]
    assert heads[:2] == [4, 4] and heads[4] == 8
    r = _twin(unet, lambda: ref.SDXLUNet(**_unet_kwargs(cfg)))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 8, 8, 4), generator=g)
    t = torch.tensor([981.0, 1.0])
    ctx = torch.randn((2, 7, cfg.context_dim), generator=g)
    y = torch.randn((2, cfg.adm_in_channels), generator=g)
    with torch.no_grad():
        got = unet._forward(x, t, ctx, y)
        want = r(x, t, ctx, y)
        other = unet._forward(x, t, ctx, y.flip(0))
    scale = want.abs().max().item()
    assert got.shape == want.shape == (2, 8, 8, 4)
    assert (got - want).abs().max().item() <= 2e-5 * scale
    assert (other - got).abs().max().item() > 1e-3 * scale


def test_tiny_unet_counts_two_attention_calls_per_block():
    """17 transformer blocks (2 x 1 + 2 x 2 down, 2 in the middle, 3 x 2 +
    3 x 1 up), each a self- and a cross-attention: 34 calls a forward, on
    the CPU's eager path too."""
    cfg = zoo.SDXLConfig.tiny().unet
    unet = LDMUNet(cfg).requires_grad_(False)
    blocks = sum(isinstance(m, tunet.BasicTransformerBlock) for m in unet.modules())
    before = tunet.attention.calls
    with torch.no_grad():
        unet(torch.zeros((2, 8, 8, 4)), torch.ones(2), torch.zeros((2, 7, cfg.context_dim)),
             torch.zeros((2, cfg.adm_in_channels)))
    assert blocks == 17 and tunet.attention.calls - before == 2 * blocks


@pytest.mark.parametrize("tower", ["clip_l", "clip_g"])
def test_text_towers_match_reference(tower):
    """CLIP-L's shape (QuickGELU, no text_projection, hidden state after 2
    of 3 blocks; only those 2 run) and bigG's (exact GELU, hidden state
    after 2 of 3 blocks, the pooled projection of the last block's
    `ln_final` at the EOT token): within 1e-5 of the reference's largest
    value (float32 both sides).  The other activation gives another
    hidden state, so the choice is held."""
    c = getattr(zoo.SDXLConfig.tiny(), tower)
    layer = 2
    port = _randomize(CLIPTextModel(c), 2)
    r = _twin(port, lambda: ref.TextTower(**_text_kwargs(c)))
    toks = torch.from_numpy(ref.tokens_g(["a red cube on a table", ""]))
    with torch.no_grad():
        hidden, pooled = port.encode(toks, layer)
        want_h, want_p = r(toks, layer)
        swapped = dataclasses.replace(c, act="gelu" if c.act == "quick_gelu" else "quick_gelu")
        other = CLIPTextModel(swapped)
        other.load_state_dict(port.state_dict())
        other_h, _ = other.encode(toks, layer)
    assert (hidden - want_h).abs().max() <= 1e-5 * want_h.abs().max()
    assert (other_h - hidden).abs().max() > 1e-4 * want_h.abs().max()
    if c.embed_dim:
        assert pooled.shape == (2, c.embed_dim) and pooled.dtype == torch.float32
        assert (pooled - want_p).abs().max() <= 1e-5 * want_p.abs().max()
    else:
        assert pooled is None and want_p is None


def test_conditioner_matches_reference():
    """`zoo.SDXLTextEncoder`: the context [CLIP-L | bigG] (77 tokens; CLIP-L's
    padded with EOT, bigG's with 0) and the vector [pooled | 6 size
    embeddings] of the prompt and of "" within 1e-5 of the reference's
    (float32 both sides); the size conditioning reaches the vector."""
    c = zoo.SDXLConfig.tiny()
    models = zoo.build_sdxl_models(param_dtype=torch.float32, seed=3, config=c, device="cpu")
    _randomize(models.clip_l, 4)
    _randomize(models.clip_g, 5)
    rl_ = _twin(models.clip_l, lambda: ref.TextTower(**_text_kwargs(c.clip_l)))
    rg = _twin(models.clip_g, lambda: ref.TextTower(**_text_kwargs(c.clip_g)))
    _, encode = zoo.build_sdxl_pipeline(models)
    texts = ["A cute golden retriever.", ""]
    ctx, vec = encode(texts)
    with torch.no_grad():
        want_ctx, want_vec = ref.conditioning(rl_, rg, texts, _cond_group(c), "cpu")
    assert ctx.shape == (2, 77, 40) and vec.shape == (2, 24 + 6 * 8)
    assert (ctx - want_ctx).abs().max() <= 1e-5 * want_ctx.abs().max()
    assert (vec - want_vec).abs().max() <= 1e-5 * want_vec.abs().max()
    _, small = zoo.build_sdxl_pipeline(models, original_size=(512, 512), target_size=(512, 512))
    assert not torch.equal(small(texts)[1][:, 24:], vec[:, 24:])
    assert torch.equal(small(texts)[0], ctx)


def test_kl_encode_and_decode_match_reference():
    """The KL-f8 stage at tiny width: `encode` is the posterior mean times
    0.13025, `decode` divides by it first; both within 1e-5 of the
    reference's largest value (float32, the same convolutions and the
    mid block's attention, which the reference blocks over the queries)."""
    c = zoo.SDXLConfig.tiny().vae
    vae = _randomize(KLModel(c), 6)
    r = _twin(vae, lambda: ref.KLModel(_vae_group(c)))
    g = torch.Generator().manual_seed(7)
    pixels = torch.rand((2, 16, 16, 3), generator=g) * 2 - 1
    with torch.no_grad():
        z = vae.encode(pixels)
        want_z = r.encode(pixels)
        moments = vae.quant_conv(vae.encoder(pixels.permute(0, 3, 1, 2)))
        img = vae.decode(z)
        want_img = r.decode(z)
    assert z.shape == (2, 8, 8, 4)
    torch.testing.assert_close(z, moments[:, :4].permute(0, 2, 3, 1) * 0.13025, rtol=0,
                               atol=1e-6)
    assert (z - want_z).abs().max() <= 1e-5 * want_z.abs().max()
    assert (img - want_img).abs().max() <= 1e-5 * want_img.abs().max()


def test_tiny_request_matches_reference_loop(tmp_path):
    """A whole tiny request (1 iteration x 2 images, 16 x 16 pixels, 4 CFG
    DDIM steps, guidance 5) through `sample.latent_diffusion_sample(pipe=,
    text_encode=)` against the reference's conditioning, CFG DDIM loop from
    the same keyed initial noise and KL decode: final latents within 1e-4
    of their largest value (float32; four steps compound the order-of-sums
    gaps of the UNet), PNGs within one level (rounding at a level's edge)."""
    c = zoo.SDXLConfig.tiny()
    models = zoo.build_sdxl_models(param_dtype=torch.float32, seed=8, config=c, device="cpu")
    for k, part in enumerate((models.unet, models.clip_l, models.clip_g, models.vae)):
        _randomize(part, 10 + k)
    pipe, encode = zoo.build_sdxl_pipeline(models, original_size=(16, 16),
                                           target_size=(16, 16))
    finals = []
    decode = pipe.decode
    pipe = dataclasses.replace(pipe, decode=lambda z: finals.append(z.clone()) or decode(z))
    prompt, seed, steps, scale = "a lighthouse at dusk", 1234, 4, 5.0
    out = tsample.latent_diffusion_sample(
        prompt, seed=seed, diffusion_steps=steps, latent_diffusion_guidance_scale=scale,
        num_iterations=1, num_batches=2, sample_width=16, sample_height=16, pipe=pipe,
        text_encode=encode, output_dir=str(tmp_path), device="cpu")

    unet = _twin(models.unet, lambda: ref.SDXLUNet(**_unet_kwargs(c.unet)))
    cl = _twin(models.clip_l, lambda: ref.TextTower(**_text_kwargs(c.clip_l)))
    cg = _twin(models.clip_g, lambda: ref.TextTower(**_text_kwargs(c.clip_g)))
    vae = _twin(models.vae, lambda: ref.KLModel(_vae_group(c.vae)))
    with torch.no_grad():
        cond = _cond_group(c, (16, 16))
        ctx_c, vec_c = ref.conditioning(cl, cg, [prompt] * 2, cond, "cpu")
        ctx_u, vec_u = ref.conditioning(cl, cg, [""] * 2, cond, "cpu")
        ctx, vec = ref.interleave(ctx_u, ctx_c), ref.interleave(vec_u, vec_c)
        tables = ref.ddim_tables(steps)
        x = ref.initial_noise(seed, 0, (2, 8, 8, 4), "cpu")
        for i in range(steps - 1, -1, -1):
            x = ref.cfg_step(unet, x, i, tables, ctx, vec, scale)
        images = torch.clamp((vae.decode(x) + 1) / 2, 0, 1)
    (got,) = finals
    assert (got - x).abs().max() <= 1e-4 * x.abs().max()
    want_u8 = (images.numpy() * 255 + 0.5).astype(np.int32)
    for j, path in enumerate(out["images"]):
        png = np.asarray(Image.open(path).convert("RGB"), dtype=np.int32)
        assert png.shape == (16, 16, 3)
        assert np.abs(png - want_u8[j]).max() <= 1


def test_published_widths_on_meta():
    """Built on `meta` at the published widths: each module's parameter
    count equals the benchmark configuration's (UNet 2,567,463,684), and
    one UNet forward at the cell's CFG shape (6 x 128 x 128 x 4) makes 140
    attention calls: 70 transformer blocks, each a self- and a
    cross-attention."""
    with open(CONFIG) as f:
        want = json.load(f)["parameters"]
    c = zoo.SDXLConfig()
    with torch.device("meta"):
        parts = {"unet": LDMUNet(c.unet), "clip_l": CLIPTextModel(c.clip_l),
                 "clip_g": CLIPTextModel(c.clip_g), "vae": KLModel(c.vae)}
    got = {k: sum(p.numel() for p in m.parameters()) for k, m in parts.items()}
    assert got == want
    unet = parts["unet"]
    blocks = sum(isinstance(m, tunet.BasicTransformerBlock) for m in unet.modules())
    before = tunet.attention.calls
    m = "meta"
    with torch.no_grad():
        eps = unet(torch.zeros((6, 128, 128, 4), device=m), torch.ones(6, device=m),
                   torch.zeros((6, 77, 2048), device=m), torch.zeros((6, 2816), device=m))
    assert eps.shape == (6, 128, 128, 4)
    assert blocks == 70 and tunet.attention.calls - before == 140


@pytest.mark.cuda
def test_attention_counter_under_graph_replay():
    """On the card without grad the tiny SDXL UNet replays a CUDA graph:
    the first call (two warm-up forwards and the capture, then a replay)
    and each later replay add the calls of one forward, 34, the same as
    an eager call; the replay equals `_forward` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cfg = zoo.SDXLConfig.tiny().unet
    unet = _randomize(LDMUNet(cfg), 0).to(dev)
    g = torch.Generator(dev).manual_seed(3)
    args = (torch.randn((2, 8, 8, 4), generator=g, device=dev), torch.tensor([5.0, 6.0],
            device=dev), torch.randn((2, 7, cfg.context_dim), generator=g, device=dev),
            torch.randn((2, cfg.adm_in_channels), generator=g, device=dev))
    with torch.inference_mode():
        for k in range(3):
            before = tunet.attention.calls
            got = unet(*args)
            assert tunet.attention.calls - before == 34, k
        assert len(unet._graphs) == 1
        before = tunet.attention.calls
        want = unet._forward(*args)
        assert tunet.attention.calls - before == 34
    assert torch.equal(got, want)
