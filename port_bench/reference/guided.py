"""One CLIP-guided DDIM step in plain float32 PyTorch.

What a step of the default guided request computes, written from the
published algorithm (guided-diffusion's respaced DDIM, Disco Diffusion's
cutouts and losses, Imagen's dynamic thresholding):

1. eps from the UNet at (x, t); pred_x0 = x / sqrt(a) - sqrt(1/a - 1) eps;
2. denoised = pred_x0 * sqrt(1 - a) + x * (1 - sqrt(1 - a)) cut into
   overview and inner cutouts (the schedules' counts at the step), each
   augmented (flip, noise, rotation and translation as three shears,
   grayscale, colour jitter) and scored by every CLIP tower against the
   prompt by squared spherical distance, weighted 1 / cuts; plus the
   total-variation loss on denoised;
3. the gradient of that loss with respect to x, negated, NaN-guarded and
   clamped to RMS `grad_threshold`;
4. pred_x0 thresholded at the exact 0.995 quantile of |pred_x0| (floored
   at 1), eps re-derived, conditioned on the gradient, and the DDIM update
   with eta and the step's noise.

The random values (noise, cut geometry, augmentation) are re-derived here
from the request's key by the documented keyed-draw scheme: every row of
every draw comes from a generator seeded afresh from (seed, purpose,
step[, group], row) through numpy's SeedSequence, drawn in a fixed order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from port_bench.reference.clip import clip_normalize, tokenize

_INIT, _STEP, _INPAINT, _CUTOUTS = 0, 1, 2, 3


# ---- schedule ---------------------------------------------------------------

def ddim_tables(steps: int, device) -> Dict[str, torch.Tensor]:
    """guided-diffusion's linear-beta process respaced to `steps` by the
    "ddim{N}" rule, rescaled timesteps; float32 tables per sampler step."""
    base = (1000 // steps) * steps if steps < 1000 else steps
    scale = 1000.0 / base
    base_acp = np.cumprod(1.0 - np.linspace(scale * 1e-4, scale * 0.02, base, dtype=np.float64))
    stride = next(s for s in range(1, base) if len(range(0, base, s)) == steps)
    use = list(range(0, base, stride))
    acp = base_acp[use]
    acp_prev = np.append(1.0, acp[:-1])
    t = {
        "acp": acp, "acp_prev": acp_prev,
        "sqrt_recip": np.sqrt(1.0 / acp), "sqrt_recipm1": np.sqrt(1.0 / acp - 1.0),
        "sqrt_1m": np.sqrt(1.0 - acp),
        "scaled_t": np.asarray(use, np.float64) * (1000.0 / base),
    }
    return {k: torch.from_numpy(v).to(torch.float32).to(device) for k, v in t.items()}


def schedule_index(tables, step: int) -> int:
    """Sampler step -> index into the 1000-entry cutout schedules."""
    t = float(tables["scaled_t"][step].item())
    return int(np.clip(999 - int(np.floor(np.float32(t))), 0, 999))


def dense_schedule(values: Sequence, counts: Sequence[int]) -> np.ndarray:
    return np.repeat(np.asarray(values, np.float64), counts)


# ---- keyed draws ------------------------------------------------------------

def derive_seed(seed: int, *words: int) -> int:
    return int(np.random.SeedSequence([int(seed), *words]).generate_state(1, np.uint64)[0])


class Draws:
    """The request's draws for rows [lo, hi) of its batch."""

    def __init__(self, seed: int, device, lo: int = 0):
        self.seed, self.device, self.lo = int(seed), torch.device(device), lo
        self.gen = torch.Generator(self.device)

    def _gen(self, row: int, *words: int):
        return self.gen.manual_seed(derive_seed(self.seed, *words, self.lo + row))

    def normal(self, shape, *words: int):
        return torch.cat([torch.randn((1,) + tuple(shape[1:]), generator=self._gen(r, *words),
                                      device=self.device) for r in range(shape[0])])

    def cutouts(self, step, group, batch, repeats, size, n_ov, n_in):
        """Per row: crop (1, R, n_in, 3) uniforms, then the augmentation
        draws of the (1, R, n_ov + n_in) slots in the order flip, noise
        (3 stages), angle, ty, tx, gray, jitter (4)."""
        out = []
        for r in range(batch):
            g = self._gen(r, _CUTOUTS, step, group)
            shape = (1, repeats, n_ov + n_in)

            def uni(lo, hi):
                return lo + (hi - lo) * torch.rand(shape, generator=g, device=self.device)

            crop = torch.rand((1, repeats, n_in, 3), generator=g, device=self.device)
            flip = uni(0.0, 1.0) < 0.5
            noise = torch.randn(shape + (3, size, size, 3), generator=g, device=self.device)
            max_t = 0.05 * size
            affine = torch.stack([uni(-10.0, 10.0) * (math.pi / 180.0), uni(-max_t, max_t),
                                  uni(-max_t, max_t)], dim=-1)
            gray = uni(0.0, 1.0) < 0.1
            jitter = torch.stack([uni(0.9, 1.1), uni(0.9, 1.1), uni(0.9, 1.1),
                                  uni(-0.1, 0.1)], dim=-1)
            out.append(dict(crop=crop, flip=flip, noise=noise, affine=affine, gray=gray,
                            jitter=jitter))
        return {k: torch.cat([d[k] for d in out]) for k in out[0]}


# ---- cutouts and augmentation ------------------------------------------------

def _cubic(x, a=-0.5):
    ax = torch.abs(x)
    inner = (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0
    outer = a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a
    return torch.where(ax <= 1.0, inner, torch.where(ax < 2.0, outer, torch.zeros_like(ax)))


def resize_weights(out_size, in_size, start, size, pad=0, device=None):
    """Antialiased cubic resampling matrix of the window [start, start +
    size) of an axis (plus `pad` virtual zero pixels each side)."""
    start = torch.as_tensor(start, dtype=torch.float32, device=device)[..., None, None]
    size = torch.as_tensor(size, dtype=torch.float32, device=device)[..., None, None]
    i = torch.arange(out_size, dtype=torch.float32, device=device)[:, None]
    scale = size / out_size
    centers = start + (i + 0.5) * scale - 0.5
    j = torch.arange(-pad, in_size + pad, dtype=torch.float32, device=device)[None, :]
    w = _cubic((j - centers) / torch.clamp_min(scale, 1.0))
    w = torch.where((j >= start - 0.5) & (j < start + size - 0.5), w, torch.zeros_like(w))
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-8)
    return w[..., pad:pad + in_size] if pad else w


def gray3(img):
    y = 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    return torch.stack([y, y, y], dim=-1)


def _shear_rows(img, shifts):
    xo = torch.arange(img.shape[2], dtype=torch.float32, device=img.device)
    w = torch.clamp_min(1.0 - torch.abs(xo[:, None] - (xo[None, :] + shifts[..., None, None])),
                        0.0)
    return torch.einsum("nyic,nyio->nyoc", img, w)


def _shear_cols(img, shifts):
    yo = torch.arange(img.shape[1], dtype=torch.float32, device=img.device)
    w = torch.clamp_min(1.0 - torch.abs(yo[:, None] - (yo[None, :] + shifts[..., None, None])),
                        0.0)
    return torch.einsum("nixc,nxio->noxc", img, w)


def rotate_translate(img, theta, ty, tx):
    """Bilinear rotation by theta about the centre plus translation, as
    x-shear, y-shear, x-shear (Paeth), zero fill."""
    c = (img.shape[1] - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    alpha = -torch.tan(theta / 2.0)
    u2 = -(cos * ty + sin * tx)
    u1 = -(-sin * ty + cos * tx) - alpha * u2
    yy = torch.arange(img.shape[1], dtype=torch.float32, device=img.device) - c
    out = _shear_rows(img, alpha[:, None] * yy + u1[:, None])
    out = _shear_cols(out, sin[:, None] * yy + u2[:, None])
    return _shear_rows(out, alpha[:, None] * yy)


def _hue(img, theta):
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    i = 0.596 * r - 0.274 * g - 0.322 * b
    qq = 0.211 * r - 0.523 * g + 0.312 * b
    cos, sin = torch.cos(theta), torch.sin(theta)
    i2, q2 = cos * i - sin * qq, sin * i + cos * qq
    return torch.stack([y + 0.956 * i2 + 0.621 * q2, y - 0.272 * i2 - 0.647 * q2,
                        y - 1.106 * i2 + 1.703 * q2], dim=-1)


def augment(img, d):
    """torchvision-style stack over (N, S, S, 3) in [0, 1], slot i with draw i."""
    bc = (slice(None), None, None, None)
    img = torch.where(d["flip"][bc], img.flip(2), img)
    img = img + 0.01 * d["noise"][:, 0]
    img = rotate_translate(img, d["affine"][:, 0], d["affine"][:, 1], d["affine"][:, 2])
    img = img + 0.01 * d["noise"][:, 1]
    img = torch.where(d["gray"][bc], gray3(img), img)
    img = img + 0.01 * d["noise"][:, 2]
    f = d["jitter"][:, :, None, None, None]
    img = img * f[:, 0]
    mean = gray3(img).mean(dim=(1, 2, 3), keepdim=True)
    img = f[:, 1] * img + (1.0 - f[:, 1]) * mean
    img = f[:, 2] * img + (1.0 - f[:, 2]) * gray3(img)
    return _hue(img, (d["jitter"][:, 3] * (2.0 * math.pi))[:, None, None])


def cutouts(images, d, n_ov, n_in, power, gray_portion, size, repeats):
    """(B, H, W, 3) in [-1, 1] -> augmented cuts (B, R * n, S, S, 3) in
    [0, 1] and their weights 1 / n / R."""
    b, h, w = images.shape[:3]
    n = n_ov + n_in
    dev = images.device
    per_image = []
    for i in range(b):
        im = (images[i].float() + 1.0) / 2.0
        parts = []
        if n_ov:
            long_side = max(h, w)
            py, px = (long_side - h) // 2, (long_side - w) // 2
            wy = resize_weights(size, h, -py, long_side, py, dev)
            wx = resize_weights(size, w, -px, long_side, px, dev)
            base = torch.einsum("pw,owc->opc", wx, torch.einsum("oh,hwc->owc", wy, im))
            if n_ov <= 4:
                fl = base.flip(1)
                ov = torch.stack([base, gray3(base), fl, gray3(fl)][:n_ov])
            else:
                ov = base[None].expand((n_ov,) + base.shape)
            parts.append(ov[None].expand((repeats,) + ov.shape))
        if n_in:
            crop = d["crop"][i]
            short, lo = float(min(h, w)), float(min(h, w, size))
            sz = torch.floor(crop[..., 0] ** power * (short - lo) + lo)
            oy = torch.floor(crop[..., 1] * (h - sz + 1.0))
            ox = torch.floor(crop[..., 2] * (w - sz + 1.0))
            wy = resize_weights(size, h, oy.reshape(-1), sz.reshape(-1), 0, dev)
            wx = resize_weights(size, w, ox.reshape(-1), sz.reshape(-1), 0, dev)
            cut = torch.einsum("npw,nowc->nopc", wx, torch.einsum("noh,hwc->nowc", wy, im))
            cut = cut.reshape((repeats, n_in) + cut.shape[1:])
            n_gray = math.floor(float(np.float32(gray_portion) * np.float32(n_in)))
            grayed = (torch.arange(n_in, device=dev) <= n_gray)[None, :, None, None, None]
            parts.append(torch.where(grayed, gray3(cut), cut))
        per_image.append(torch.cat(parts, dim=1))
    cuts = torch.stack(per_image).reshape((b * repeats * n, size, size, 3))
    aug = {k: v.reshape((b * repeats * n,) + v.shape[3:]) for k, v in d.items() if k != "crop"}
    cuts = augment(cuts, aug).reshape((b, repeats * n, size, size, 3))
    return cuts, torch.full((b, repeats * n), 1.0 / n / repeats, device=dev)


# ---- losses and the step ------------------------------------------------------

def spherical_distance(x, y):
    xn = x / torch.clamp_min(torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-12)
    yn = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-12)
    chord = torch.linalg.vector_norm(xn - yn, dim=-1)
    return torch.asin(torch.clamp(chord / 2.0, -1.0, 1.0)) ** 2 * 2.0


def tv_loss(images):
    dx = images[:, :, 1:, :] - images[:, :, :-1, :]
    dy = images[:, 1:, :, :] - images[:, :-1, :, :]
    n = images.shape[1] * images.shape[2] * images.shape[3]
    return (dx.pow(2).sum(dim=(1, 2, 3)) + dy.pow(2).sum(dim=(1, 2, 3))) / n


class GuidedStep:
    """The request's step function over the reference models.

    `towers`: [(name, CLIP, text embeddings (P, D), text weights (P,))].
    Towers of one input resolution score one shared cutout batch; the
    batches are keyed 0, 1, ... in the order their resolutions first
    appear.
    `request`: the configuration file's "request" object."""

    def __init__(self, unet, towers, request: dict, device):
        self.unet, self.towers, self.r = unet, towers, request
        self.tables = ddim_tables(request["steps"], device)
        cs = request["cutout_schedules"]
        self.sched = {k: dense_schedule(*cs[k]) for k in cs}
        self.groups = {}
        for tower in towers:
            self.groups.setdefault(tower[1].cfg.image_resolution, []).append(tower)

    def gradient(self, x, step: int, draws: Draws):
        """d(loss)/dx and the raw pred_x0 at `step`."""
        r, t = self.r, self.tables
        b = x.shape[0]
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            eps = self.unet(x, t["scaled_t"][step].expand(b))[..., :3]
            pred = t["sqrt_recip"][step] * x - t["sqrt_recipm1"][step] * eps
            f = t["sqrt_1m"][step]
            denoised = pred * f + x * (1.0 - f)
            outputs = [r["denoise_scale"] * tv_loss(denoised).sum()]
            grads = [torch.ones_like(outputs[0])]
            idx = schedule_index(t, step)
            n_ov = int(self.sched["num_overview_cuts"][idx])
            n_in = int(self.sched["num_inner_cuts"][idx])
            reps = r["num_cutout_batches"]
            power = float(self.sched["inner_cut_size_power"][idx])
            gray = float(self.sched["cut_gray_portion"][idx])
            chunk = r["clip_cut_chunk"]
            for key, (size, towers) in enumerate(self.groups.items()):
                d = draws.cutouts(step, key, b, reps, size, n_ov, n_in)
                cuts, w = cutouts(denoised, d, n_ov, n_in, power, gray, size, reps)
                normed = clip_normalize(cuts)
                g_cut = torch.zeros_like(normed)
                for _, model, emb, weights in towers:
                    for i in range(0, normed.shape[1], chunk):
                        leaf = normed[:, i:i + chunk].detach().requires_grad_(True)
                        e = model.encode_image(leaf.reshape((-1,) + leaf.shape[2:]))
                        e = e.reshape(b, leaf.shape[1], -1)
                        dist = (spherical_distance(e[:, :, None, :], emb[None, None]) *
                                weights[None, None]).sum(-1)
                        loss = r["clip_guidance_scale"] * (w[:, i:i + chunk] * dist).sum()
                        (g,) = torch.autograd.grad(loss, leaf)
                        g_cut[:, i:i + chunk] += g
                outputs.append(normed)
                grads.append(g_cut)
            (grad,) = torch.autograd.grad(outputs, x, grads)
        return grad.detach(), pred.detach()

    def __call__(self, x, step: int, draws: Draws):
        """x_t -> (x_{t-1}, pred_x0 after conditioning)."""
        t, r = self.tables, self.r
        grad, pred = self.gradient(x, step, draws)
        g = -grad
        finite = torch.isfinite(g).flatten(1).all(1).reshape(-1, 1, 1, 1)
        g = torch.where(finite, g, torch.zeros_like(g))
        mag = torch.sqrt(torch.mean(g ** 2, dim=(1, 2, 3), keepdim=True))
        g = g * torch.clamp(mag, max=r["grad_threshold"]) / torch.clamp_min(mag, 1e-12)
        b = x.shape[0]
        s = torch.quantile(pred.abs().reshape(b, -1), r["dynamic_thresholding_percentile"], dim=1)
        s = torch.clamp_min(s, 1.0).reshape(b, 1, 1, 1)
        pred_thr = torch.clamp(pred, -s, s) / s
        eps = (t["sqrt_recip"][step] * x - pred_thr) / t["sqrt_recipm1"][step]
        eps = eps - t["sqrt_1m"][step] * g
        pred_final = t["sqrt_recip"][step] * x - t["sqrt_recipm1"][step] * eps
        acp, acp_prev = t["acp"][step], t["acp_prev"][step]
        sigma = r["eta"] * torch.sqrt((1 - acp_prev) / (1 - acp)) * torch.sqrt(1 - acp / acp_prev)
        x_next = pred_final * torch.sqrt(acp_prev) + \
            torch.sqrt(torch.clamp_min(1 - acp_prev - sigma ** 2, 0.0)) * eps
        if step > 0:
            x_next = x_next + sigma * draws.normal(x.shape, _STEP, step)
        return x_next, pred_final


def embed_prompt(towers_models: List, text: str, device):
    """[(name, model)] -> [(name, model, (1, D) embedding, (1,) weight)]."""
    toks = torch.from_numpy(tokenize([text])).to(device)
    out = []
    with torch.no_grad():
        for name, model in towers_models:
            out.append((name, model, model.encode_text(toks), torch.ones(1, device=device)))
    return out
