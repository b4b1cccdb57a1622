"""The CLIP towers' chunk graphs of `pipeline/guided._cut_gradient` on the
CPU: CPU tensors never capture and give the eager body's gradient, the key
tells apart what a graph holds fixed, the store's bookkeeping (one capture
a key, new prompts through one graph, the least recently used dropped, an
eager key remembered) with an emulated graph, and a tower drops its graphs
when its weights move.  `test_torch_cuda.py` holds the replays on the card
against the eager body."""

import dataclasses

import pytest
import torch

from clip_diffusion_tpu_torch.config import Config
from clip_diffusion_tpu_torch.guidance.losses import l2_normalize
from clip_diffusion_tpu_torch.models import from_jax
from clip_diffusion_tpu_torch.models.aesthetic import LinearAestheticPredictor
from clip_diffusion_tpu_torch.models.clip.model import CLIPModel, tiny_clip_config
from clip_diffusion_tpu_torch.pipeline import guided
from clip_diffusion_tpu_torch.zoo import host_init_state_dict


def _tower(resnet: bool = False, seed: int = 2) -> CLIPModel:
    tower = CLIPModel(tiny_clip_config(resnet=resnet))
    tower.load_state_dict(host_init_state_dict(tower, from_jax.clip_rule, seed, torch.float32))
    return tower.requires_grad_(False)


def _perceptor(tower, prompts: int = 2, seed: int = 0, head=None) -> guided.Perceptor:
    g = torch.Generator().manual_seed(seed)
    return guided.Perceptor(
        name="tiny", embed_image=tower.encode_image, input_resolution=tower.cfg.image_resolution,
        text_embeddings=torch.randn((prompts, tower.cfg.embed_dim), generator=g),
        text_weights=torch.rand((prompts,), generator=g), aesthetic_fn=head)


def _cuts(batch: int, n: int, res: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, n, res, res, 3), generator=g),
            torch.rand((batch, n), generator=g))


def _eager(perc, cfg, normed, weights):
    """The eager body, chunk by chunk, written out."""
    b, n = normed.shape[:2]
    grad = torch.zeros(normed.shape, dtype=torch.float32)
    te, tw = perc.text_embeddings, perc.text_weights
    for i in range(0, n, cfg.clip_cut_chunk):
        leaf = normed[:, i:i + cfg.clip_cut_chunk].detach().requires_grad_(True)
        c = leaf.shape[1]
        with torch.enable_grad():
            embs = perc.embed_image(leaf.reshape((-1,) + leaf.shape[2:])).reshape(b, c, -1)
            d = guided.square_spherical_distance_loss(embs[:, :, None, :], te[None, None])
            w = weights[:, i:i + cfg.clip_cut_chunk]
            loss = cfg.clip_guidance_scale * torch.sum(w * torch.sum(d * tw[None, None], -1))
            if perc.aesthetic_fn is not None and cfg.aesthetic_scale > 0:
                scores = perc.aesthetic_fn(l2_normalize(embs, dim=-1))[..., 0]
                loss = loss - cfg.aesthetic_scale * torch.sum(w * scores)
            (g,) = torch.autograd.grad(loss, leaf)
        grad[:, i:i + cfg.clip_cut_chunk] += g
    return grad


def _pipe(perc, cfg) -> guided.GuidedPipeline:
    return guided.GuidedPipeline(unet=None, perceptors=(perc,), config=cfg, sampler=None,
                                 schedule=None, device=torch.device("cpu"))


@pytest.mark.parametrize("resnet", [False, True])
def test_cpu_tensors_never_capture_and_give_the_eager_gradient(resnet):
    """On the CPU every chunk runs the eager body (2 chunks of 4 and one of
    2 cuts, a ViT and a ResNet tower, the ResNet with an aesthetic head):
    bit for bit the chunked gradient, and nothing is captured."""
    tower = _tower(resnet)
    head = LinearAestheticPredictor(tower.cfg.embed_dim).requires_grad_(False) if resnet else None
    perc = _perceptor(tower, head=head)
    cfg = Config(clip_cut_chunk=4, aesthetic_scale=2.0 if resnet else 0.0)
    normed, weights = _cuts(2, 10, tower.cfg.image_resolution)
    before = dict(guided._DEVICE_GRAPHS)
    with torch.enable_grad():
        got = guided._cut_gradient(_pipe(perc, cfg), [0], normed, weights)
    assert torch.equal(got, _eager(perc, cfg, normed, weights))
    assert not tower._graphs and guided._DEVICE_GRAPHS == before


def test_the_key_tells_apart_what_a_graph_holds_fixed():
    """Shapes, dtypes and device of the chunk and its weights, the prompts'
    shapes and dtypes, and the loss's constants with the head each give
    another key; another prompt of the same shapes gives the same key."""
    tower = _tower()
    head, other_head = LinearAestheticPredictor(64), LinearAestheticPredictor(64)
    perc = _perceptor(tower)
    cfg = Config()
    chunk, w = torch.zeros((1, 16, 32, 32, 3)), torch.zeros((1, 16))
    key = guided.tower_graph_key(perc, cfg, chunk, w)
    assert guided.tower_graph_key(_perceptor(tower, seed=5), cfg, chunk, w) == key
    variants = [
        (perc, cfg, torch.zeros((1, 8, 32, 32, 3)), torch.zeros((1, 8))),
        (perc, cfg, torch.zeros((4, 16, 32, 32, 3)), torch.zeros((4, 16))),
        (perc, cfg, chunk.to(torch.bfloat16), w),
        (perc, cfg, torch.zeros((1, 16, 32, 32, 3), device="meta"), w),
        (perc, cfg, chunk, w.to(torch.float64)),
        (_perceptor(tower, prompts=3), cfg, chunk, w),
        (dataclasses.replace(perc, text_embeddings=perc.text_embeddings[None],
                             text_weights=perc.text_weights[None]), cfg, chunk, w),
        (dataclasses.replace(perc, text_weights=perc.text_weights.double()), cfg, chunk, w),
        (perc, dataclasses.replace(cfg, clip_guidance_scale=4000.0), chunk, w),
        (perc, dataclasses.replace(cfg, aesthetic_scale=1.0), chunk, w),
        (dataclasses.replace(perc, aesthetic_fn=head),
         dataclasses.replace(cfg, aesthetic_scale=1.0), chunk, w),
        (dataclasses.replace(perc, aesthetic_fn=other_head),
         dataclasses.replace(cfg, aesthetic_scale=1.0), chunk, w),
    ]
    keys = [guided.tower_graph_key(*v) for v in variants]
    assert len(set(keys + [key])) == len(variants) + 1
    # a head the loss does not read (aesthetic_scale 0) keys nothing
    assert guided.tower_graph_key(dataclasses.replace(perc, aesthetic_fn=head), cfg, chunk,
                                  w) == key


class _Emulated:
    """A captured chunk stand-in: `replay` runs the captured body."""

    def __init__(self, run):
        self.run, self.replays = run, 0

    def replay(self):
        self.replays += 1
        self.run()


def test_the_store_captures_once_a_key_and_replays_new_prompts(monkeypatch):
    """`_replayed_gradient` with an emulated capture on the CPU: one capture
    a key, whose buffers take each call's cuts, weights and prompts (two
    prompts through one graph equal the eager body bit for bit); at most
    TOWER_GRAPHS_PER_MODEL keys, the least recently used dropped first; a
    key whose capture gave None runs eagerly and is not tried again."""
    captured = []

    def capture(perc, cfg, chunk, w):
        captured.append(guided.tower_graph_key(perc, cfg, chunk, w))
        if chunk.shape[0] == 3:
            return None
        leaf, wbuf = torch.zeros_like(chunk), torch.zeros_like(w)
        te, tw = perc.text_embeddings.clone(), perc.text_weights.clone()
        run = lambda: guided._write_back_gradient(perc, cfg, leaf, wbuf, te, tw)  # noqa: E731
        return guided._ChunkGraph(_Emulated(run), leaf, wbuf, te, tw)

    monkeypatch.setattr(guided, "_capture_chunk", capture)
    tower = _tower()
    cfg = Config(clip_cut_chunk=4)
    res = tower.cfg.image_resolution
    for seed in (0, 7):
        perc = _perceptor(tower, seed=seed)
        normed, weights = _cuts(1, 4, res, seed=seed + 1)
        got = guided._replayed_gradient(tower, perc, cfg, normed, weights).clone()
        assert torch.equal(got.float(), _eager(perc, cfg, normed, weights))
    (entry,) = tower._graphs.values()
    assert len(captured) == 1 and entry.graph.replays == 2

    perc = _perceptor(tower)
    three = _cuts(3, 4, res)
    assert guided._replayed_gradient(tower, perc, cfg, *three) is None
    assert guided._replayed_gradient(tower, perc, cfg, *three) is None
    assert len(captured) == 2
    for batch in (4, 5, 6, 7, 8, 9, 10, 11):
        guided._replayed_gradient(tower, perc, cfg, *_cuts(batch, 4, res))
    assert len(tower._graphs) == guided.TOWER_GRAPHS_PER_MODEL == 8
    assert [key[0][0] for key in tower._graphs] == [4, 5, 6, 7, 8, 9, 10, 11]


def test_a_tower_drops_its_graphs_when_its_weights_move():
    """A captured graph reads the parameters' storage: `.to()`-style moves
    and `load_state_dict` empty the tower's store."""
    tower = _tower()
    moves = (tower.float, lambda: tower.to("cpu"),
             lambda: tower.load_state_dict(tower.state_dict()),
             lambda: tower.load_state_dict(tower.state_dict(), assign=True))
    for move in moves:
        tower._graphs["key"] = "graph"
        move()
        assert not tower._graphs
