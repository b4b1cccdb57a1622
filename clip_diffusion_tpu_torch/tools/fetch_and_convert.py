"""Fetch the public checkpoints and tokenizer assets into the port's slots.

    python3 -m clip_diffusion_tpu_torch.tools.fetch_and_convert --all
    python3 -m clip_diffusion_tpu_torch.tools.fetch_and_convert --unet --clip ViT-B/32

Counterpart of the JAX package's tools/fetch_and_convert.py, with its
artifact URLs (the reference's models.py:11-30 and the tokenizer assets)
and its switches.  Run it where there is network access.  The port reads
the public torch release files as they are published (`zoo.load_or_init`
converts each at load time), so nothing is converted here: each download
is placed where the zoo's gate looks for its slot, `<root>/<slot>.pt`
(`--root`, default `$CLIP_DIFFUSION_TORCH` or models/torch; the three LDM
slots share `ldm.pt`).  The module keeps the JAX tool's name so that a
reader finds the counterpart.  Where a slot comes from two published
files, their state dicts are merged into its one file: LPIPS from
torchvision's VGG16 and the lpips repository's lin heads, sentence-T5 from
the encoder and its 2_Dense projection.  The parts are kept under
`<root>/parts/`.  Tokenizer assets go under data/ (`--data-dir`): the CLIP
BPE table, the BERT vocabulary, the T5 SentencePiece model, MarianMT's
`source.spm` and `vocab.json` under data/marian/, and OpenCC's tw2sp phrase
table, assembled from OpenCC's dictionaries, as data/opencc/
tw2sp_phrases.tsv.  `--banks` then rebuilds data/banks from the towers
(`tools.build_banks --all`).  A file already in place is kept.
"""

from __future__ import annotations

import argparse
import os
import sys
import urllib.request

import torch

from clip_diffusion_tpu_torch.models.convert import load_torch_state_dict
from clip_diffusion_tpu_torch.zoo import torch_root

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")

# artifact -> (URL, the file it becomes: a slot under the root, a part
# under <root>/parts, or an asset under the data dir)
ARTIFACTS = {
    "unet": (
        "https://huggingface.co/lowlevelware/512x512_diffusion_unconditional_"
        "ImageNet/resolve/main/512x512_diffusion_uncond_finetune_008100.pt",
        ("slot", "guided_unet_512"),
    ),
    "ldm": (
        "https://huggingface.co/multimodalart/compvis-latent-diffusion-"
        "text2img-large/resolve/main/txt2img-f8-large-jack000-finetuned-fp16.ckpt",
        ("slot", "ldm"),
    ),
    "esrgan_x4": (
        "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.1.0/"
        "RealESRGAN_x4plus.pth",
        ("slot", "esrgan_x4"),
    ),
    "esrgan_x2": (
        "https://github.com/xinntao/Real-ESRGAN/releases/download/v0.2.1/"
        "RealESRGAN_x2plus.pth",
        ("slot", "esrgan_x2"),
    ),
    "bpe": (
        "https://github.com/openai/CLIP/raw/main/clip/bpe_simple_vocab_16e6.txt.gz",
        ("data", "bpe_simple_vocab_16e6.txt.gz"),
    ),
    "bert_vocab": (
        "https://huggingface.co/bert-base-uncased/resolve/main/vocab.txt",
        ("data", "bert-base-uncased-vocab.txt"),
    ),
    "t5_spm": (
        "https://huggingface.co/sentence-transformers/sentence-t5-base/resolve/main/spiece.model",
        ("data", "t5-spiece.model"),
    ),
    # the two files the lpips pip package assembles: torchvision's VGG16
    # backbone and the learned lin heads
    "vgg16": (
        "https://download.pytorch.org/models/vgg16-397923af.pth",
        ("part", "vgg16-397923af.pth"),
    ),
    "lpips_lin": (
        "https://github.com/richzhang/PerceptualSimilarity/raw/master/"
        "lpips/weights/v0.1/vgg.pth",
        ("part", "lpips_vgg_v0.1.pth"),
    ),
    # sentence-transformers/sentence-t5-base: the T5 encoder and the 2_Dense
    # projection
    "t5_encoder": (
        "https://huggingface.co/sentence-transformers/sentence-t5-base/resolve/main/"
        "pytorch_model.bin",
        ("part", "sentence-t5-base.bin"),
    ),
    "t5_dense": (
        "https://huggingface.co/sentence-transformers/sentence-t5-base/resolve/main/"
        "2_Dense/pytorch_model.bin",
        ("part", "sentence-t5-base-2_Dense.bin"),
    ),
    "marian": (
        "https://huggingface.co/Helsinki-NLP/opus-mt-zh-en/resolve/main/pytorch_model.bin",
        ("slot", "marian_zh_en"),
    ),
    "marian_spm": (
        "https://huggingface.co/Helsinki-NLP/opus-mt-zh-en/resolve/main/source.spm",
        ("data", os.path.join("marian", "source.spm")),
    ),
    "marian_vocab": (
        "https://huggingface.co/Helsinki-NLP/opus-mt-zh-en/resolve/main/vocab.json",
        ("data", os.path.join("marian", "vocab.json")),
    ),
}

AESTHETIC = {
    "ViT-B/32": "https://github.com/crowsonkb/simulacra-aesthetic-models/raw/master/"
                "models/sac_public_2022_06_29_vit_b_32_linear.pth",
    "ViT-B/16": "https://github.com/crowsonkb/simulacra-aesthetic-models/raw/master/"
                "models/sac_public_2022_06_29_vit_b_16_linear.pth",
    "ViT-L/14": "https://github.com/christophschuhmann/improved-aesthetic-predictor/"
                "raw/main/sac%2Blogos%2Bava1-l14-linearMSE.pth",
}

# OpenAI's CLIP releases (TorchScript archives; the gate reads their state
# dicts)
CLIP_JIT = {
    "ViT-B/32": "https://openaipublic.azureedge.net/clip/models/40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B/16": "https://openaipublic.azureedge.net/clip/models/5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L/14": "https://openaipublic.azureedge.net/clip/models/b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "RN101": "https://openaipublic.azureedge.net/clip/models/8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50": "https://openaipublic.azureedge.net/clip/models/afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
}

OPENCC_DICT_BASE = "https://raw.githubusercontent.com/BYVoid/OpenCC/master/data/dictionary/"
OPENCC_DICTS = ("TWPhrasesIT.txt", "TWPhrasesName.txt", "TWPhrasesOther.txt",
                "TWVariants.txt", "TSPhrases.txt", "TSCharacters.txt")


def _download(url: str, dest: str) -> str:
    """`url` -> `dest` (through a temporary name); a `dest` already present
    is kept."""
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    if os.path.exists(dest):
        print(f"cached: {dest}", flush=True)
        return dest
    print(f"downloading {url} -> {dest}", flush=True)
    tmp = dest + ".tmp"
    opener = urllib.request.build_opener()
    opener.addheaders = [("User-Agent", "Mozilla/5.0")]
    with opener.open(url) as src, open(tmp, "wb") as out:
        while True:
            buf = src.read(1 << 16)
            if not buf:
                break
            out.write(buf)
    os.replace(tmp, dest)
    return dest


class Fetcher:
    """Places artifacts under a weights root and a data directory."""

    def __init__(self, root: str, data_dir: str):
        self.root, self.data_dir = root, data_dir

    def slot_path(self, slot: str) -> str:
        return os.path.join(self.root, f"{slot}.pt")

    def fetch(self, name: str) -> str:
        url, (kind, rel) = ARTIFACTS[name]
        dest = {"slot": lambda: self.slot_path(rel),
                "part": lambda: os.path.join(self.root, "parts", rel),
                "data": lambda: os.path.join(self.data_dir, rel)}[kind]()
        return _download(url, dest)

    def merge(self, slot: str, parts) -> str:
        """The state dicts of the downloaded `parts` merged into the slot's
        file."""
        dest = self.slot_path(slot)
        if os.path.exists(dest):
            print(f"cached: {dest}", flush=True)
            return dest
        merged = {}
        for part in parts:
            merged.update(load_torch_state_dict(self.fetch(part)))
        tmp = dest + ".tmp"
        torch.save(merged, tmp)
        os.replace(tmp, dest)
        print(f"merged {', '.join(parts)} -> {dest}", flush=True)
        return dest

    def clip(self, name: str) -> str:
        return _download(CLIP_JIT[name], self.slot_path(f"clip_{name.replace('/', '_')}"))

    def aesthetic(self, name: str) -> str:
        return _download(AESTHETIC[name], self.slot_path(f"aesthetic_{name.replace('/', '_')}"))

    def opencc_tw2sp(self) -> str:
        """OpenCC's tw2sp phrase vocabulary as data/opencc/tw2sp_phrases.tsv
        (`text.zh.tw_to_simplified` reads it without the opencc wheel): for
        every Taiwan-variant phrase of TWPhrases{IT,Name,Other} and
        TWVariants, its mainland-simplified form, from the opencc wheel when
        importable, else by OpenCC's own data: the reverse TW mapping, then
        TSPhrases (longest first), then TSCharacters."""
        raw = os.path.join(self.data_dir, "opencc", "raw")
        paths = {n: _download(OPENCC_DICT_BASE + n, os.path.join(raw, n)) for n in OPENCC_DICTS}
        tw_to_std = {}
        for n in ("TWPhrasesIT.txt", "TWPhrasesName.txt", "TWPhrasesOther.txt", "TWVariants.txt"):
            for std, variants in _parse_opencc_dict(paths[n]):
                for v in variants:
                    tw_to_std.setdefault(v, std)
        try:
            from opencc import OpenCC  # exact when available
        except ImportError:
            to_simplified = _opencc_chain(tw_to_std, paths)
        else:
            to_simplified = OpenCC("tw2sp.json").convert
        rows = [(tw, to_simplified(tw)) for tw in sorted(tw_to_std)]
        rows = [(tw, sp) for tw, sp in rows if sp != tw]
        out = os.path.join(self.data_dir, "opencc", "tw2sp_phrases.tsv")
        with open(out, "w", encoding="utf-8") as f:
            f.write("# OpenCC tw2sp phrase vocabulary (written by "
                    "clip_diffusion_tpu_torch.tools.fetch_and_convert --opencc)\n")
            for tw, sp in rows:
                f.write(f"{tw}\t{sp}\n")
        print(f"wrote {len(rows)} tw2sp phrases -> {out}", flush=True)
        return out


def _parse_opencc_dict(path: str):
    """OpenCC dictionary format: `key<TAB>value1 value2 ...` per line."""
    entries = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2 and parts[0]:
                entries.append((parts[0], parts[1].split(" ")))
    return entries


def _opencc_chain(tw_to_std: dict, paths: dict):
    """tw -> simplified by OpenCC's data: the reverse TW mapping, then
    TSPhrases (longest match first), then TSCharacters."""
    ts_phrases = {k: vs[0] for k, vs in _parse_opencc_dict(paths["TSPhrases.txt"])}
    ts_chars = {k: vs[0] for k, vs in _parse_opencc_dict(paths["TSCharacters.txt"])}
    max_len = max(map(len, ts_phrases), default=1)

    def t2s(text: str) -> str:
        out, i = [], 0
        while i < len(text):
            for ln in range(min(max_len, len(text) - i), 1, -1):
                seg = text[i:i + ln]
                if seg in ts_phrases:
                    out.append(ts_phrases[seg])
                    i += ln
                    break
            else:
                out.append(ts_chars.get(text[i], text[i]))
                i += 1
        return "".join(out)

    return lambda tw: t2s(tw_to_std.get(tw, tw))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--all", action="store_true")
    p.add_argument("--unet", action="store_true")
    p.add_argument("--ldm", action="store_true")
    p.add_argument("--esrgan", action="store_true")
    p.add_argument("--aesthetic", action="store_true")
    p.add_argument("--lpips", action="store_true")
    p.add_argument("--vocab", action="store_true")
    p.add_argument("--marian", action="store_true")
    p.add_argument("--t5", action="store_true")
    p.add_argument("--clip", action="append", default=[])
    p.add_argument("--opencc", action="store_true",
                   help="assemble OpenCC's tw2sp phrase vocabulary as "
                        "data/opencc/tw2sp_phrases.tsv")
    p.add_argument("--banks", action="store_true",
                   help="afterwards, rebuild data/banks with the towers (build_banks --all)")
    p.add_argument("--root", default=None,
                   help="the weights root (default: $CLIP_DIFFUSION_TORCH or models/torch)")
    p.add_argument("--data-dir", default=DATA_DIR)
    p.add_argument("--cpu", action="store_true", help="(--banks) run on the CPU")
    args = p.parse_args(argv)

    f = Fetcher(torch_root(args.root), args.data_dir)
    os.makedirs(f.root, exist_ok=True)
    if args.all or args.vocab:
        for name in ("bpe", "bert_vocab", "t5_spm"):
            f.fetch(name)
    if args.all or args.unet:
        f.fetch("unet")
    if args.all or args.ldm:
        f.fetch("ldm")
    for name in (list(CLIP_JIT) if args.all else args.clip):
        f.clip(name)
    if args.all or args.esrgan:
        f.fetch("esrgan_x4")
        f.fetch("esrgan_x2")
    if args.all or args.aesthetic:
        for name in AESTHETIC:
            f.aesthetic(name)
    if args.all or args.lpips:
        f.merge("lpips_vgg", ("vgg16", "lpips_lin"))
    if args.all or args.opencc:
        f.opencc_tw2sp()
    if args.all or args.marian:
        for name in ("marian", "marian_spm", "marian_vocab"):
            f.fetch(name)
    if args.all or args.t5:
        f.merge("sentence_t5", ("t5_encoder", "t5_dense"))
    if args.all or args.banks:
        # the committed banks were built with random towers and must be
        # rebuilt from the real ones for auto-modifiers and the analyzer
        from clip_diffusion_tpu_torch.tools import build_banks

        build_banks.main(["--all", "--out", os.path.join(args.data_dir, "banks"),
                          "--csv-dir", os.path.join(args.data_dir, "csv")]
                         + (["--cpu"] if args.cpu else []))
    print("done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
