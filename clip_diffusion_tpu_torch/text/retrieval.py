"""Embedding retrieval: exact inner-product top-k over a small bank.

Counterpart of `clip_diffusion_tpu.text.retrieval`, which replaces faiss's
flat inner-product index for the modifier, style and media banks (at most
a few hundred rows of 768).  Here the bank is a float32 tensor on an
explicit device and a search is one `queries @ bank.T` and `torch.topk`.
The JAX package computes the same product on the host (numpy, or its C++
`runtime/native/ipindex.cc`), outside any Pallas kernel; the port needs no
native library for it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from clip_diffusion_tpu_torch.utils.device import resolve_device


class EmbeddingIndex:
    """Exact inner-product top-k over a (N, D) embedding matrix held on
    `device` (default `cuda`)."""

    def __init__(self, embeddings, device=None):
        self.device = resolve_device(device)
        self.embeddings = torch.as_tensor(embeddings, dtype=torch.float32,
                                          device=self.device).contiguous()

    @staticmethod
    def from_npy(path: str, device=None) -> "EmbeddingIndex":
        return EmbeddingIndex(np.load(path), device)

    @torch.no_grad()
    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(Q, D) or (D,) queries -> (scores (Q, k) float32, indices (Q, k)
        int64) as numpy, best first; `k` is clamped to the bank's size (the
        faiss `index.search` signature)."""
        q = torch.as_tensor(queries, dtype=torch.float32, device=self.device)
        if q.ndim == 1:
            q = q[None]
        k = min(k, self.embeddings.shape[0])
        top = torch.topk(q @ self.embeddings.T, k, dim=1)
        return top.values.cpu().numpy(), top.indices.cpu().numpy().astype(np.int64)


def build_embedding_index(embeddings, save_path: Optional[str] = None,
                          device=None) -> EmbeddingIndex:
    """An index over `embeddings`; with `save_path`, the float32 matrix is
    also saved there as .npy."""
    index = EmbeddingIndex(embeddings, device)
    if save_path:
        np.save(save_path, index.embeddings.cpu().numpy())
    return index
