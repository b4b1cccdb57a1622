"""PyTorch/CUDA port of clip_diffusion_tpu.

A package beside the JAX one that mirrors its module paths and public
names.  It imports neither JAX nor the JAX package.  Entry points run on
`cuda` unless the caller passes `device="cpu"`; the one TPU kernel of the
JAX package (the histogram quantile) is a hand-written CUDA kernel here
(`csrc/`, built at first use).
"""
