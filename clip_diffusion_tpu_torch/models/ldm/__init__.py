"""The latent-diffusion stack: the cross-attention UNet, the VQ-f8 first
stage and the BERT text encoder."""
