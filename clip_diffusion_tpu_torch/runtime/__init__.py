"""Serving in one process: the HTTP server, its per-request UNet registry
and the bootstrap that builds both."""
