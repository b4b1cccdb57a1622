"""Seeding utilities."""

from __future__ import annotations

import secrets


def random_seed() -> int:
    """Uniform in [0, 2^32)."""
    return secrets.randbelow(2**32)
