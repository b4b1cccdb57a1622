"""Seeding utilities."""

from __future__ import annotations

import secrets


def random_seed() -> int:
    """Uniform in [0, 2^32)."""
    return secrets.randbelow(2**32)


def seed_as_string() -> str:
    """The seed as a string, for clients whose integers overflow above 2^53."""
    return str(random_seed())
