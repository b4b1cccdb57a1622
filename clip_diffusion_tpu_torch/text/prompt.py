"""Prompt front end: "text:weight" parsing.

Counterpart of `clip_diffusion_tpu.text.prompt.Prompt` for English
prompts.  Chinese input (translation) and `use_auto_modifiers=True`
(modifier retrieval) raise `NotImplementedError` until their slice of the
port.
"""

from __future__ import annotations

import re
from typing import Tuple

# CJK unified ideographs, the range the JAX package detects Chinese by
_ZH_RE = re.compile(r"[一-鿿]")


def contains_zh(text: str) -> bool:
    return bool(_ZH_RE.search(text))


class Prompt:
    """`.text` and `.weight` of a prompt; a trailing ":weight" parses as a
    float weight, defaulting to 1.0."""

    def __init__(self, prompt: str, use_auto_modifiers: bool = False,
                 num_modifiers: int = 1, modifier_bank=None):
        if not isinstance(prompt, str):
            raise TypeError("prompt has to be 'str' type")
        if contains_zh(prompt):
            raise NotImplementedError(
                "Chinese prompts (zh->en translation) are a later slice of the port"
            )
        if use_auto_modifiers:
            raise NotImplementedError(
                "use_auto_modifiers (modifier retrieval) is a later slice of the port"
            )
        self.prompt = prompt
        self.text, self.weight = self._parse_weight(prompt)

    @staticmethod
    def _parse_weight(prompt: str) -> Tuple[str, float]:
        parsed = prompt.split(":", 1)
        if len(parsed) == 1:
            return parsed[0], 1.0
        return parsed[0], float(parsed[1])
