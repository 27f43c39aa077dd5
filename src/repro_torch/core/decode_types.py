"""Shared small types for engines (avoids circular imports)."""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.runtime.request import Request


@dataclasses.dataclass
class FinishedRequest:
    req: Request
    tokens: List[int]      # first token from prefill + generated tokens
