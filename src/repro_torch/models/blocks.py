"""Block pieces shared by every block kind.  The port's paged path
composes its one block kind (ATTN) in ``model._paged_attn_block``; the
per-kind init/apply dispatch of the reference comes with the dense and
recurrent backends slice."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """RMSNorm with the statistics in f32, cast back to x's dtype
    before the weight, as the reference does."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w
