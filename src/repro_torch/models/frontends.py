"""Modality frontends for the vision and audio configs — stubs, as in the
reference (``repro.models.frontends``).

The backbone takes precomputed patch or frame embeddings (B, S, d_model).
These stubs make them from a small linear projection of synthetic patches
or frames, the entry point a real CLIP or conv frontend would use.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.models.layers import dense_init_

PATCH_DIM = 64     # stub "pixel patch" / "mel frame" feature size


@torch.no_grad()
def init_frontend(generator: torch.Generator, d_model: int, dtype,
                  device="cuda"):
    """{"proj": (PATCH_DIM, d_model)}, 1/sqrt(PATCH_DIM) normal, drawn from
    ``generator`` on ``device``."""
    proj = torch.empty((PATCH_DIM, d_model), dtype=dtype,
                       device=resolve_device(device))
    dense_init_(proj, generator, PATCH_DIM)
    return {"proj": proj}


def embed_patches(params, patches):
    """patches: (B, S, PATCH_DIM) -> (B, S, D)."""
    return patches @ params["proj"]


def synthetic_patches(generator: torch.Generator, batch: int, seq: int,
                      dtype=torch.bfloat16):
    """(batch, seq, PATCH_DIM) standard normal patches, drawn in float32
    from ``generator`` on its device, then cast."""
    return torch.randn((batch, seq, PATCH_DIM), generator=generator,
                       dtype=torch.float32,
                       device=generator.device).to(dtype)
