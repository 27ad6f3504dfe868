"""Catwalk-style top-k gradient compression with error feedback.

The paper's insight — relocate the few active elements, pay only for k —
applied to gradients: per tensor, keep the top-k-magnitude fraction of
(gradient + error buffer) entries, zero the rest, and carry the residual
forward in the error buffer (Stich et al.-style EF-SGD), in f32.

``rho`` is the kept fraction: k = max(1, int(rho * CHUNK)) entries of
each CHUNK-slice are kept (every entry >= the slice's k-th largest
magnitude, ties included), so the top-k never sorts a whole tensor —
the paper's fixed-k per-volley clip.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.optim.tree import tree_leaves, tree_map, tree_unzip

CHUNK = 2048


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    rho: float = 0.01          # kept fraction per chunk
    enabled: bool = True


class EFState(NamedTuple):
    error: Any                 # residual buffer, same structure as grads


def init_ef(params) -> EFState:
    return EFState(error=tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _topk_mask_chunked(x: torch.Tensor, rho: float) -> torch.Tensor:
    """Keep the top ``max(1, int(rho * CHUNK))`` |entries| of each
    CHUNK-slice (the last slice padded with zeros): a mask in x's dtype."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    chunks = F.pad(flat, (0, (-n) % CHUNK)).reshape(-1, CHUNK)
    k = max(1, int(rho * CHUNK))
    mags = torch.abs(chunks)
    thresh = torch.topk(mags, k, dim=-1).values[:, -1:]
    mask = (mags >= thresh).to(x.dtype)
    return mask.reshape(-1)[:n].reshape(x.shape)


def compress_grads(grads, ef: EFState, cfg: CompressionConfig, *,
                   donate: bool = False
                   ) -> Tuple[Any, EFState, Dict[str, torch.Tensor]]:
    """Returns (sparse grads in each gradient's dtype, new error state,
    {"kept_fraction": the kept share of all entries}). ``donate``: the new
    error is written into ``ef``'s buffers, which the new state holds."""
    if not cfg.enabled:
        dev = tree_leaves(grads)[0].device
        return grads, ef, {"kept_fraction": torch.ones((), device=dev)}

    def one(g, e):
        acc = g.to(torch.float32) + e
        mask = _topk_mask_chunked(acc, cfg.rho)
        sparse = acc * mask
        err = torch.sub(acc, sparse, out=e) if donate else acc - sparse
        return sparse.to(g.dtype), err, torch.mean(mask)

    sparse, err, kept = tree_unzip(tree_map(one, grads, ef.error), 3)
    # element-weighted: tiny tensors (norm scales) ride along uncompressed
    fracs = torch.stack(tree_leaves(kept))
    sizes = torch.tensor([float(g.numel()) for g in tree_leaves(grads)],
                         dtype=torch.float32, device=fracs.device)
    mean_kept = torch.sum(fracs * sizes) / torch.sum(sizes)
    return sparse, EFState(error=err), {"kept_fraction": mean_kept}
