"""LM losses, the port of the reference's ``models/losses.py``.  The chunked
cross-entropy never holds the whole (B, S, V) logit tensor: the sequence
is walked in chunks whose logits are recomputed in the backward
(``torch.utils.checkpoint``), so one (B, chunk, V) f32 block is live at a
time (V is 256,000 for command-r-plus)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _chunk_nll(hc, w_head, lc, logit_softcap: float):
    """One chunk's summed NLL and count of valid labels (label < 0 is
    ignored)."""
    logits = (hc @ w_head.to(hc.dtype)).float()  # (B, c, V)
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    valid = lc >= 0
    lab = logits.gather(-1, lc.clamp_min(0)[..., None].long())[..., 0]
    nll = torch.where(valid, lse - lab, torch.zeros_like(lse))
    return nll.sum(), valid.sum().float()


def chunked_softmax_xent(h: torch.Tensor, w_head: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512, logit_softcap: float = 0.0) -> torch.Tensor:
    """Mean next-token NLL of ``h`` (B, S, D) under the head ``w_head``
    (D, V) against ``labels`` (B, S), walking the sequence in chunks of
    ``chunk`` (the last padded with ignored labels, -1)."""
    b, s, d = h.shape
    chunk = min(chunk, s)
    if s % chunk:
        pad = chunk - s % chunk
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(s // chunk):
        hc, lc = h[:, c * chunk:(c + 1) * chunk], labels[:, c * chunk:(c + 1) * chunk]
        if torch.is_grad_enabled():
            nll, n = checkpoint(_chunk_nll, hc, w_head, lc, logit_softcap, use_reentrant=False)
        else:
            nll, n = _chunk_nll(hc, w_head, lc, logit_softcap)
        total, count = total + nll, count + n
    return total / count.clamp_min(1.0)
