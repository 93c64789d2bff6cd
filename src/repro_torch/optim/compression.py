"""Error-feedback gradient compression, the port of the reference's
``optim/compression.py``.

Two schemes, each with per-leaf error feedback (the residual a step failed
to send is added back the next step; Karimireddy et al. 2019):

* ``topk``: send exactly the ``ratio`` fraction of entries of largest
  magnitude;
* ``int8``: per-leaf symmetric quantization, scale ``max|g| / 127 + 1e-12``
  in f32, codes rounded half to even (``torch.round``, as ``jnp.round``).

Two call sites:

* :func:`compress_grads` - the local (single-process) form: compress, keep
  the residual, hand the decompressed values to the optimizer.  Nothing
  crosses a wire; it keeps one process training as a one-rank mesh would.
* :func:`compressed_allreduce` - the wire form, in the data-parallel step
  (``dist/step.py``) before any collective: each rank compresses its own
  gradient (its own residual added), only the compressed payload is
  gathered (``all_gather`` of k f32 values and k int32 indices for topk, of
  int8 codes and one f32 scale for int8) and every rank rebuilds the same
  dense sum.  No full-precision gradient is all-reduced; ``dist/comm.py``
  counts the bytes.

Gradients and residuals are ``{name: tensor}`` dicts; a residual is None for
a leaf that is not floating (integer buffers carry no gradient in the port).
"""

from __future__ import annotations

import torch

METHODS = ("none", "topk", "int8")


def compression_init(params: dict, n_shards: int | None = None) -> dict:
    """Zero f32 error-feedback accumulators for the floating parameters,
    ``None`` elsewhere.  ``n_shards`` adds a leading shard axis: under data
    parallelism the residual is per-rank state, and a checkpoint holds every
    rank's in one ``(n_shards, ...)`` leaf."""
    def zeros(v):
        if not v.is_floating_point():
            return None
        shape = tuple(v.shape) if n_shards is None else (n_shards, *v.shape)
        return torch.zeros(shape, dtype=torch.float32, device=v.device)

    return {n: zeros(v) for n, v in params.items()}


def _topk_select(flat: torch.Tensor, ratio: float):
    """Exactly-k selection by magnitude: ``(values, indices)`` of the k
    entries of largest ``|.|``, k = ``max(1, int(size * ratio))``.  A stable
    descending sort keeps the lower index first among equal magnitudes, as
    ``lax.top_k`` does, so the entries sent (and the residuals) match the
    reference under ties; a threshold mask would send more than k."""
    k = max(1, int(flat.numel() * ratio))
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    return flat[idx], idx


def _topk_leaf(g, err, ratio):
    c = g.float() + err
    flat = c.reshape(-1)
    vals, idx = _topk_select(flat, ratio)
    sent = torch.zeros_like(flat)
    sent[idx] = vals
    sent = sent.reshape(c.shape)
    return sent, c - sent


def _int8_quantize(g):
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _int8_leaf(g, err):
    c = g.float() + err
    q, scale = _int8_quantize(c)
    sent = q.float() * scale
    return sent, c - sent


def compress_grads(grads: dict, err_state: dict, method: str, ratio: float = 0.01):
    """``(compressed grads, new residuals)``; ``method``: topk | int8 | none."""
    if method == "none":
        return grads, err_state
    out_g, out_e = {}, {}
    for n, g in grads.items():
        e = err_state.get(n)
        if e is None or not g.is_floating_point():
            out_g[n], out_e[n] = g, e
        elif method == "topk":
            out_g[n], out_e[n] = _topk_leaf(g, e, ratio)
        elif method == "int8":
            out_g[n], out_e[n] = _int8_leaf(g, e)
        else:
            raise ValueError(method)
    return out_g, out_e


# ---------------------------------------------------------------------------
# the wire path (in the data-parallel step, before the collective)
# ---------------------------------------------------------------------------


def _topk_allreduce_leaf(g, err, ratio, gather):
    """Per-rank top-k with its residual, then gather and add: only k values
    and k int32 indices a rank cross the wire.  The ranks' payloads are
    added in rank order, each rank's indices distinct, so the sum is the
    same bits on every rank and every run (no colliding atomic adds)."""
    c = g.float() + err
    flat = c.reshape(-1)
    vals, idx = _topk_select(flat, ratio)
    new_err = flat.clone()
    new_err[idx] = 0.0
    all_vals = gather(vals)
    all_idx = gather(idx.to(torch.int32)).long()
    reduced = torch.zeros_like(flat)
    for r in range(all_vals.shape[0]):
        reduced[all_idx[r]] = reduced[all_idx[r]] + all_vals[r]
    return reduced.reshape(c.shape), new_err.reshape(c.shape)


def _int8_allreduce_leaf(g, err, gather):
    """Per-rank int8 codes with their residual, then gather and dequantize:
    one byte an entry and one f32 scale a rank cross the wire."""
    c = g.float() + err
    q, scale = _int8_quantize(c)
    new_err = c - q.float() * scale
    all_q = gather(q)
    all_s = gather(scale.reshape(1))
    reduced = torch.zeros_like(c)
    for r in range(all_q.shape[0]):
        reduced = reduced + all_s[r, 0] * all_q[r].float()
    return reduced, new_err


def compressed_allreduce(grads: dict, err_state: dict, method: str, axis: str,
                         ratio: float = 0.01):
    """Sum the ranks' gradients over the bound mesh's axis ``axis``
    (``comm.bound``) with only compressed bytes on the wire.  ``grads`` are
    this rank's unreduced gradients, ``err_state`` its residuals.  Returns
    ``(reduced dense grads, new residuals)``: the reduced tree is the same on
    every rank, the residuals stay per-rank.

    ``method == "none"`` is the dense ``all_reduce`` (the uncompressed
    baseline the wire-byte comparison takes).  A leaf without a residual
    (not floating) is all-reduced densely."""
    # imported here: repro_torch.dist's step imports this module
    from repro_torch.dist import comm

    group, _size = comm.axis_group(axis)

    def gather(t):
        return comm.all_gather(t, group)

    out_g, out_e = {}, {}
    for n, g in grads.items():
        e = err_state.get(n)
        if e is None or not g.is_floating_point() or method == "none":
            r = g.float().clone() if method == "none" and g.is_floating_point() else g.clone()
            comm.all_reduce(r, group)
            out_g[n], out_e[n] = r, e
        elif method == "topk":
            out_g[n], out_e[n] = _topk_allreduce_leaf(g, e, ratio, gather)
        elif method == "int8":
            out_g[n], out_e[n] = _int8_allreduce_leaf(g, e, gather)
        else:
            raise ValueError(method)
    return out_g, out_e


def decompress_and_correct(grads):
    """The receive side: the reduced values are already dense floats."""
    return grads
