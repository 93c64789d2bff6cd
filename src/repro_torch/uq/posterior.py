"""Streaming posterior statistics over kernel-backed amortized sampling, the
port of the reference's ``repro/uq/posterior.py``.

A high-dimensional posterior explored with 10^5+ draws never materialises:
``PosteriorEngine`` pulls fixed-size chunks of draws through the flow's
kernel-backed inverse (``ConditionalFlow.posterior_sampler`` or a
``FlowServeEngine``) on the device, copies each chunk to the host once, and
folds it into O(d) accumulators (the reference's float64 numpy host math):

* **Welford/Chan moments** - mean and variance merged chunk by chunk in
  float64 (exact up to the order of the reduction);
* **quantile sketch** - a fixed-bin streaming histogram per dimension whose
  edges are pinned by the first chunk (an approximation to about one bin
  width), feeding credible intervals at any level;
* **memory accounting** - the peak bytes held against what materialising
  every draw would have cost.

Chunk k draws its latents from ``derive_key(generator, k)``: the statistics
are a pure function of ``(generator seed, n_samples, chunk)``, so a resumed
stream reproduces.  On a mesh the sampler (a ``ConditionalFlow`` or
``FlowServeEngine`` built with ``mesh=``) draws each chunk's latents whole,
runs each rank's rows and gathers them, and the accumulators fold the
gathered chunk: the statistics agree across mesh shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.distributions import derive_key, flatten_state


class StreamingMoments:
    """Chan/Welford parallel-merge running mean and variance over (B, d)
    sample chunks; O(d) state, float64 accumulation."""

    def __init__(self):
        self.n = 0
        self._mean = None
        self._m2 = None

    def update(self, batch: np.ndarray):
        x = np.asarray(batch, np.float64)
        m = x.shape[0]
        if m == 0:
            return
        mean_b = x.mean(axis=0)
        m2_b = ((x - mean_b) ** 2).sum(axis=0)
        if self.n == 0:
            self.n, self._mean, self._m2 = m, mean_b, m2_b
            return
        delta = mean_b - self._mean
        tot = self.n + m
        self._mean = self._mean + delta * (m / tot)
        self._m2 = self._m2 + m2_b + delta**2 * (self.n * m / tot)
        self.n = tot

    @property
    def mean(self) -> np.ndarray:
        return self._mean

    def var(self, ddof: int = 1) -> np.ndarray:
        return self._m2 / max(self.n - ddof, 1)

    def std(self, ddof: int = 1) -> np.ndarray:
        return np.sqrt(self.var(ddof))


class QuantileSketch:
    """Fixed-memory per-dimension quantile estimates from a streaming
    histogram: the first chunk pins ``bins`` equal-width bin edges spanning
    its range padded by ``pad`` range-fractions a side; later chunks clip
    into the edge bins (``clipped`` counts them).  Quantiles interpolate the
    cumulative histogram linearly: accurate to about one bin width, O(bins *
    d) memory."""

    def __init__(self, bins: int = 512, pad: float = 0.25):
        self.bins = bins
        self.pad = pad
        self.n = 0
        self.clipped = 0
        self._lo = self._hi = self._counts = None

    def update(self, batch: np.ndarray):
        x = np.asarray(batch, np.float64)
        if x.shape[0] == 0:
            return
        if self._counts is None:
            lo, hi = x.min(axis=0), x.max(axis=0)
            span = np.maximum(hi - lo, 1e-12)
            self._lo = lo - self.pad * span
            self._hi = hi + self.pad * span
            self._counts = np.zeros((self.bins, x.shape[1]), np.int64)
        width = (self._hi - self._lo) / self.bins
        idx = np.floor((x - self._lo) / width).astype(np.int64)
        self.clipped += int((idx < 0).sum() + (idx >= self.bins).sum())
        idx = np.clip(idx, 0, self.bins - 1)
        # one flattened bincount over all dimensions (each dimension's
        # indices offset into its own bin range): a loop over dimensions
        # would dominate the cost at image-sized d
        d = x.shape[1]
        flat = (idx + np.arange(d)[None, :] * self.bins).ravel()
        self._counts += np.bincount(flat, minlength=self.bins * d).reshape(-1, self.bins).T
        self.n += x.shape[0]

    def quantile(self, q) -> np.ndarray:
        """(len(q), d) quantile estimates (a scalar q gives (d,))."""
        qs = np.atleast_1d(np.asarray(q, np.float64))
        cum = np.cumsum(self._counts, axis=0) / self.n  # the cdf at each bin's right edge
        edges = self._lo[None, :] + (np.arange(1, self.bins + 1)[:, None]
                                     * (self._hi - self._lo)[None, :] / self.bins)
        out = np.empty((qs.shape[0], self._counts.shape[1]))
        for d in range(out.shape[1]):
            out[:, d] = np.interp(qs, cum[:, d], edges[:, d])
        return out[0] if np.isscalar(q) else out


@dataclass
class PosteriorStats:
    """Streaming summary of a posterior: per-dimension moments, quantiles
    and credible intervals, and the memory accounting of the stream."""

    n: int
    mean: np.ndarray
    std: np.ndarray
    var: np.ndarray
    quantiles: dict  # prob -> (d,) array
    intervals: dict  # level -> (lo (d,), hi (d,)), the central credible interval
    theta_shape: tuple = ()
    peak_bytes: int = 0    # the largest chunk held on the host
    stream_bytes: int = 0  # what materialising every draw would have cost
    clipped: int = 0       # draws outside the sketch's pinned range

    def map(self, which: str = "std") -> np.ndarray:
        """An uncertainty map: a per-dimension statistic in the parameter's
        own shape (image, trace): ``"mean"``, ``"std"``, or an interval level
        such as ``0.9`` for the credible interval's width."""
        if which == "mean":
            flat = self.mean
        elif which == "std":
            flat = self.std
        else:
            lo, hi = self.intervals[float(which)]
            flat = hi - lo
        return flat.reshape(self.theta_shape) if self.theta_shape else flat

    def summary(self) -> str:
        lines = [
            f"posterior stats over n={self.n} draws "
            f"(peak host bytes {self.peak_bytes:,} vs materialized "
            f"{self.stream_bytes:,} — x{self.stream_bytes / max(self.peak_bytes, 1):.0f} saved)",
            f"  mean  in [{self.mean.min():+.3f}, {self.mean.max():+.3f}]",
            f"  std   in [{self.std.min():.3f}, {self.std.max():.3f}]",
        ]
        for lvl, (lo, hi) in sorted(self.intervals.items()):
            lines.append(f"  {int(lvl * 100)}% credible width mean {float(np.mean(hi - lo)):.3f}")
        if self.clipped:
            lines.append(f"  (quantile sketch clipped {self.clipped} samples)")
        return "\n".join(lines)


class PosteriorEngine:
    """Streaming posterior statistics for one observation.

    Wraps either a trained ``ConditionalFlow`` (pass the observation ``y``,
    one row, and ``theta_dim``) or a ``FlowServeEngine`` (pass ``cond``,
    already summarised, or none, and ``theta_dim`` or ``theta_like``, a
    latent prototype of one draw: a tensor or a multiscale tuple, only its
    shapes and dtypes are read), and accumulates moments, quantile sketches
    and credible intervals over fixed-size chunks of draws made on the
    model's device, so the posterior never materialises.  ``theta_shape``
    restores the map geometry of the flattened parameter (inferred from a
    single-tensor ``theta_like``).
    """

    def __init__(self, model, *, y=None, cond=None, theta_dim: int | None = None,
                 theta_like=None, theta_shape: tuple | None = None):
        from repro_torch.serve.engine import FlowServeEngine

        if isinstance(model, FlowServeEngine):
            proto = theta_like
            if proto is None:
                if theta_dim is None:
                    raise ValueError("FlowServeEngine needs theta_dim or theta_like")
                proto = torch.empty((1, theta_dim), device="meta")
            self._sampler = _serve_sampler(model, proto, cond)
        else:
            if y is None or theta_dim is None:
                raise ValueError("ConditionalFlow needs y and theta_dim")
            if y.shape[0] != 1:
                # draw(g, m) returns m rows per observation: a multi-row y
                # would pool different posteriors into one statistic (and
                # multiply the draw count)
                raise ValueError(
                    "PosteriorEngine summarizes ONE observation; got y with leading extent "
                    f"{y.shape[0]}; loop over observations (one engine each) instead")
            self._sampler = model.posterior_sampler(y, theta_dim=theta_dim)
        if theta_shape is not None:
            self._theta_shape = tuple(theta_shape)
        else:
            # only a single-tensor prototype reveals the map geometry (a
            # multiscale tuple flattens into data space: pass theta_shape)
            self._theta_shape = (tuple(theta_like.shape[1:])
                                 if isinstance(theta_like, torch.Tensor) else ())

    def sample_chunks(self, generator: torch.Generator, n_samples: int, chunk: int = 4096):
        """Yield (n_chunk, d) float32 host arrays of flattened draws; chunk
        ``k`` comes from ``derive_key(generator, k)`` (a resumed stream
        reproduces), drawn on the device and copied to the host once."""
        done = k = 0
        while done < n_samples:
            m = min(chunk, n_samples - done)
            yield flatten_state(self._sampler(derive_key(generator, k), m)).cpu().numpy()
            done += m
            k += 1

    def run(self, generator: torch.Generator, n_samples: int = 100_000, chunk: int = 4096,
            probs=(0.05, 0.25, 0.5, 0.75, 0.95), levels=(0.9,),
            sketch_bins: int = 512) -> PosteriorStats:
        """Accumulate ``n_samples`` draws into streaming statistics.  Memory
        held at any instant: one chunk and the O(d) accumulators."""
        moments = StreamingMoments()
        sketch = QuantileSketch(bins=sketch_bins)
        peak = total = 0
        for flat in self.sample_chunks(generator, n_samples, chunk):
            moments.update(flat)
            sketch.update(flat)
            peak = max(peak, flat.nbytes)
            total += flat.nbytes
        probs = tuple(float(p) for p in probs)
        qarr = sketch.quantile(np.asarray(probs))
        intervals = {}
        for lvl in levels:
            lo_hi = sketch.quantile(np.asarray([(1 - lvl) / 2, 1 - (1 - lvl) / 2]))
            intervals[float(lvl)] = (lo_hi[0], lo_hi[1])
        return PosteriorStats(
            n=moments.n, mean=moments.mean, std=moments.std(), var=moments.var(),
            quantiles={p: qarr[i] for i, p in enumerate(probs)}, intervals=intervals,
            theta_shape=self._theta_shape, peak_bytes=peak, stream_bytes=total,
            clipped=sketch.clipped,
        )


def _serve_sampler(engine, proto, cond):
    """``(generator, n) -> draws`` through a ``FlowServeEngine``: the latent
    prototype's batch axis resized to n, ``cond`` repeated alongside.  A
    one-observation ``cond`` repeats to any chunk size; several observations
    need n divisible by their count (a chunk would otherwise mix them
    unevenly)."""

    def resized(v, n):
        return torch.empty((n, *v.shape[1:]), dtype=v.dtype, device="meta")

    def draw(generator, n: int):
        like = (tuple(resized(v, n) for v in proto) if isinstance(proto, (tuple, list))
                else resized(proto, n))
        c = None
        if cond is not None:
            n_obs = cond.shape[0]
            if n % n_obs:
                raise ValueError(
                    f"chunk of {n} draws does not divide evenly over {n_obs} observations; use "
                    "a single-observation cond or a chunk size that is a multiple of the "
                    "observation count")
            c = cond.repeat_interleave(n // n_obs, dim=0)
        return engine.sample(generator, like, c)

    return draw
