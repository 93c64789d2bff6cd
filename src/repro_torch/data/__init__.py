"""Step-indexed data sources and their registry, the port of the reference's
``repro/data/__init__.py``.

Every factory returns an object whose ``batch_at(step)`` is a pure function
of ``(seed, step)``: the restart guarantee of the supervised loop.
``"tokens"`` is the LM token stream (``SyntheticTokens``), ``"images"`` GLOW's
training images.  The
operator problems of ``repro_torch.uq.operators`` register here lazily, so
importing ``repro_torch.data`` does not load the UQ layer.
"""

from repro_torch.data.synthetic import SyntheticImages, SyntheticInverseProblem, SyntheticTokens


def _operator_problem(op_name: str):
    def factory(batch: int = 256, seed: int = 0, **op_kw):
        from repro_torch.uq.operators import make_operator

        return make_operator(op_name, **op_kw).problem(batch=batch, seed=seed)

    factory.__name__ = f"{op_name}_problem"
    return factory


DATASETS = {
    "tokens": SyntheticTokens,
    "images": SyntheticImages,
    "linear_gaussian_legacy": SyntheticInverseProblem,
    # synthetic Bayesian inverse problems (repro_torch.uq.operators): each
    # yields {"theta", "y"} joint draws with an analytic posterior attached
    **{name: _operator_problem(name)
       for name in ("linear_gaussian", "blur", "mask_tomo", "seismic")},
}


def make_dataset(name: str, **kw):
    """A registered step-indexed data source by name."""
    try:
        factory = DATASETS[name]
    except KeyError:
        raise KeyError(f"unknown dataset {name!r}; registered: {sorted(DATASETS)}") from None
    return factory(**kw)


__all__ = ["DATASETS", "SyntheticImages", "SyntheticInverseProblem", "SyntheticTokens",
           "make_dataset"]
