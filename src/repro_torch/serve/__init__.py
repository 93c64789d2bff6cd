"""Serving, the port of the reference's ``repro.serve``: the LM engine
(prefill and decode over caches) and the flow engine (``log_prob``,
``sample``)."""

from repro_torch.serve.engine import FlowServeEngine, ServeEngine

__all__ = ["FlowServeEngine", "ServeEngine"]
