"""The port's package-level names: every public name that a ``repro``
package's ``__init__`` exports (its ``__all__``, or its public attributes
where it has none) imports from the same path under ``repro_torch``, save
the JAX-only machinery listed in ``JAX_ONLY`` with its reason.  A name may
be an attribute of the port's package or a submodule of it
(``repro.configs.flows``)."""

import importlib
import inspect
import pkgutil

import pytest

import repro

#: names of the reference's packages that the port leaves out, and why
JAX_ONLY = {
    "repro.dist.to_shardings": "maps PartitionSpecs to jax.sharding.NamedShardings; the port "
                               "stores each rank's block as a plain tensor (dist/model.py)",
    "repro.kernels.kernel_path": "chooses between a Pallas kernel and its interpret mode",
    "repro.kernels.resolve_interpret": "Pallas interpret mode off the TPU",
    "repro.kernels.use_interpret": "Pallas interpret mode off the TPU",
    "repro.utils.parse_hlo_collectives": "parses XLA's HLO text; the port counts collectives "
                                         "in dist/comm.py and utils/cost.py",
}

PACKAGES = ["repro"] + sorted(f"repro.{m.name}" for m in pkgutil.iter_modules(repro.__path__)
                              if m.ispkg)


def _public(pkg) -> list[str]:
    """The names ``pkg``'s ``__init__`` exports: ``__all__``, else its public
    attributes other than modules from outside the package."""
    names = getattr(pkg, "__all__", None)
    if names is not None:
        return list(names)
    return [n for n in dir(pkg) if not n.startswith("_") and not (
        inspect.ismodule(getattr(pkg, n))
        and not getattr(pkg, n).__name__.startswith(pkg.__name__ + "."))]


def test_the_reference_has_thirteen_packages():
    assert len(PACKAGES) == 13, PACKAGES


@pytest.mark.parametrize("name", PACKAGES)
def test_package_names_import_from_the_port(name):
    ref = importlib.import_module(name)
    port_name = "repro_torch" + name.removeprefix("repro")
    port = importlib.import_module(port_name)
    missing = []
    for attr in _public(ref):
        if f"{name}.{attr}" in JAX_ONLY:
            assert not hasattr(port, attr), f"{name}.{attr} is listed as JAX-only"
            continue
        if hasattr(port, attr):
            continue
        try:
            importlib.import_module(f"{port_name}.{attr}")
        except ModuleNotFoundError:
            missing.append(attr)
    assert not missing, f"{port_name} lacks {missing}"


@pytest.mark.parametrize("qualified", sorted(JAX_ONLY))
def test_jax_only_names_exist_in_the_reference(qualified):
    module, _, attr = qualified.rpartition(".")
    assert hasattr(importlib.import_module(module), attr), qualified


def test_train_flow_from_the_package():
    from repro_torch.train import train_flow
    from repro_torch.train.loop import train_flow as from_module

    assert train_flow is from_module
