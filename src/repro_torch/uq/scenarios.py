"""Named UQ scenarios: operator x flow configuration x training recipe, the
port of the reference's ``repro/uq/scenarios.py``.

A scenario is everything needed to reproduce one uncertainty-quantification
workflow end to end: the forward operator, the flow (cHINT for conditional
posteriors, ``GLOW_COUPLED`` / ``GLOW_SCANNED`` for image priors) and the
training recipe.  The launchers run them::

    PYTHONPATH=src python -m repro_torch.launch.train --scenario lg-smoke --ckpt ckpt/uq
    PYTHONPATH=src python -m repro_torch.launch.serve --scenario lg-smoke --ckpt ckpt/uq

Two kinds:

* **conditional** (``operator`` set): amortized posterior inference, a
  conditional HINT flow and summary net trained on the operator's simulated
  ``(theta, y)`` stream, then ``PosteriorEngine`` statistics and the
  SBC/coverage calibration report;
* **prior** (``operator`` None): an unconditional image flow trained on
  ``SyntheticImages``, served as streamed sample statistics.

Everything runs on ``device`` (``cuda`` unless named).  ``mesh=``
(``launch/mesh.py``; one process per rank) shards training batches and the
sampled chunks over the ranks' data axes, as the reference's does; on a
``model`` axis more than 1 the training stores each parameter as the ranks'
blocks (``train/loop.py``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

from repro_torch.config import TrainConfig
from repro_torch.configs.flows import (
    CHINT_COUPLED,
    CHINT_POSTERIOR,
    GLOW_COUPLED,
    GLOW_SCANNED,
    FlowConfig,
    build_flow,
)
from repro_torch.core.types import resolve_device


@dataclass(frozen=True)
class UQScenario:
    name: str
    # conditional scenarios: a registered repro_torch.uq.operators name (and
    # its keyword arguments); prior scenarios: None (SyntheticImages)
    operator: Optional[str]
    flow: FlowConfig
    operator_kw: tuple = ()           # sorted (key, value) pairs
    recursion: int = 2                # cHINT recursion depth
    summary_dim: int = 32
    summary_hidden: int = 64
    image_size: int = 16              # prior scenarios
    # training recipe
    steps: int = 300
    lr: float = 2e-3
    batch: int = 256
    # serving and calibration defaults
    n_posterior: int = 20_000
    chunk: int = 2048
    sbc_sims: int = 128
    sbc_draws: int = 64
    note: str = ""

    @property
    def conditional(self) -> bool:
        return self.operator is not None

    def make_operator(self):
        from repro_torch.uq.operators import make_operator

        return make_operator(self.operator, **dict(self.operator_kw))

    def make_problem(self, seed: int = 0):
        return self.make_operator().problem(batch=self.batch, seed=seed)


def _kw(**kw) -> tuple:
    return tuple(sorted(kw.items()))


SCENARIOS = {
    s.name: s
    for s in (
        # the tiny end-to-end pipeline: trains in seconds on a CPU, a loose
        # posterior, but train -> stream -> calibrate all run
        UQScenario(
            name="lg-smoke", operator="linear_gaussian",
            operator_kw=_kw(d_theta=4, d_y=8, sigma=0.5),
            flow=dataclasses.replace(CHINT_COUPLED, depth=2, hidden=32),
            recursion=1, summary_dim=16, summary_hidden=32,
            steps=50, batch=128, n_posterior=4096, chunk=1024, sbc_sims=64, sbc_draws=64,
            note="CI smoke: 50-step train + SBC on 64 draws",
        ),
        # the reference problem: an analytic posterior to check against
        UQScenario(
            name="lg-posterior", operator="linear_gaussian",
            operator_kw=_kw(d_theta=8, d_y=16, sigma=0.5),
            flow=dataclasses.replace(CHINT_COUPLED, depth=3, hidden=64),
            recursion=2, summary_dim=32, summary_hidden=64, steps=600, batch=256,
            note="linear-Gaussian amortized posterior vs analytic",
        ),
        # the same problem on the generic invertible engine (no fused hooks)
        UQScenario(
            name="lg-posterior-invertible", operator="linear_gaussian",
            operator_kw=_kw(d_theta=8, d_y=16, sigma=0.5),
            flow=dataclasses.replace(CHINT_POSTERIOR, depth=3, hidden=64),
            recursion=2, summary_dim=32, summary_hidden=64, steps=600, batch=256,
            note="grad_mode=invertible twin of lg-posterior",
        ),
        UQScenario(
            name="deconv-blur", operator="blur",
            operator_kw=_kw(size=16, width=1.5, sigma=0.05),
            flow=dataclasses.replace(CHINT_COUPLED, depth=4, hidden=64),
            recursion=2, summary_dim=32, summary_hidden=64, steps=800, batch=256,
            note="1-D Gaussian deconvolution (smooth ill-posed operator)",
        ),
        UQScenario(
            name="tomo-mask", operator="mask_tomo",
            operator_kw=_kw(d_theta=16, n_meas=24, keep=0.4, sigma=0.1),
            flow=dataclasses.replace(CHINT_COUPLED, depth=4, hidden=96),
            recursion=2, summary_dim=48, summary_hidden=96, steps=800, batch=256,
            note="randomized-mask tomography (sparse-view stand-in)",
        ),
        UQScenario(
            name="seismic-uq", operator="seismic",
            operator_kw=_kw(size=32, f0=0.15, sigma=0.02),
            flow=dataclasses.replace(CHINT_COUPLED, depth=4, hidden=128),
            recursion=2, summary_dim=64, summary_hidden=128, steps=1000, batch=256,
            note="band-limited seismic trace inversion with credible maps",
        ),
        # learned image priors on the two GLOW builds
        UQScenario(
            name="images-prior-scanned", operator=None, flow=GLOW_SCANNED,
            image_size=16, steps=300, batch=8,
            note="scanned GLOW image prior (the flow-step kernels)",
        ),
        UQScenario(
            name="images-prior-coupled", operator=None,
            flow=dataclasses.replace(GLOW_COUPLED, k_steps=4),
            image_size=16, steps=300, batch=8,
            note="unrolled coupled GLOW image prior (the coupling row ops)",
        ),
    )
}


def get_scenario(name: str) -> UQScenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; registered: {sorted(SCENARIOS)}") from None


def _scenario(name_or_sc) -> UQScenario:
    return get_scenario(name_or_sc) if isinstance(name_or_sc, str) else name_or_sc


@dataclass
class ScenarioRun:
    """A trained scenario: what serving and calibration need.  ``params`` is
    the model's ``state_dict()`` (the model holds its parameters)."""

    scenario: UQScenario
    model: Any          # ConditionalFlow (conditional) or InvertibleChain (prior)
    params: Any
    problem: Any = None  # OperatorProblem (conditional scenarios)
    result: Any = None   # TrainResult


def build_conditional_model(sc: UQScenario, *, generator: torch.Generator | None = None,
                            device=None, mesh=None):
    """The scenario's ``ConditionalFlow``: the cHINT flow on the scenario's
    ``grad_mode`` over the operator's ``d_theta``, its ``kernel_inverse=True``
    sampling twin (the fused coupling inverse), and a ``SummaryMLP`` from
    ``d_y`` to ``summary_dim``.  The flow's and then the summary's
    parameters are drawn from ``generator`` on the CPU.  ``mesh``: its
    ``log_prob`` and sampling run each rank's rows."""
    from repro_torch.core import ConditionalFlow, SummaryMLP, build_chint

    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(0)
    op, cfg = sc.make_operator(), sc.flow
    kw = dict(depth=cfg.depth, recursion=sc.recursion, hidden=cfg.hidden, device="cpu")
    flow = build_chint(op.d_theta, sc.summary_dim, grad_mode=cfg.grad_mode, generator=gen, **kw)
    summary = SummaryMLP(op.d_y, sc.summary_dim, sc.summary_hidden, generator=gen, device="cpu")
    # the twin's own draws are replaced by the flow's parameters
    twin = build_chint(op.d_theta, sc.summary_dim, kernel_inverse=True, **kw)
    return ConditionalFlow(flow, summary, sample_flow=twin, device=dev, mesh=mesh)


def train_scenario(name_or_sc, *, steps: int | None = None, mesh=None,
                   ckpt_dir: str = "checkpoints/uq", seed: int = 0, model=None, problem=None,
                   device=None) -> ScenarioRun:
    """Train a scenario through the supervised loop on ``device``, with
    checkpoints in ``ckpt_dir`` (``restore_scenario`` reads them; a run that
    finds them resumes).  ``seed`` seeds the data stream and the initial
    parameters, unless the caller passes ``model`` (built by
    :func:`build_conditional_model` or ``build_flow`` for the scenario, with
    parameters of its own) or, for a conditional scenario, ``problem`` (an
    ``OperatorProblem`` of the scenario's widths: another operator matrix or
    batch stream).  ``mesh``: a data-parallel mesh splits each batch over
    the ranks (``train_flow`` / ``train_conditional_flow``)."""
    from repro_torch.train.loop import train_conditional_flow, train_flow

    sc = _scenario(name_or_sc)
    dev = resolve_device(device)
    n = steps or sc.steps
    cfg = TrainConfig(steps=n, lr=sc.lr, warmup_steps=max(n // 20, 2),
                      checkpoint_every=max(n // 4, 10), checkpoint_dir=ckpt_dir, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    if sc.conditional:
        problem = problem if problem is not None else sc.make_problem(seed=seed)
        model = model if model is not None else build_conditional_model(
            sc, generator=gen, device=dev, mesh=mesh)
        res = train_conditional_flow(model, problem, cfg, device=dev, mesh=mesh)
        return ScenarioRun(sc, model, res.params, problem=problem, result=res)
    from repro_torch.data.synthetic import SyntheticImages

    flow = model if model is not None else build_flow(sc.flow, generator=gen, device=dev)
    data = SyntheticImages(size=sc.image_size, batch=sc.batch, seed=seed)
    res = train_flow(flow, data, cfg, device=dev, mesh=mesh)
    return ScenarioRun(sc, flow, res.params, result=res)


def restore_scenario(name_or_sc, ckpt_dir: str, mesh=None, device=None) -> ScenarioRun:
    """Rebuild a scenario's model on ``device`` and load its latest
    checkpoint's parameters (``mesh``: the conditional model's sampling runs
    each rank's rows)."""
    from repro_torch.optim import adamw_init
    from repro_torch.train import checkpoint as ckpt

    sc = _scenario(name_or_sc)
    dev = resolve_device(device)
    if sc.conditional:
        problem = sc.make_problem()
        model = build_conditional_model(sc, device=dev, mesh=mesh)
    else:
        problem, model = None, build_flow(sc.flow, device=dev)
    like = {"params": model.state_dict(), "opt": adamw_init(dict(model.named_parameters()))}
    state, _step = ckpt.restore(like, ckpt_dir, mesh=mesh)
    model.load_state_dict(state["params"])
    return ScenarioRun(sc, model, model.state_dict(), problem=problem)


def prior_latent_like(sc: UQScenario, n: int = 1) -> tuple:
    """The latent state of ``n`` images of a prior scenario's GLOW, as
    ``meta`` tensors (shapes only): per scale a squeeze (H and W halved, C
    four times) and, but after the last, a split of half the channels into
    the carried tuple, which ends ``(x, z_1, ..., z_{S-1})``."""
    h, c, zs = sc.image_size, 3, []
    for scale in range(sc.flow.n_scales):
        h, c = h // 2, c * 4
        if scale != sc.flow.n_scales - 1:
            zs.append((n, h, h, c - c // 2))
            c //= 2
    return tuple(torch.empty(shape, device="meta") for shape in [(n, h, h, c), *zs])


def prior_report(run: ScenarioRun, *, generator: torch.Generator | None = None,
                 n_samples: int = 2048, chunk: int | None = None, mesh=None):
    """Streamed sample statistics of a trained prior scenario, the image
    prior's counterpart of :func:`posterior_report`: ``n_samples`` images
    drawn through a ``FlowServeEngine`` in chunks of ``chunk`` (16 training
    batches by default), the maps in the images' (H, W, 3).  The unrolled
    GLOW samples through its ``kernel_inverse=True`` twin (the fused
    coupling inverse), the scanned one through its flow-step kernels.
    ``mesh``: each chunk's rows split over the ranks, the samples gathered
    before they are folded.  Returns ``PosteriorStats``."""
    from repro_torch.core import build_glow, share_parameters
    from repro_torch.serve.engine import FlowServeEngine
    from repro_torch.uq.posterior import PosteriorEngine

    sc = run.scenario
    if sc.conditional:
        raise ValueError(f"scenario {sc.name!r} is conditional: use posterior_report")
    dev = next(run.model.parameters()).device
    twin = None
    if sc.flow.kind == "glow":
        twin = share_parameters(build_glow(n_scales=sc.flow.n_scales, k_steps=sc.flow.k_steps,
                                           hidden=sc.flow.hidden, kernel_inverse=True,
                                           device=dev), run.model)
    engine = FlowServeEngine(run.model, device=dev, sample_flow=twin, mesh=mesh)
    size = sc.image_size
    return PosteriorEngine(engine, theta_like=prior_latent_like(sc),
                           theta_shape=(size, size, 3)).run(
        torch.Generator().manual_seed(0) if generator is None else generator,
        n_samples=n_samples, chunk=chunk or sc.batch * 16)


def posterior_report(run: ScenarioRun, *, y_obs=None, generator: torch.Generator | None = None,
                     n_samples: int | None = None, chunk: int | None = None,
                     calibration: bool = True, sbc_sims: int | None = None,
                     sbc_draws: int | None = None):
    """Streaming posterior statistics, and the calibration report unless
    ``calibration`` is off, for a trained conditional scenario: the paper's
    train -> posterior -> uncertainty map -> calibration workflow in one
    call.  Returns ``(PosteriorStats, CalibrationReport or None)``."""
    from repro_torch.core.distributions import derive_key
    from repro_torch.uq.calibration import calibrate
    from repro_torch.uq.posterior import PosteriorEngine

    sc = run.scenario
    if not sc.conditional:
        raise ValueError(f"scenario {sc.name!r} has no posterior (prior flow)")
    generator = torch.Generator().manual_seed(0) if generator is None else generator
    if y_obs is None:
        # a held-out observation, far outside the training steps
        y_obs = run.problem.batch_at(10_000)["y"][:1]
    d_theta = run.problem.d_theta
    engine = PosteriorEngine(run.model, y=y_obs, theta_dim=d_theta)
    stats = engine.run(generator, n_samples=n_samples or sc.n_posterior, chunk=chunk or sc.chunk)
    report = None
    if calibration:
        report = calibrate(lambda g, y, n: run.model.sample(g, y, n, d_theta),
                           run.problem.op.simulate, derive_key(generator, 1),
                           n_sims=sbc_sims or sc.sbc_sims, n_draws=sbc_draws or sc.sbc_draws)
    return stats, report
