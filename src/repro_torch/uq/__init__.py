"""Uncertainty quantification, the paper's application layer, on one device:
amortized posterior inference over synthetic inverse problems (operators),
streaming posterior statistics that never materialise the sample cloud
(posterior), simulation-based calibration (calibration), and the named
end-to-end scenarios the launchers run (scenarios)."""

from repro_torch.uq.calibration import (
    CalibrationReport,
    analytic_posterior_sampler,
    calibrate,
    chi2_sf,
    coverage_curve,
    rank_histogram,
    sbc_ranks,
    uniformity_pvalues,
)
from repro_torch.uq.operators import (
    OPERATORS,
    BlurOperator,
    ForwardOperator,
    LinearGaussianOperator,
    MaskTomographyOperator,
    OperatorProblem,
    SeismicConvOperator,
    make_operator,
)
from repro_torch.uq.posterior import (
    PosteriorEngine,
    PosteriorStats,
    QuantileSketch,
    StreamingMoments,
)
from repro_torch.uq.scenarios import (
    SCENARIOS,
    ScenarioRun,
    UQScenario,
    get_scenario,
    posterior_report,
    prior_report,
    restore_scenario,
    train_scenario,
)

__all__ = [
    "OPERATORS", "SCENARIOS",
    "BlurOperator", "CalibrationReport", "ForwardOperator",
    "LinearGaussianOperator", "MaskTomographyOperator", "OperatorProblem",
    "PosteriorEngine", "PosteriorStats", "QuantileSketch", "ScenarioRun",
    "SeismicConvOperator", "StreamingMoments", "UQScenario",
    "analytic_posterior_sampler", "calibrate", "chi2_sf", "coverage_curve",
    "get_scenario", "make_operator", "posterior_report", "prior_report", "rank_histogram",
    "restore_scenario", "sbc_ranks", "train_scenario", "uniformity_pvalues",
]
