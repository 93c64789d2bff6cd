from repro_torch.core.actnorm import ActNorm
from repro_torch.core.autodiff import (
    GRAD_MODES,
    make_chain_apply,
    make_scan_apply,
    value_and_grad_nll,
)
from repro_torch.core.chain import InvertibleChain, OnFirst, Pack, Split
from repro_torch.core.conditional import ConditionalFlow, SummaryMLP, build_chint
from repro_torch.core.conv1x1 import Conv1x1
from repro_torch.core.coupling import AffineCoupling
from repro_torch.core.distributions import (
    derive_key,
    flatten_state,
    std_normal_logpdf,
    std_normal_sample,
)
from repro_torch.core.glow import build_glow
from repro_torch.core.glow_scan import GlowStepStack, build_glow_scanned, resolve_coupled_bwd
from repro_torch.core.haar import HaarSqueeze, Squeeze
from repro_torch.core.hint import HINTCoupling
from repro_torch.core.hyperbolic import HyperbolicLayer, build_hyperbolic
from repro_torch.core.objectives import amortized_vi_loss, nll_bits_per_dim, nll_loss
from repro_torch.core.realnvp import build_realnvp
from repro_torch.core.types import Invertible, share_parameters

__all__ = [
    "ActNorm", "AffineCoupling", "ConditionalFlow", "Conv1x1", "GRAD_MODES", "GlowStepStack",
    "HINTCoupling", "HaarSqueeze", "HyperbolicLayer", "Invertible", "InvertibleChain", "OnFirst",
    "Pack", "Split", "Squeeze", "SummaryMLP", "amortized_vi_loss", "build_chint", "build_glow",
    "build_glow_scanned", "build_hyperbolic", "build_realnvp", "derive_key", "flatten_state",
    "make_chain_apply", "make_scan_apply", "nll_bits_per_dim", "nll_loss", "resolve_coupled_bwd",
    "share_parameters", "std_normal_logpdf", "std_normal_sample", "value_and_grad_nll",
]
