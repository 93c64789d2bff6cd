"""The port stands alone: it never loads JAX, imports nothing of the JAX
package (serving and one ``coupled`` train step of the scanned and the
unrolled GLOW, the distribution modules with a train step on a one-rank
mesh and one with int8 compression; every LM's ``REDUCED`` prefill and decode through
``ServeEngine.generate``, with whisper's frames and llava's patches;
granite-moe and llama4-maverick ``REDUCED`` trained through ``train_lm``
with a restart, and the chunked loss; whisper-small, llava-next-34b,
rwkv6-7b and zamba2-7b trained with a restart; cHINT trained through the supervised loop
with a restart, then sampled; RealNVP and the hyperbolic network trained a
step; a UQ scenario trained, restored and reported, and the launchers),
and refuses to run quietly on the CPU when no device was named."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)

PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "examples").glob("torch_*.py")))


def test_port_runs_without_loading_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from repro_torch.configs.flows import GLOW_SCANNED, build_flow\n"
        "from repro_torch.serve.engine import FlowServeEngine\n"
        "flow = build_flow(GLOW_SCANNED, device='cpu')\n"
        "lp = FlowServeEngine(flow, device='cpu').log_prob(torch.randn(1, 8, 8, 3))\n"
        "assert lp.shape == (1,) and bool(torch.isfinite(lp).all())\n"
        "from repro_torch.config import TrainConfig\n"
        "from repro_torch.data.synthetic import SyntheticImages\n"
        "from repro_torch.train.loop import train_flow\n"
        "res = train_flow(flow, SyntheticImages(8, batch=1), TrainConfig(steps=1), device='cpu')\n"
        "assert flow.grad_mode == 'coupled' and len(res.losses) == 1\n"
        "from repro_torch.configs.flows import GLOW_COUPLED\n"
        "flow = build_flow(GLOW_COUPLED, device='cpu')\n"
        "lp = FlowServeEngine(flow, device='cpu').log_prob(torch.randn(1, 8, 8, 3))\n"
        "res = train_flow(flow, SyntheticImages(8, batch=1), TrainConfig(steps=1), device='cpu')\n"
        "assert bool(torch.isfinite(lp).all()) and len(res.losses) == 1\n"
        "import repro_torch.dist, repro_torch.optim.compression, repro_torch.launch.mesh\n"
        "from repro_torch.launch.mesh import make_test_mesh\n"
        "flow = build_flow(GLOW_SCANNED, device='cpu')\n"
        "res = train_flow(flow, SyntheticImages(8, batch=1), TrainConfig(steps=1), device='cpu',\n"
        "                 mesh=make_test_mesh(1, 1))\n"
        "res = train_flow(flow, SyntheticImages(8, batch=1),\n"
        "                 TrainConfig(steps=1, grad_compression='int8'), device='cpu')\n"
        "assert len(res.losses) == 1 and res.err_state\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_lm_serving_runs_without_loading_jax():
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from repro_torch.config import get_arch\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.serve.engine import ServeEngine\n"
        "from repro_torch.config import list_archs\n"
        "from repro_torch.config import ShapeSpec\n"
        "from repro_torch.models.registry import batch_like, input_specs\n"
        "for arch in list_archs():\n"
        "    model, cfg = build_model(get_arch(arch).reduced, device='cpu')\n"
        "    n = cfg.frontend.n_patches if cfg.family == 'vlm' else 0\n"
        "    prompt = batch_like(input_specs(cfg, ShapeSpec('p', n + 8, 2, 'prefill')),\n"
        "                        torch.Generator().manual_seed(0), cfg.vocab_size)\n"
        "    tok, logits = ServeEngine(model, n + 12, device='cpu').generate(prompt, 4)\n"
        "    assert tok.shape == (2, 4) and bool(torch.isfinite(logits).all())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_lm_training_runs_without_loading_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from repro_torch.config import TrainConfig, get_arch\n"
        "from repro_torch.data import make_dataset\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.train.fault import FailureInjector\n"
        "from repro_torch.train.loop import train_lm\n"
        "for i, arch in enumerate(('granite-moe-1b-a400m', 'llama4-maverick-400b-a17b')):\n"
        "    model, cfg = build_model(get_arch(arch).reduced, device='cpu')\n"
        "    data = make_dataset('tokens', vocab=cfg.vocab_size, seq_len=16, batch=2)\n"
        f"    tcfg = TrainConfig(steps=3, checkpoint_every=1, checkpoint_dir={str(tmp_path)!r} + str(i))\n"
        "    res = train_lm(model, data, tcfg, device='cpu', injector=FailureInjector(fail_at=(2,)))\n"
        "    assert res.restarts == 1 and res.final_step == 2\n"
        "    loss, m = model.train_loss(data.batch_at(9), grad_mode='coupled')\n"
        "    loss.backward()\n"
        "    assert bool(torch.isfinite(loss)) and float(m['aux']) > 0\n"
        "import repro_torch.launch.train\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_frontends_and_ssm_training_run_without_loading_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from repro_torch.config import ShapeSpec, TrainConfig, get_arch\n"
        "from repro_torch.data import SyntheticTokens\n"
        "from repro_torch.models import build_model\n"
        "from repro_torch.models.registry import SpecBatches, batch_like, input_specs\n"
        "from repro_torch.serve.engine import ServeEngine\n"
        "from repro_torch.train.fault import FailureInjector\n"
        "from repro_torch.train.loop import train_lm\n"
        "for i, arch in enumerate(('whisper-small', 'llava-next-34b', 'rwkv6-7b', 'zamba2-7b')):\n"
        "    model, cfg = build_model(get_arch(arch).reduced, device='cpu')\n"
        "    if cfg.frontend is None:\n"
        "        data = SyntheticTokens(cfg.vocab_size, 16, 2)\n"
        "    else:\n"
        "        data = SpecBatches(cfg, ShapeSpec('t', 24, 2, 'train'))\n"
        f"    tcfg = TrainConfig(steps=3, checkpoint_every=1, checkpoint_dir={str(tmp_path)!r} + str(i))\n"
        "    res = train_lm(model, data, tcfg, device='cpu', injector=FailureInjector(fail_at=(2,)))\n"
        "    assert res.restarts == 1 and res.final_step == 2\n"
        "    if cfg.frontend is not None:\n"
        "        n = cfg.frontend.n_patches if cfg.family == 'vlm' else 0\n"
        "        prompt = batch_like(input_specs(cfg, ShapeSpec('p', n + 8, 2, 'prefill')),\n"
        "                            torch.Generator().manual_seed(1), cfg.vocab_size)\n"
        "        tok, _ = ServeEngine(model, n + 12, device='cpu').generate(prompt, 4)\n"
        "        assert tok.shape == (2, 4)\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_conditional_path_runs_without_loading_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from repro_torch.config import TrainConfig\n"
        "from repro_torch.configs.flows import CHINT_COUPLED, build_flow\n"
        "from repro_torch.core import ConditionalFlow, SummaryMLP, build_chint\n"
        "from repro_torch.data.synthetic import SyntheticInverseProblem\n"
        "from repro_torch.train.loop import train_conditional_flow\n"
        "from repro_torch.train.fault import FailureInjector\n"
        "flow = build_flow(CHINT_COUPLED, d_theta=8, d_cond=4, device='cpu')\n"
        "twin = build_chint(8, 4, kernel_inverse=True, device='cpu')\n"
        "model = ConditionalFlow(flow, SummaryMLP(6, 4, 16, device='cpu'), sample_flow=twin,\n"
        "                        device='cpu')\n"
        "data = SyntheticInverseProblem(8, 6, batch=4)\n"
        f"cfg = TrainConfig(steps=3, checkpoint_every=1, checkpoint_dir={str(tmp_path)!r})\n"
        "res = train_conditional_flow(model, data, cfg, device='cpu',\n"
        "                             injector=FailureInjector(fail_at=(2,)))\n"
        "assert res.restarts == 1 and res.final_step == 2\n"
        "x = model.sample(torch.Generator().manual_seed(0), data.batch_at(9)['y'][:1], 5, 8)\n"
        "assert x.shape == (5, 8) and bool(torch.isfinite(x).all())\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_uq_path_runs_without_loading_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "from repro_torch.configs.flows import HYPERBOLIC_DEEP, REALNVP_2D, build_flow\n"
        "from repro_torch.core import build_realnvp, value_and_grad_nll\n"
        "flow = build_realnvp(6, depth=2, hidden=8, grad_mode='coupled', kernel_training=True,\n"
        "                     device='cpu')\n"
        "loss, _ = value_and_grad_nll(flow, torch.randn(4, 6))\n"
        "loss2, _ = value_and_grad_nll(build_flow(REALNVP_2D, device='cpu'), torch.randn(4, 2))\n"
        "deep = build_flow(HYPERBOLIC_DEEP, device='cpu')\n"
        "loss3, _ = value_and_grad_nll(deep, (torch.randn(1, 8, 8, 3), torch.randn(1, 8, 8, 3)))\n"
        "assert all(bool(torch.isfinite(v)) for v in (loss, loss2, loss3))\n"
        "from repro_torch.data import make_dataset\n"
        "from repro_torch.uq import posterior_report, restore_scenario, train_scenario\n"
        f"run = train_scenario('lg-smoke', steps=3, ckpt_dir={str(tmp_path)!r}, device='cpu')\n"
        f"run = restore_scenario('lg-smoke', {str(tmp_path)!r}, device='cpu')\n"
        "stats, report = posterior_report(run, n_samples=256, chunk=128, sbc_sims=8,\n"
        "                                 sbc_draws=8)\n"
        "assert stats.n == 256 and report.ranks.shape == (8, 4)\n"
        "assert make_dataset('seismic', batch=2).batch_at(0)['y'].shape == (2, 32)\n"
        "import repro_torch.launch.serve, repro_torch.launch.train\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m == 'repro' or m.startswith('repro.') for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+repro(\.|\s|$)", text, re.M)


def test_engine_without_device_raises_on_a_host_without_a_card():
    from repro_torch.configs.flows import GLOW_COUPLED, GLOW_SCANNED, build_flow
    from repro_torch.serve.engine import FlowServeEngine

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is cuda")
    flow = build_flow(GLOW_SCANNED, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlowServeEngine(flow)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flow(GLOW_SCANNED)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_flow(GLOW_COUPLED)


def test_train_flow_without_device_raises_on_a_host_without_a_card():
    from repro_torch.config import TrainConfig
    from repro_torch.configs.flows import GLOW_SCANNED, build_flow
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.train.loop import train_flow

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is cuda")
    flow = build_flow(GLOW_SCANNED, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_flow(flow, SyntheticImages(8, batch=1), TrainConfig(steps=1))


def test_zoo_and_uq_entry_points_without_device_raise_on_a_host_without_a_card(tmp_path):
    from repro_torch.configs.flows import HYPERBOLIC_DEEP, REALNVP_2D, build_flow
    from repro_torch.core import build_hyperbolic, build_realnvp
    from repro_torch.uq import get_scenario, restore_scenario, train_scenario
    from repro_torch.uq.scenarios import build_conditional_model

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is cuda")
    for build in (lambda: build_realnvp(4), lambda: build_hyperbolic(3),
                  lambda: build_flow(REALNVP_2D), lambda: build_flow(HYPERBOLIC_DEEP),
                  lambda: build_conditional_model(get_scenario("lg-smoke")),
                  lambda: train_scenario("lg-smoke", steps=1, ckpt_dir=str(tmp_path)),
                  lambda: restore_scenario("lg-smoke", str(tmp_path))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()


def test_lm_entry_points_without_device_raise_on_a_host_without_a_card():
    from repro_torch.config import get_arch
    from repro_torch.models import Model, build_model
    from repro_torch.serve.engine import ServeEngine

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is cuda")
    cfg = get_arch("yi-6b").reduced
    from repro_torch.config import TrainConfig, list_archs
    from repro_torch.data import SyntheticTokens
    from repro_torch.train.loop import train_lm

    for arch in list_archs():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(get_arch(arch).reduced)
    whisper = Model(get_arch("whisper-small").reduced, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(whisper, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm(whisper, SyntheticTokens(cfg.vocab_size, 8, 1), TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_lm(Model(cfg, device="cpu"), SyntheticTokens(cfg.vocab_size, 8, 1),
                 TrainConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(Model(cfg, device="cpu"), 8)
