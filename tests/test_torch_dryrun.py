"""The port's dry run (``repro_torch/launch/dryrun.py``) against the
reference's: the variant tokens, the shapes and the skip rule; every full
architecture's parameter count built on the meta device; the argument bytes
of reduced cells on a (2, 2) mesh against XLA's ``memory_analysis`` on four
forged devices; trip scaling; the kernels' meta routes; every reduced cell
of the grid; and the command line.

The reference's dry run sets ``XLA_FLAGS`` when it is imported, so it is
only ever imported in a subprocess (as ``tests/test_distributed.py`` runs
its meshes)."""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import pytest
import torch

from repro.models.lm import Model as JModel
from repro_torch.config import SHAPES, ShapeSpec, get_arch, list_archs, supports_shape
from repro_torch.configs import ASSIGNED_ARCHS
from repro_torch.kernels.rwkv.ops import rwkv6_wkv, wkv_cost
from repro_torch.kernels.ssd.ops import mamba2_ssd, ssd_cost
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec
from repro_torch.utils import cost
from repro_torch.utils.tree import param_count
from torch_lm_parity import configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
torch.set_num_threads(2)


def _run(code: str, devices: int = 1) -> dict:
    """The reference in a subprocess with ``devices`` forged host devices;
    returns the JSON its last line prints."""
    env = {**os.environ, "PYTHONPATH": os.path.join(REPO, "src"), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"}
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], capture_output=True,
                         text=True, env=env, timeout=600)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr[-4000:]}"
    return json.loads(out.stdout.strip().splitlines()[-1])


TOKENS_TRIED = ["", *dryrun.VARIANT_TOKENS, "coupled-bf16res", "zero1-fsdp",
                "standard-attnseq-servefix", "wkvchunk-zero1"]


def test_variants_shapes_and_skip_rules_match_the_reference():
    ref = _run(f"""
        import dataclasses, json
        from repro.launch.dryrun import VARIANT_TOKENS, parse_variant
        from repro.config import SHAPES, get_arch, supports_shape
        from repro.configs import ASSIGNED_ARCHS
        out = {{"tokens": list(VARIANT_TOKENS),
               "variants": {{v: parse_variant(v) for v in {TOKENS_TRIED!r}}},
               "shapes": {{k: dataclasses.astuple(s) for k, s in SHAPES.items()}},
               "archs": list(ASSIGNED_ARCHS),
               "supports": {{a: {{s: supports_shape(get_arch(a).config, SHAPES[s])
                               for s in SHAPES}} for a in ASSIGNED_ARCHS}}}}
        print(json.dumps(out))
    """)
    assert list(dryrun.VARIANT_TOKENS) == ref["tokens"]
    for v in TOKENS_TRIED:
        assert dryrun.parse_variant(v) == ref["variants"][v], v
    with pytest.raises(ValueError):
        dryrun.parse_variant("zero2")
    assert {k: [s.name, s.seq_len, s.global_batch, s.kind] for k, s in SHAPES.items()} \
        == ref["shapes"]
    assert list(ASSIGNED_ARCHS) == ref["archs"] and sorted(ASSIGNED_ARCHS) == list_archs()
    for arch in ASSIGNED_ARCHS:
        got = {s: supports_shape(get_arch(arch).config, SHAPES[s]) for s in SHAPES}
        assert got == ref["supports"][arch], arch


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_full_architecture_on_meta_has_the_reference_parameter_count(arch):
    cfg = get_arch(arch).config
    model = dryrun.meta_model(cfg)
    params = list(model.parameters())
    assert all(p.device.type == "meta" for p in params)
    jmod, _ = configs(arch)
    shapes = jax.eval_shape(JModel(jmod.CONFIG).init, jax.random.PRNGKey(0))
    ref = sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(shapes))
    assert param_count(params) == ref


#: the reduced cells held to XLA: (arch, kind, variant)
XLA_CELLS = [("yi-6b", "train", ""), ("yi-6b", "train", "zero1-fsdp"),
             ("granite-moe-1b-a400m", "train", ""),
             ("granite-moe-1b-a400m", "train", "zero1-fsdp"),
             ("zamba2-7b", "decode", "servefix")]


@pytest.fixture(scope="module")
def xla_argument_bytes():
    """The reference's ``compiled.memory_analysis().argument_size_in_bytes``
    of each of ``XLA_CELLS`` (f32 ``REDUCED``, 32 positions, batch 4) on a
    (2, 2) mesh of four forged devices, lowered as its dry run lowers a
    cell.  Two departures, both forced: the mesh's axes are ``Auto`` (the
    reference's ``fsdp`` layer constraint refuses ``Explicit`` axes), and
    where ``zero1`` with ``fsdp`` would name the data axis twice in a
    moment's spec (``DuplicateSpecError``) the moment takes its parameter's
    spec, as the port stores it."""
    return _run(f"""
        import json
        import jax, jax.numpy as jnp
        from jax.sharding import PartitionSpec
        from repro.config import ShapeSpec, TrainConfig, get_arch
        from repro.dist.sharding import (batch_pspecs, cache_pspecs, layer_slice_pspecs,
                                         opt_pspecs, params_pspecs, to_shardings)
        from repro.launch.dryrun import make_train_step, parse_variant
        from repro.models import build_model, input_specs
        from repro.optim import adamw_init

        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)

        def dedup(o, p):
            names = [a for e in (o or ()) for a in ((e,) if isinstance(e, str) else (e or ()))]
            return p if names.count("data") > 1 else o

        out = {{}}
        for arch, kind, variant in {XLA_CELLS!r}:
            opts = parse_variant(variant)
            model, cfg = build_model(get_arch(arch).reduced.replace(dtype="float32"))
            shape = ShapeSpec("c", 32, 4, kind)
            params_spec = jax.eval_shape(model.init, jax.random.PRNGKey(0))
            if opts["serve_bf16"]:
                params_spec = jax.tree_util.tree_map(
                    lambda v: jax.ShapeDtypeStruct(v.shape, jnp.bfloat16)
                    if v.dtype == jnp.float32 else v, params_spec)
            p_specs = params_pspecs(params_spec, mesh, fsdp=opts["fsdp"])
            batch_spec = input_specs(cfg, shape)
            with mesh:
                if kind == "train":
                    opt_spec = jax.eval_shape(adamw_init, params_spec)
                    o_specs = opt_pspecs(opt_spec, p_specs, mesh, zero1=opts["zero1"])
                    for k in ("mu", "nu"):
                        o_specs[k] = jax.tree_util.tree_map(
                            dedup, o_specs[k], p_specs,
                            is_leaf=lambda x: x is None or isinstance(x, PartitionSpec))
                    lc = layer_slice_pspecs(params_spec["blocks"], mesh) if opts["fsdp"] else None
                    step = make_train_step(model, TrainConfig(),
                                           grad_specs=o_specs["mu"] if opts["zero1"] else None,
                                           layer_constraint=lc)
                    sh = to_shardings({{"params": p_specs, "opt": o_specs}}, mesh)
                    jitted = jax.jit(step, in_shardings=(
                        sh, to_shardings(batch_pspecs(batch_spec, mesh), mesh)),
                        out_shardings=(sh, None))
                    compiled = jitted.lower({{"params": params_spec, "opt": opt_spec}},
                                            batch_spec).compile()
                else:
                    caches = jax.eval_shape(lambda: model.make_caches(4, 32))
                    c_specs = cache_pspecs(caches, mesh,
                                           seq_fallback_model=opts["cache_seq_fallback"])
                    b_specs = batch_pspecs(batch_spec, mesh)
                    jitted = jax.jit(
                        lambda p, t, c, pos: model.decode_step(p, t, c, pos, None),
                        in_shardings=(to_shardings(p_specs, mesh),
                                      to_shardings(b_specs["tokens"], mesh),
                                      to_shardings(c_specs, mesh), None))
                    compiled = jitted.lower(params_spec, batch_spec["tokens"], caches,
                                            jax.ShapeDtypeStruct((), jnp.int32)).compile()
            out[f"{{arch}}/{{kind}}/{{variant}}"] = \\
                compiled.memory_analysis().argument_size_in_bytes
        print(json.dumps(out))
    """, devices=4)


#: what XLA counts as an argument and the port's rules do not: the AdamW
#: step counter (an int32 scalar in the reference, a Python int in the
#: port) and the decode position (the same)
UNCOUNTED = {"train": ("opt/step", 4), "decode": ("pos0", 4)}


@pytest.mark.parametrize("arch,kind,variant", XLA_CELLS)
def test_argument_bytes_equal_the_reference_xla_figure(arch, kind, variant, xla_argument_bytes):
    art = dryrun.dry_cell(arch, ShapeSpec("c", 32, 4, kind), MeshSpec((2, 2), ("data", "model")),
                          "test", variant, cfg=get_arch(arch).reduced.replace(dtype="float32"))
    _leaf, nbytes = UNCOUNTED[kind]
    assert art["memory"]["argument_bytes"] + nbytes == xla_argument_bytes[f"{arch}/{kind}/{variant}"]


@pytest.mark.parametrize("arch,variant,seq", [("rwkv6-7b", "", 40), ("rwkv6-7b", "wkvchunk", 40),
                                              ("zamba2-7b", "", 64)])
def test_trip_scaled_cell_equals_the_unscaled_one(arch, variant, seq):
    cfg = get_arch(arch).reduced.replace(dtype="float32")
    mesh = MeshSpec((1, 1), ("data", "model"))
    a, b = (dryrun.dry_cell(arch, ShapeSpec("t", seq, 2, "train"), mesh, "t", variant, cfg=cfg,
                            trip_scaling=ts) for ts in (True, False))
    for key in ("cost", "launches", "collectives"):
        assert a[key] == b[key], key
    assert a["cost"]["flops"] > 0


def test_kernel_meta_routes_record_a_launch_and_compute_nothing():
    b, h, s, k = 2, 3, 16, 8
    r = torch.empty(b, h, s, k, device="meta")
    with cost.CostCounter() as c:
        y, state = rwkv6_wkv(r, r, r, r, torch.empty(h, k, device="meta"))
    assert (tuple(y.shape), tuple(state.shape)) == ((b, h, s, k), (b, h, k, k))
    assert y.dtype == torch.float32 and c.cost.launches == {"wkv_scan": 1}
    nbytes, flops = wkv_cost(b, h, s, k, 4)
    assert (c.cost.bytes, c.cost.flops) == (nbytes, flops)
    p, n = 8, 4
    x = torch.empty(b, h, s, p, dtype=torch.bfloat16, device="meta")
    da = torch.empty(b, h, s, device="meta")
    bc = torch.empty(b, s, n, device="meta")
    with cost.CostCounter() as c:
        y, state = mamba2_ssd(x, da, da, bc, bc, chunk=8)
    assert y.dtype == torch.bfloat16 and tuple(state.shape) == (b, h, p, n)
    assert c.cost.launches == {"ssd_scan": 1}
    assert (c.cost.bytes, c.cost.flops) == ssd_cost(b, h, s, p, n, 8, 2)
    with pytest.raises(ValueError):
        mamba2_ssd(x, da, da, bc, bc, chunk=6)


def _reduced_shapes(cfg):
    n = cfg.frontend.n_patches if cfg.frontend is not None and cfg.frontend.kind == "vision" else 0
    return [ShapeSpec("train_4k", n + 32, 4, "train"), ShapeSpec("prefill_32k", n + 32, 4,
                                                                   "prefill"),
            ShapeSpec("decode_32k", 32, 4, "decode"), ShapeSpec("long_500k", 64, 1, "decode")]


MESHES = {"single": MeshSpec((2, 2), ("data", "model")),
          "multi": MeshSpec((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_every_reduced_cell_of_the_grid_runs(arch):
    cfg = get_arch(arch).reduced
    for shape in _reduced_shapes(cfg):
        if not supports_shape(cfg, shape):
            assert shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid")
            continue
        for name, mesh in MESHES.items():
            art = dryrun.dry_cell(arch, shape, mesh, name, cfg=cfg)
            assert art["ok"] and art["memory"]["argument_bytes"] > 0, (shape.name, name)
            assert art["cost"]["flops"] > 0 and art["memory"]["temp_bytes"] > 0
            assert art["collectives"]["count"] > 0 and art["n_devices"] == mesh.size()
            # the serving cells of an SSM launch its scan kernel on the card
            if shape.kind != "train" and cfg.family == "ssm":
                assert art["launches"].get("wkv_scan", 0) > 0
            if shape.kind == "prefill" and cfg.family == "hybrid":
                assert art["launches"].get("ssd_scan", 0) > 0


def test_the_command_line_writes_one_artifact_a_cell(tmp_path, capsys):
    with pytest.raises(SystemExit) as done:
        dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k,long_500k",
                     "--mesh", "single", "--out", str(tmp_path)])
    assert done.value.code == 0
    files = sorted(os.listdir(tmp_path))
    assert files == ["whisper-small__decode_32k__single.json",
                     "whisper-small__long_500k__single.json"]
    cell = json.loads((tmp_path / files[0]).read_text())
    assert cell["ok"] and cell["n_devices"] == 256 and cell["memory"]["peak_bytes"] > 0
    assert json.loads((tmp_path / files[1]).read_text())["skipped"]
    assert "2 cells, 0 failures" in capsys.readouterr().out
