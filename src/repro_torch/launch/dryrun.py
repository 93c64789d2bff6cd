"""The dry run on the meta device, the port of the reference's
``launch/dryrun.py``: every (architecture x input shape x mesh) cell
reckoned at full size with no storage and no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

The reference lowers and compiles each cell for its production TPU meshes
(16 x 16, or 2 x 16 x 16) and reads XLA's memory and cost analyses.  Here
each cell builds its model on the meta device at full size (no draws),
plays rank 0 of the mesh (``launch.mesh.MeshSpec``: ``dist/comm.py``'s dry
route, every collective counted and none run), and runs the step the port
runs, on meta tensors, under ``utils/cost.py``'s counter: the train step of
:func:`make_train_step` (the step the card and the CPU tests drive on real
tensors), or ``ServeEngine``'s prefill or decode step.  Each cell writes
``<out>/<arch>__<shape>__<mesh>[__variant].json`` with the reference's keys
where they mean something here:

* ``memory`` - ``argument_bytes`` (this rank's stored parameters and AdamW
  moments, its rows of the batch and its caches), ``output_bytes``,
  ``temp_bytes`` (the peak of live bytes above the arguments) and
  ``peak_bytes`` (their sum);
* ``cost`` - ``flops`` and ``bytes_accessed`` (``utils/cost.py``);
* ``collectives`` in the ``collective_bytes`` layout, and
  ``top_collectives``;
* ``model`` - ``params_total``, ``params_active``, ``tokens_per_step`` and
  ``model_flops = 6 N_active tokens``;
* ``launches`` - the hand-written kernels' launches the cell reckons (the
  scans' meta routes);
* ``seconds_trace`` in place of the reference's lower and compile times.

Shapes that ``supports_shape`` rejects are recorded as skipped.  The MoE
dispatch reads no values (its buffers are sized by the static capacity of
``nn/moe.py::_capacity``), so an MoE cell's shapes follow from its config.
The process runs on the CPU with meta tensors; the figures are reckonings
of one rank's step, never measurements.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.config import SHAPES, ShapeSpec, TrainConfig, get_arch, supports_shape
from repro_torch.dist.flow import shard_batch
from repro_torch.dist.model import ModelSharding
from repro_torch.dist.sharding import model_size
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models.lm import Model
from repro_torch.models.registry import input_specs
from repro_torch.optim.adamw import adamw_init
from repro_torch.utils import cost as costmod
from repro_torch.utils.tree import param_bytes

VARIANT_TOKENS = ("standard", "coupled", "bf16res", "wkvchunk", "zero1",
                  "attnseq", "servefix", "fsdp")


def parse_variant(variant: str) -> dict:
    """Variant string: '-'-joined tokens, e.g. 'coupled-bf16res'.

    standard  -> reversible=False (naive-AD architecture baseline)
    coupled   -> fused reversible backward
    bf16res   -> bf16 residual streams
    wkvchunk  -> chunked rwkv wkv scan
    zero1     -> ZeRO-1 optimizer-state sharding
    attnseq   -> sequence-parallel attention
    servefix  -> bf16 serving weights + seq-sharded KV fallback
    fsdp      -> params+moments sharded over data axes too
    """
    tokens = [t for t in variant.split("-") if t]
    for t in tokens:
        if t not in VARIANT_TOKENS:
            raise ValueError(f"unknown variant token {t!r}")
    opts = {
        "overrides": {},
        "grad_mode": None,
        "zero1": "zero1" in tokens,
        "serve_bf16": "servefix" in tokens,
        "cache_seq_fallback": "servefix" in tokens,
        "fsdp": "fsdp" in tokens,
    }
    if "standard" in tokens:
        opts["overrides"]["reversible"] = False
    if "coupled" in tokens:
        opts["grad_mode"] = "coupled"
    if "bf16res" in tokens:
        opts["overrides"]["residual_dtype"] = "bfloat16"
    if "attnseq" in tokens:
        opts["overrides"]["attn_seq_shard"] = True
    return opts


def _maybe_wkvchunk(cfg, variant):
    if "wkvchunk" in variant and cfg.ssm is not None and cfg.ssm.kind == "rwkv6":
        return cfg.replace(ssm=dataclasses.replace(cfg.ssm, wkv_chunk=32))
    return cfg


class _NoDraws(TorchFunctionMode):
    """Every tensor a function makes lands on the meta device and no
    generator is drawn from: a model's structure without its values."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def meta_model(cfg) -> Model:
    """``cfg``'s model on the meta device at full size: its parameters'
    shapes and dtypes, nothing drawn (the dry run alone skips the draws)."""
    with torch.device("meta"), _NoDraws():
        return Model(cfg, generator=torch.Generator(), device="meta")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


class TrainStep:
    """One training step of ``model`` as the port runs it: ``step(state,
    batch) -> (state, metrics)`` on the whole batch (each rank takes its
    rows), and ``init_state()``.  Off a mesh, or on a mesh of one rank, it
    is the one-process step of the supervised loop; on a pure data-parallel
    mesh the data-parallel step; with ``fsdp``, ``zero1`` or a ``model``
    axis more than 1 the sharded step (``dist/step.py``) over a
    ``ModelSharding`` that stores the model's blocks (``.sharding``)."""

    def __init__(self, model, tcfg: TrainConfig, grad_mode=None, mesh=None, zero1=False,
                 fsdp=False):
        from repro_torch.train.loop import _make_step

        if (zero1 or fsdp) and mesh is None:
            raise ValueError("zero1 and fsdp need a mesh")
        self.model, self.mesh = model, mesh
        self.sharding = None
        if mesh is not None and (model_size(mesh) > 1 or zero1 or fsdp):
            self.sharding = ModelSharding(model, mesh, fsdp=fsdp, zero1=zero1).shard()

        def objective(batch):
            return model.train_loss(batch, grad_mode=grad_mode)

        self._step = _make_step(objective, model, tcfg, mesh, None, self.sharding)

    def init_state(self) -> dict:
        """Zero AdamW moments (this rank's blocks) and no residuals."""
        params = dict(self.model.named_parameters())
        opt = self.sharding.init_opt() if self.sharding is not None else adamw_init(params)
        return {"opt": opt, "err": {}}

    def stored_bytes(self, state) -> int:
        """This rank's parameter and moment bytes as stored."""
        return param_bytes(list(self.model.parameters())) + param_bytes(
            [state["opt"]["mu"], state["opt"]["nu"]])

    def __call__(self, state, batch):
        return self._step(state, shard_batch(batch, self.mesh), state["opt"]["step"])


def make_train_step(model, tcfg: TrainConfig, grad_mode=None, *, mesh=None, zero1: bool = False,
                    fsdp: bool = False) -> TrainStep:
    """The port's train step (:class:`TrainStep`): the step the dry run
    reckons on meta tensors and the card and the CPU tests run on real
    ones.  ``zero1``: moments split over the data axes, the gradient
    reduce-scattered into them; ``fsdp``: parameters split over the data
    axes too, gathered a layer at a time (``dist/model.py``)."""
    return TrainStep(model, tcfg, grad_mode, mesh, zero1, fsdp)


# ---------------------------------------------------------------------------
# a cell
# ---------------------------------------------------------------------------


def _stored(model) -> int:
    return param_bytes(list(model.parameters()))


def dry_cell(arch: str, shape: ShapeSpec, mesh: MeshSpec, mesh_name: str, variant: str = "",
             cfg=None, trip_scaling: bool = True, max_len: int | None = None) -> dict:
    """Reckon one cell on rank ``mesh.rank`` of ``mesh``; returns the
    artifact dict.  ``cfg`` (a ``ModelConfig``) replaces the architecture's
    full config (a reduced or depth-cut one); ``trip_scaling=False`` traces
    every step of the plain scans' loops; ``max_len`` gives a serving cell's
    caches more positions than its ``seq_len`` (a prompt of ``seq_len``
    tokens, a decode step at position ``max_len - 1``)."""
    from repro_torch.serve.engine import ServeEngine

    opts = parse_variant(variant)
    cfg = cfg if cfg is not None else get_arch(arch).config
    if opts["overrides"]:
        cfg = cfg.replace(**opts["overrides"])
    cfg = _maybe_wkvchunk(cfg, variant)
    t0 = time.time()
    model = meta_model(cfg)
    specs = input_specs(cfg, shape)
    one = mesh.size() == 1
    counter = costmod.CostCounter(trip_scaling)
    if shape.kind == "train":
        step = make_train_step(model, TrainConfig(), grad_mode=opts["grad_mode"],
                               mesh=None if one else mesh, zero1=opts["zero1"], fsdp=opts["fsdp"])
        state = step.init_state()
        local = shard_batch(specs, mesh)
        args = step.stored_bytes(state) + param_bytes(local)
        with counter:
            state, metrics = step(state, specs)
        out = metrics
    else:
        max_len = max_len or shape.seq_len
        engine = ServeEngine(model, max_len=max_len, device="meta", mesh=mesh,
                             cache_seq_fallback=opts["cache_seq_fallback"],
                             serve_bf16=opts["serve_bf16"])
        caches = engine.caches(shape.global_batch)
        local = shard_batch(specs, mesh)
        extra = None
        if shape.kind == "decode" and cfg.is_enc_dec:
            rows = local["tokens"].shape[0]
            extra = {"enc": torch.empty((rows, cfg.frontend.n_frames, cfg.d_model),
                                        dtype=getattr(torch, cfg.dtype), device="meta")}
        args = _stored(model) + param_bytes(local) + param_bytes(caches) + param_bytes(extra)
        with counter:
            if shape.kind == "prefill":
                out = engine.prefill(local, caches)
            else:
                out = engine.decode(local["tokens"], caches, max_len - 1, extra)
    counter.outputs(out)
    seconds = time.time() - t0
    c = counter.cost
    n_params = cfg.param_count()
    n_active = cfg.param_count(active_only=True)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    art = {
        "arch": arch,
        "shape": shape.name,
        "kind": shape.kind,
        "mesh": mesh_name,
        "variant": variant or "reversible",
        "ok": True,
        "seconds_trace": round(seconds, 2),
        "n_devices": mesh.size(),
        "mesh_shape": list(mesh.shape),
        "backend": mesh.backend,
        "memory": {
            "argument_bytes": args,
            "output_bytes": c.output_bytes,
            "temp_bytes": c.temp_bytes,
            "peak_bytes": args + c.temp_bytes,
        },
        "cost": {"flops": c.flops, "bytes_accessed": c.bytes},
        "collectives": costmod.collective_bytes(c),
        "top_collectives": [{"bytes": b, "scale": sc, "kind": k, "line": ln[:220]}
                            for b, sc, k, ln in costmod.top_collectives(c, 8)],
        "launches": dict(c.launches),
        "model": {
            "params_total": n_params,
            "params_active": n_active,
            "tokens_per_step": tokens,
            "model_flops": 6.0 * n_active * tokens,
        },
        "reckoned_on": "meta device, rank 0 of the mesh: a reckoning, not a measurement",
    }
    if cfg.moe is not None:
        art["moe_dispatch"] = ("static capacity (nn/moe.py::_capacity): the dispatch reads no "
                               "values, its shapes follow from the config")
    return art


def run(args) -> int:
    meshes = []
    if args.mesh in ("single", "both"):
        meshes.append(("single", make_production_mesh(multi_pod=False)))
    if args.mesh in ("multi", "both"):
        meshes.append(("multi", make_production_mesh(multi_pod=True)))

    archs = args.arch.split(",")
    if args.arch == "all":
        from repro_torch.configs import ASSIGNED_ARCHS

        archs = list(ASSIGNED_ARCHS)
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")

    os.makedirs(args.out, exist_ok=True)
    suffix = f"__{args.variant}" if args.variant else ""

    results = []
    t_all = time.time()
    for arch in archs:
        cfg = get_arch(arch).config
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            for mesh_name, mesh in meshes:
                tag = f"{arch}__{shape_name}__{mesh_name}{suffix}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"[skip] {tag} (exists)")
                    continue
                if not supports_shape(cfg, shape):
                    art = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "ok": True, "skipped": True,
                        "reason": "long_500k requires sub-quadratic attention "
                                  "(full-attention arch)",
                    }
                    with open(path, "w") as f:
                        json.dump(art, f, indent=1)
                    print(f"[skip] {tag} (inapplicable shape)")
                    results.append(art)
                    continue
                print(f"[trace] {tag} ...", flush=True)
                t0 = time.time()
                try:
                    art = dry_cell(arch, shape, mesh, mesh_name, variant=args.variant)
                except Exception as e:  # noqa: BLE001
                    art = {
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "ok": False, "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                with open(path, "w") as f:
                    json.dump(art, f, indent=1)
                status = "ok" if art.get("ok") else "FAIL"
                print(f"  -> {status} in {time.time() - t0:.1f}s", flush=True)
                if art.get("ok") and "memory" in art:
                    m = art["memory"]
                    print(f"     mem/rank: args {m['argument_bytes'] / 2**30:.2f} GiB, "
                          f"peak {m['peak_bytes'] / 2**30:.2f} GiB; "
                          f"flops/rank {art['cost']['flops']:.3g}; "
                          f"collective {art['collectives']['total'] / 2**20:.1f} MiB",
                          flush=True)
                results.append(art)
    n_fail = sum(1 for r in results if not r.get("ok"))
    print(f"\ndone: {len(results)} cells, {n_fail} failures, {time.time() - t_all:.1f}s")
    return 1 if n_fail else 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--variant", default="",
                    help="'-'-joined tokens: standard coupled bf16res wkvchunk "
                         "zero1 attnseq servefix fsdp (see parse_variant)")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    raise SystemExit(run(args))


if __name__ == "__main__":
    main()
