"""Multi-process ``gloo`` runs of the port for the distribution tests
(``test_torch_dist_*.py``): :func:`spawn` starts ``world`` processes over a
``file://`` store in the test's ``tmp_path`` (no ports), each on one CPU
thread, with a timeout on the process group and on the join, and returns
what each rank's function returned.  The rank functions below import the
port alone; the tests compute the reference's single-device oracles in
their own process and hand numpy arrays in."""

import os
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

#: a rank that hangs fails its collectives after this many seconds, and a
#: group that has not finished by the join's limit is killed
PG_TIMEOUT_S = 45.0
JOIN_TIMEOUT_S = 90.0


def _entry(fn, rank, world, tmp, args):
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_world

    try:
        init_world("cpu", init_method=f"file://{os.path.join(tmp, 'store')}", rank=rank,
                   world_size=world, timeout_s=PG_TIMEOUT_S)
        out = fn(rank, world, tmp, *args)
        torch.save(out, os.path.join(tmp, f"out{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"err{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, tmp, *args) -> list:
    """``[fn(rank, world, tmp, *args) for each rank]``, each in a process of
    its own in one ``gloo`` world.  Raises with the failing ranks'
    tracebacks, or when the group outlives ``JOIN_TIMEOUT_S``."""
    import time

    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args)) for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errs = {r: open(os.path.join(tmp, f"err{r}.txt")).read() for r in range(world)
            if os.path.exists(os.path.join(tmp, f"err{r}.txt"))}
    if hung:
        raise TimeoutError(f"ranks {hung} did not finish in {JOIN_TIMEOUT_S} s; {errs}")
    if errs or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"exit codes {[p.exitcode for p in procs]}:\n" +
                           "\n".join(f"rank {r}:\n{e}" for r, e in errs.items()))
    return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def _np(d: dict) -> dict:
    return {k: v.detach().float().numpy() for k, v in d.items()}


def _mesh(world):
    from repro_torch.launch.mesh import make_auto_mesh

    return make_auto_mesh((world, 1), device_type="cpu")


def _flow(kind: str, build_kw: dict, tree, psum_axis=None):
    from repro_torch.bridge import params_from_numpy
    from repro_torch.core import build_glow, build_glow_scanned

    if kind == "scanned":
        flow = build_glow_scanned(**build_kw, psum_axis=psum_axis, device="cpu")
    else:
        flow = build_glow(**build_kw, device="cpu")
    return params_from_numpy(flow, tree)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def dp_grads(rank, world, tmp, kind, build_kw, tree, x, psum_axis):
    """``dp_value_and_grad_nll`` of a flow built with ``psum_axis`` (the
    overlapped reduction) and of one built without it (trailing)."""
    from repro_torch.dist import comm, dp_value_and_grad_nll

    mesh = _mesh(world)
    out = {}
    for name, axis in (("given", psum_axis), ("trailing", None)):
        flow = _flow(kind, build_kw, tree, axis)
        comm.reset_wire_bytes()
        loss, grads = dp_value_and_grad_nll(flow, mesh)(torch.from_numpy(x))
        out[name] = {"loss": float(loss), "grads": _np(grads), "psum_axis": flow.psum_axis,
                     "wire": comm.wire_bytes()}
    return out


def compressed(rank, world, tmp, g_all, e_all, method, ratio):
    """``compressed_allreduce`` of rank ``r``'s ``g_all[r]`` with residual
    ``e_all[r]``."""
    from repro_torch.dist import comm
    from repro_torch.optim import compressed_allreduce

    mesh = _mesh(world)
    comm.reset_wire_bytes()
    with comm.bound(mesh):
        red, err = compressed_allreduce({"w": torch.from_numpy(g_all[rank])},
                                        {"w": torch.from_numpy(e_all[rank])}, method, "data",
                                        ratio)
    return {"reduced": red["w"].numpy(), "err": err["w"].numpy(), "wire": comm.wire_bytes()}


def step_wire_bytes(rank, world, tmp, build_kw, tree, x, methods):
    """One data-parallel train step of a scanned GLOW per method: its wire
    bytes and the updated parameters."""
    from repro_torch.config import TrainConfig
    from repro_torch.core.objectives import nll_loss
    from repro_torch.dist import comm, shard_batch
    from repro_torch.dist.step import make_dp_train_step
    from repro_torch.optim import adamw_init, compression_init

    mesh = _mesh(world)
    out = {}
    for method in methods:
        flow = _flow("scanned", build_kw, tree)
        params = dict(flow.named_parameters())
        cfg = TrainConfig(steps=4, grad_compression=method, compression_ratio=0.01)
        step = make_dp_train_step(lambda b: (nll_loss(flow, b), {}), flow, cfg, mesh)
        err = {} if method == "none" else {
            k: v for k, v in compression_init(params).items() if v is not None}
        comm.reset_wire_bytes()
        state, metrics = step({"opt": adamw_init(params), "err": err},
                              shard_batch(torch.from_numpy(x), mesh), 0)
        out[method] = {"wire": comm.wire_bytes(), "loss": float(metrics["loss"]),
                       "params": _np(dict(flow.named_parameters())),
                       "err": _np(state["err"])}
    return out


class _Batches:
    def __init__(self, arrays):
        self.arrays = arrays

    def batch_at(self, step):
        return torch.from_numpy(self.arrays[step % len(self.arrays)])


def train_flow_dp(rank, world, tmp, build_kw, tree, batches, cfg_kw, psum_axis=None,
                  ckpt_dir=None, fail_at=()):
    """``train_flow`` of a scanned GLOW on a ``(world, 1)`` mesh."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.fault import FailureInjector
    from repro_torch.train.loop import train_flow

    flow = _flow("scanned", build_kw, tree, psum_axis)
    cfg = TrainConfig(**cfg_kw, checkpoint_dir=ckpt_dir)
    res = train_flow(flow, _Batches(batches), cfg, device="cpu", mesh=_mesh(world),
                     injector=FailureInjector(fail_at=tuple(fail_at)) if fail_at else None)
    return {"losses": res.losses, "params": _np(dict(flow.named_parameters())),
            "final_step": res.final_step, "restarts": res.restarts,
            "err": _np(res.err_state)}


class _Tokens:
    def __init__(self, batches):
        self.batches = batches

    def batch_at(self, step):
        return {k: torch.from_numpy(v) for k, v in self.batches[step].items()}


def train_lm_dp(rank, world, tmp, arch_cfg, tree, cfg_kw, batches):
    """``train_lm`` of a ``REDUCED`` LM on a ``(world, 1)`` mesh over the
    given token batches (``{"tokens", "labels"}`` numpy arrays a step)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.config import TrainConfig
    from repro_torch.models import Model
    from repro_torch.train.loop import train_lm

    model = params_from_numpy(Model(arch_cfg, device="cpu"), tree)
    res = train_lm(model, _Tokens(batches), TrainConfig(**cfg_kw), device="cpu",
                   mesh=_mesh(world))
    return {"losses": res.losses, "params": _np(dict(model.named_parameters()))}


def pipeline(rank, world, tmp, w, b, x, gy, n_layers):
    """``pipeline_forward`` over a ``("pipe",)`` mesh of ``world`` stages
    and its gradient against the cotangent ``gy``: this stage's ``w``,
    ``b`` and (on stage 0) ``x`` gradients."""
    from repro_torch.dist import pipeline_forward, pipeline_stage_fn
    from repro_torch.launch.mesh import make_auto_mesh

    mesh = make_auto_mesh((world,), ("pipe",), device_type="cpu")
    wl = torch.from_numpy(w[rank]).requires_grad_()
    bl = torch.from_numpy(b[rank]).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    stage = pipeline_stage_fn(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), n_layers)
    out = pipeline_forward(stage, {"w": wl, "b": bl}, xt, mesh)
    gw, gb, gx = torch.autograd.grad(out, [wl, bl, xt], torch.from_numpy(gy),
                                     allow_unused=True)
    return {"out": out.detach().numpy(), "gw": gw.numpy(), "gb": gb.numpy(),
            "gx": None if gx is None else gx.numpy()}


class _RegressionData:
    def __init__(self, xs, ys):
        self.xs, self.ys = xs, ys

    def batch_at(self, step):
        i = step % len(self.xs)
        return {"x": torch.from_numpy(self.xs[i]), "y": torch.from_numpy(self.ys[i])}


def train_pipeline_run(rank, world, tmp, init, xs, ys, cfg_kw, n_layers):
    """``train_pipeline`` of tanh blocks with a linear head over a
    ``("pipe",)`` mesh."""
    from repro_torch.bridge import torch_tree
    from repro_torch.config import TrainConfig
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.train.loop import train_pipeline

    mesh = make_auto_mesh((world,), ("pipe",), device_type="cpu")
    res = train_pipeline(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), lambda: torch_tree(init),
                         _RegressionData(xs, ys), TrainConfig(**cfg_kw), mesh=mesh,
                         loss_head=lambda p, h, batch: torch.mean(
                             (h @ p["head"] - batch["y"]) ** 2),
                         n_layers_per_stage=n_layers, device="cpu")
    return {"losses": res.losses,
            "params": {k: v.numpy() for k, v in res.params.items()}}


def pipeline_on_mesh(rank, world, tmp, shape, axes, w, b, x, gy, init, xs, ys, cfg_kw,
                     n_layers):
    """On a mesh of ``shape`` over ``axes`` (one of them ``"pipe"``):
    ``pipeline_forward`` of tanh blocks and its gradient against ``gy`` (this
    stage's ``w``, ``b`` and, on stage 0, ``x`` gradients), ``train_pipeline``
    with a linear head, and the error ``train_pipeline`` raises on a
    ``("data", "model")`` mesh of the same ranks."""
    from repro_torch.bridge import torch_tree
    from repro_torch.config import TrainConfig
    from repro_torch.dist import pipeline_forward, pipeline_stage_fn
    from repro_torch.launch.mesh import make_auto_mesh
    from repro_torch.train.loop import train_pipeline

    def block(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    mesh = make_auto_mesh(tuple(shape), tuple(axes), device_type="cpu")
    s = mesh.get_local_rank("pipe")
    wl = torch.from_numpy(w[s]).requires_grad_()
    bl = torch.from_numpy(b[s]).requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = pipeline_forward(pipeline_stage_fn(block, n_layers), {"w": wl, "b": bl}, xt, mesh)
    gw, gb, gx = torch.autograd.grad(out, [wl, bl, xt], torch.from_numpy(gy),
                                     allow_unused=True)

    cfg = TrainConfig(**cfg_kw, checkpoint_dir=os.path.join(tmp, "ck"))
    res = train_pipeline(block, lambda: torch_tree(init), _RegressionData(xs, ys), cfg,
                         mesh=mesh, loss_head=lambda p, h, batch: torch.mean(
                             (h @ p["head"] - batch["y"]) ** 2),
                         n_layers_per_stage=n_layers, device="cpu")
    no_pipe = make_auto_mesh((world // 2, 2), ("data", "model"), device_type="cpu")
    try:
        train_pipeline(block, lambda: torch_tree(init), _RegressionData(xs, ys), cfg,
                       mesh=no_pipe, loss_head=lambda p, h, batch: h.sum(),
                       n_layers_per_stage=n_layers, device="cpu")
        no_pipe_error = None
    except ValueError as e:
        no_pipe_error = str(e)
    return {"coord": {a: mesh.get_local_rank(a) for a in axes}, "stage": s,
            "out": out.detach().numpy(), "gw": gw.numpy(), "gb": gb.numpy(),
            "gx": None if gx is None else gx.numpy(), "losses": res.losses,
            "final_step": res.final_step,
            "params": {k: v.numpy() for k, v in res.params.items()},
            "checkpoints": sorted(os.listdir(os.path.join(tmp, "ck"))),
            "no_pipe_error": no_pipe_error}


def serve_flow(rank, world, tmp, build_kw, tree, x, seed):
    """``FlowServeEngine(mesh=...)``'s ``log_prob`` of ``x`` and ``sample``
    from a generator seeded ``seed``."""
    from repro_torch.serve.engine import FlowServeEngine

    flow = _flow("scanned", build_kw, tree)
    engine = FlowServeEngine(flow, device="cpu", mesh=_mesh(world))
    lp = engine.log_prob(torch.from_numpy(x))
    with torch.no_grad():
        z, _ = flow(torch.from_numpy(x))
    like = tuple(torch.empty_like(v, device="meta") for v in z)
    samples = engine.sample(torch.Generator().manual_seed(seed), like)
    return {"log_prob": lp.numpy(), "samples": samples.numpy()}


def conditional(rank, world, tmp, model_kw, state, theta, y, y_obs, seed, n_draws,
                stats_kw):
    """A cHINT ``ConditionalFlow(mesh=...)``: ``log_prob``, posterior draws
    and ``PosteriorEngine`` statistics."""
    from repro_torch.uq.posterior import PosteriorEngine

    model = build_conditional(model_kw, state, _mesh(world))
    lp = model.log_prob(torch.from_numpy(theta), torch.from_numpy(y))
    draws = model.sample(torch.Generator().manual_seed(seed), torch.from_numpy(y_obs), n_draws,
                         model_kw["d_theta"])
    stats = PosteriorEngine(model, y=torch.from_numpy(y_obs), theta_dim=model_kw["d_theta"]).run(
        torch.Generator().manual_seed(seed + 1), **stats_kw)
    return {"log_prob": lp.detach().numpy(), "draws": draws.numpy(), "mean": stats.mean,
            "std": stats.std, "n": stats.n}


def build_conditional(model_kw, state, mesh):
    """A cHINT ``ConditionalFlow`` of ``model_kw``'s widths holding
    ``state`` (a ``state_dict`` of numpy arrays)."""
    from repro_torch.core import ConditionalFlow, SummaryMLP, build_chint

    kw = dict(depth=model_kw["depth"], recursion=2, hidden=model_kw["hidden"], device="cpu")
    flow = build_chint(model_kw["d_theta"], model_kw["d_summary"], grad_mode="coupled", **kw)
    twin = build_chint(model_kw["d_theta"], model_kw["d_summary"], kernel_inverse=True, **kw)
    summary = SummaryMLP(model_kw["d_y"], model_kw["d_summary"], model_kw["hidden"],
                         device="cpu")
    model = ConditionalFlow(flow, summary, sample_flow=twin, device="cpu", mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return model


def scenario_launcher(rank, world, tmp, ckpt):
    """Both launchers with ``--mesh 2,1`` on the ``lg-smoke`` scenario."""
    import contextlib
    import io

    from repro_torch.launch import serve, train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(["--scenario", "lg-smoke", "--steps", "4", "--mesh", f"{world},1",
                    "--device", "cpu", "--ckpt", ckpt])
        serve.main(["--scenario", "lg-smoke", "--ckpt", ckpt, "--samples", "1024",
                    "--chunk", "256", "--mesh", f"{world},1", "--device", "cpu",
                    "--no-calibration"])
    return buf.getvalue()


# ---------------------------------------------------------------------------
# model-sharded meshes
# ---------------------------------------------------------------------------


def _mesh_of(shape):
    from repro_torch.launch.mesh import make_auto_mesh

    axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return make_auto_mesh(tuple(shape), axes, device_type="cpu")


def train_flow_mesh(rank, world, tmp, shape, build_kw, tree, batches, cfg_kw, ckpt_dir=None,
                    psum_axis=None):
    """``train_flow`` of a scanned GLOW on a ``shape`` mesh (``(d, m)`` or
    ``(p, d, m)``): the losses, the final parameters (whole), this rank's
    stored bytes and the wire bytes of the run."""
    from repro_torch.config import TrainConfig
    from repro_torch.dist import comm
    from repro_torch.train.loop import train_flow

    import warnings

    mesh = _mesh_of(shape)
    flow = _flow("scanned", build_kw, tree, psum_axis)
    comm.reset_wire_bytes()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = train_flow(flow, _Batches(batches), TrainConfig(**cfg_kw, checkpoint_dir=ckpt_dir),
                         device="cpu", mesh=mesh)
    return {"losses": res.losses, "params": _np(dict(flow.named_parameters())),
            "shard_bytes": res.shard_bytes, "wire": comm.wire_bytes(),
            "final_step": res.final_step, "warnings": [str(w.message) for w in caught]}


def compression_on_model_mesh(rank, world, tmp, shape, build_kw, tree, batches):
    """``train_flow`` with int8 compression on a model-sharded mesh: the
    error it raises."""
    from repro_torch.config import TrainConfig
    from repro_torch.train.loop import train_flow

    flow = _flow("scanned", build_kw, tree)
    try:
        train_flow(flow, _Batches(batches), TrainConfig(steps=1, grad_compression="int8"),
                   device="cpu", mesh=_mesh_of(shape))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def launchers_mesh(rank, world, tmp, mesh_arg):
    """Both launchers on ``--mesh mesh_arg``: ``--arch
    granite-moe-1b-a400m --reduced`` trained then served, and the
    ``images-prior-scanned`` flow scenario trained."""
    import contextlib
    import io

    from repro_torch.launch import serve, train

    buf = io.StringIO()
    ck = os.path.join(tmp, "lm")
    with contextlib.redirect_stdout(buf):
        train.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--steps", "2", "--seq", "16",
                    "--batch", "2", "--mesh", mesh_arg, "--device", "cpu", "--ckpt", ck])
        serve.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--ckpt", ck, "--batch", "2",
                    "--prompt-len", "8", "--max-new", "4", "--mesh", mesh_arg,
                    "--device", "cpu"])
        train.main(["--scenario", "images-prior-scanned", "--steps", "2", "--mesh", mesh_arg,
                    "--device", "cpu", "--ckpt", os.path.join(tmp, "flow")])
    return buf.getvalue()


def train_lm_mesh(rank, world, tmp, shape, arch_cfg, tree, cfg_kw, batches, grad_mode=None):
    """``train_lm`` of a ``REDUCED`` LM on a ``shape`` mesh: the losses and
    the final parameters (whole)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.config import TrainConfig
    from repro_torch.models import Model
    from repro_torch.train.loop import train_lm

    model = params_from_numpy(Model(arch_cfg, device="cpu"), tree)
    res = train_lm(model, _Tokens(batches), TrainConfig(**cfg_kw), grad_mode=grad_mode,
                   device="cpu", mesh=_mesh_of(shape))
    return {"losses": res.losses, "params": _np(dict(model.named_parameters())),
            "shard_bytes": res.shard_bytes}


def serve_lm_mesh(rank, world, tmp, shape, arch_cfg, tree, prompt, max_new, max_len):
    """``ServeEngine(mesh=...)`` greedy generation of a ``REDUCED`` LM:
    the tokens, the first step's and the last step's logits, and the
    experts each rank ran."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.models import Model
    from repro_torch.nn import moe
    from repro_torch.serve.engine import ServeEngine

    model = params_from_numpy(Model(arch_cfg, device="cpu"), tree)
    engine = ServeEngine(model, max_len=max_len, device="cpu", mesh=_mesh_of(shape))
    ran = []
    orig = moe.ffn_apply

    def counting(p, x, kind):
        ran.append(int(x.shape[0]))
        return orig(p, x, kind)

    moe.ffn_apply = counting
    try:
        toks, logits = engine.generate({k: torch.from_numpy(v) for k, v in prompt.items()},
                                       max_new)
    finally:
        moe.ffn_apply = orig
    first = engine.generate({k: torch.from_numpy(v) for k, v in prompt.items()}, 1)[1]
    return {"tokens": toks.numpy(), "logits": logits.numpy(), "first_logits": first.numpy(),
            "experts_run": ran,
            "stored": sum(p.numel() for p in model.parameters())}


def attention_mesh(rank, world, tmp, shape, attn_cfg, params, x, gy, cache_len, pos0,
                   x_flash):
    """``attn_apply(seq_shard=True)`` on a ``shape`` mesh: the prefill
    without a cache and its gradients against the cotangent ``gy``, then a
    cached prefill and one cached decode step; and ``impl="flash"`` at
    ``x_flash``'s length (a multiple of 128), with the calls it made to
    ``flash_sdpa``."""
    from repro_torch.dist import comm
    from repro_torch.kernels.attention import ops
    from repro_torch.nn.attention import attn_apply, make_cache

    mesh = _mesh_of(shape)
    p = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    pos = torch.arange(x.shape[1])
    with comm.bound(mesh):
        out, _ = attn_apply(p, xt, attn_cfg, pos, seq_shard=True)
        grads = torch.autograd.grad(out, [xt, *p.values()], torch.from_numpy(gy))
        cache = make_cache(attn_cfg, x.shape[0], cache_len, torch.float32)
        with torch.no_grad():
            pre, _ = attn_apply(p, xt[:, :pos0], attn_cfg, pos[:pos0], cache=cache, cache_pos=0,
                                seq_shard=True)
            dec, _ = attn_apply(p, xt[:, pos0:pos0 + 1], attn_cfg, pos[pos0:pos0 + 1],
                                cache=cache, cache_pos=pos0, seq_shard=True)
        calls = []
        flash = ops.flash_sdpa

        def counting(*args, **kw):
            calls.append(args[0].shape)
            return flash(*args, **kw)

        ops.flash_sdpa = counting
        try:
            with torch.no_grad():
                out_flash, _ = attn_apply(p, torch.from_numpy(x_flash), attn_cfg,
                                          torch.arange(x_flash.shape[1]), impl="flash",
                                          seq_shard=True)
        finally:
            ops.flash_sdpa = flash
    return {"out": out.detach().numpy(), "grads": [g.numpy() for g in grads],
            "cached_prefill": pre.numpy(), "decode": dec.numpy(),
            "flash": out_flash.numpy(), "flash_calls": [tuple(c) for c in calls]}


def moe_mesh(rank, world, tmp, shape, moe_cfg, kind, params, x, gy):
    """``moe_apply`` on a ``shape`` mesh (expert parallelism): the output,
    aux and the gradients of ``x`` and of every parameter against ``gy``."""
    from repro_torch.dist import comm
    from repro_torch.nn.moe import moe_apply

    flat = {k: torch.from_numpy(v).requires_grad_() for k, v in params.items()}
    tree = {"router": flat["router"],
            "experts": {k.split(".", 1)[1]: v for k, v in flat.items()
                        if k.startswith("experts.")}}
    xt = torch.from_numpy(x).requires_grad_()
    with comm.bound(_mesh_of(shape)):
        y, aux = moe_apply(tree, xt, moe_cfg, kind)
        grads = torch.autograd.grad(y, [xt, *flat.values()], torch.from_numpy(gy))
    return {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
            "grads": dict(zip(["x", *flat], [g.numpy() for g in grads]))}


def train_flow_synthetic(rank, world, tmp, shape, build_kw):
    """One ``train_flow`` step of a freshly built scanned GLOW on
    ``SyntheticImages`` on a ``shape`` mesh: its losses."""
    from repro_torch.config import TrainConfig
    from repro_torch.core import build_glow_scanned
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.train.loop import train_flow

    flow = build_glow_scanned(**build_kw, device="cpu")
    res = train_flow(flow, SyntheticImages(8, batch=2), TrainConfig(steps=1), device="cpu",
                     mesh=_mesh_of(shape))
    return {"losses": res.losses}


def sharded_lm_steps(rank, world, tmp, shape, arch_cfg, tree, batch, cfg_kw, variants, steps):
    """For each dry-run variant (``zero1``, ``fsdp``, ...): ``steps`` steps of
    ``launch/dryrun.py::make_train_step`` of a ``REDUCED`` LM on a ``shape``
    mesh from ``tree`` on the whole ``batch``: the losses, the final
    parameters whole, this rank's stored bytes, the wire bytes of the first
    step, the whole-leaf round trip of the blocks (a checkpoint's), and the
    dry run's reckoning of the same cell on this rank (``MeshSpec`` over
    gloo)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.config import ShapeSpec, TrainConfig
    from repro_torch.dist import comm
    from repro_torch.launch.dryrun import dry_cell, make_train_step, parse_variant
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import Model

    mesh = _mesh_of(shape)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for variant in variants:
        opts = parse_variant(variant)
        model = params_from_numpy(Model(arch_cfg, device="cpu"), tree)
        step = make_train_step(model, TrainConfig(**cfg_kw), mesh=mesh, zero1=opts["zero1"],
                               fsdp=opts["fsdp"])
        state = step.init_state()
        sharding = step.sharding  # None: the replicated data-parallel step
        stored = sharding.resident_bytes(state["opt"]) if sharding is not None else {}
        losses, wire = [], None
        for i in range(steps):
            comm.reset_wire_bytes()
            state, metrics = step(state, tb)
            losses.append(float(metrics["loss"]))
            wire = wire or comm.wire_bytes()
        named = {k: v.detach() for k, v in model.named_parameters()}
        whole, round_trip = named, True
        if sharding is not None:
            whole = sharding.whole_tree(named)
            whole_opt = sharding.whole_opt(state["opt"])
            round_trip = (all(torch.equal(v, named[k]) for k, v in
                              sharding.local_tree(whole).items())
                          and all(torch.equal(v, state["opt"][m][k])
                                  for m in ("mu", "nu")
                                  for k, v in sharding.local_opt(whole_opt)[m].items()))
        rows = batch["tokens"].shape[0] // (shape[0] if len(shape) == 2 else shape[0] * shape[1])
        cell = ShapeSpec("cell", batch["tokens"].shape[1], batch["tokens"].shape[0], "train")
        art = dry_cell(arch_cfg.name, cell, MeshSpec(tuple(shape), ("data", "model"),
                                                     backend="gloo", rank=rank),
                       "mesh", variant, cfg=arch_cfg)
        out[variant] = {"losses": losses, "params": _np(whole), "stored": stored,
                        "stored_bytes": step.stored_bytes(state), "wire": wire,
                        "round_trip": round_trip, "dry": art, "rows": rows}
    return out


def fallback_decode(rank, world, tmp, shape, runs, tree, prompt, max_new, max_len):
    """For each ``(arch_cfg, serve_bf16)`` of ``runs``:
    ``ServeEngine(cache_seq_fallback=True)`` greedy generation of a
    ``REDUCED`` LM on a ``shape`` mesh: the tokens and the last logits, and
    the wire bytes of one decode step, beside the dry run's reckoning of the
    ``servefix`` cell when the weights are bf16."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.config import ShapeSpec
    from repro_torch.dist import comm
    from repro_torch.launch.dryrun import dry_cell
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.models import Model
    from repro_torch.serve.engine import ServeEngine

    mesh = _mesh_of(shape)
    out = []
    for arch_cfg, serve_bf16 in runs:
        model = params_from_numpy(Model(arch_cfg, device="cpu"), tree)
        engine = ServeEngine(model, max_len=max_len, device="cpu", mesh=mesh,
                             cache_seq_fallback=True, serve_bf16=serve_bf16)
        toks, logits = engine.generate({"tokens": torch.from_numpy(prompt)}, max_new)
        caches = engine.caches(prompt.shape[0])
        comm.reset_wire_bytes()
        engine.decode(torch.from_numpy(prompt[:, :1]), caches, max_len - 1)
        wire = comm.wire_bytes()
        art = None
        if serve_bf16:  # the dry run's servefix: bf16 weights and the fallback
            art = dry_cell(arch_cfg.name, ShapeSpec("cell", max_len, prompt.shape[0], "decode"),
                           MeshSpec(tuple(shape), ("data", "model"), backend="gloo", rank=rank),
                           "mesh", "servefix", cfg=arch_cfg)
        out.append({"tokens": toks.numpy(), "logits": logits.float().numpy(), "wire": wire,
                    "dry": art})
    return out
