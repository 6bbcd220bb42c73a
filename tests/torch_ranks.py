"""What each rank of ``test_torch_multidevice.py``'s worlds runs.

A separate module, importing neither JAX nor the JAX package: every
spawned rank imports the module that holds its function, and these ranks
run the port alone.  The parent process computes the reference's outputs
and holds the ranks' results against them.
"""
import dataclasses

import torch

from repro_torch.ckpt import CheckpointManager, reshard_restore
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import build_model
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (gather_state, mesh_axes,
                                           param_specs, shard_state,
                                           state_shardings)
from repro_torch.parallel.serve_step import ShardedServe, gather_rows
from repro_torch.parallel.train_step import ShardedStep
from repro_torch.train import OptimizerConfig, TrainState, make_train_step
from repro_torch.train.optimizer import init_opt_state
from repro_torch.tree import flatten, unflatten_like


def smoke_twin_model(arch: str, compute_dtype: str = "float32", **changes):
    """The port's smoke model of ``arch`` as ``conftest.smoke_model``
    builds the reference's (float32 compute unless ``compute_dtype`` says
    otherwise, ``block_k=16``), on the CPU; ``changes`` replace config
    fields (``attn_window``; ``moe`` as a dict of MoE fields)."""
    cfg = smoke_config(get_config(arch))
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, **changes["moe"])
    cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype, **changes)
    return build_model(cfg, block_k=16, device="cpu")


def _np(tree):
    return {path: t.detach().numpy().copy() for path, t in flatten(tree)}


def _tensors(model, flat):
    return unflatten_like(model.param_shapes(), [
        torch.from_numpy(flat[path]) for path, _ in
        flatten(model.param_shapes())])


def train_world(rank, world, job):
    """One rank of a (data, model) world: the sharded loss and gradients
    of ``job["batches"][0]``, then a sharded train step on each batch, and
    (with ``job["save"]``) a sharded save of the final state; with
    ``job["moe"]`` the MoE exchange over the mesh's ``model`` axis.
    Returns every rank's local parameter shapes and collective bytes, and
    on rank 0 the global loss, gradients, losses, grad norms and final
    state, gathered."""
    model = smoke_twin_model(job["arch"])
    mesh = make_host_mesh(*job["mesh"], device_type="cpu")
    specs = param_specs(model, mesh)
    params = _tensors(model, job["params"])
    local = shard_state(params, mesh, specs)
    plan = ShardedStep(model, mesh)
    coll.COUNTER.reset()
    loss, _, grads = plan.loss_and_grads(
        local, plan.local_batch(job["batches"][0]), remat=True)
    wire = dict(coll.COUNTER.bytes)
    full_grads = gather_state(grads, mesh, specs)
    state = TrainState(params=shard_state(params, mesh, specs), opt=None,
                       rng=torch.Generator().manual_seed(0))
    state.opt = init_opt_state(state.params)
    step = make_train_step(model, OptimizerConfig(**job["opt"]), remat=True,
                           mesh=mesh)
    losses, norms = [], []
    for batch in job["batches"]:
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    full = gather_state(state, mesh, state_shardings(model, mesh))
    if job.get("save"):
        CheckpointManager(job["save"]).save_sharded(
            len(losses), state, mesh, state_shardings(model, mesh))
    out = {"shapes": {p: tuple(t.shape) for p, t in flatten(state.params)},
           "data_index": plan.data_index, "wire": wire}
    if job.get("moe"):
        out["moe"] = moe_exchange(mesh, job["moe"])
    if job.get("loss_cases"):
        out["loss_cases"] = loss_cases(mesh, job["loss_cases"], rank)
    if job.get("bf16"):
        bf16 = bf16_loss_and_grads(mesh, job)
        if rank == 0:
            out["bf16"] = bf16
    if rank == 0:
        out.update(loss=float(loss), grads=_np(full_grads), losses=losses,
                   norms=norms, params=_np(full.params),
                   m=_np(full.opt["m"]), v=_np(full.opt["v"]),
                   step=int(full.opt["step"]))
    return out


def bf16_loss_and_grads(mesh, job):
    """The sharded loss and gathered gradients of ``job["batches"][0]`` in
    bf16 compute from the same float32 masters: the row-parallel partial
    sums and the FSDP gradients add in bf16 across the ranks, as the
    collectives add them under nccl."""
    model = smoke_twin_model(job["arch"], "bfloat16")
    specs = param_specs(model, mesh)
    plan = ShardedStep(model, mesh)
    loss, _, grads = plan.loss_and_grads(
        shard_state(_tensors(model, job["params"]), mesh, specs),
        plan.local_batch(job["batches"][0]), remat=True)
    return float(loss), _np(gather_state(grads, mesh, specs))


def loss_cases(mesh, cases, rank):
    """The sharded loss, metrics and gathered gradients of each case
    (``name``, ``arch``, config ``changes``, flat ``params``, global
    ``batch``) on the mesh; the full results on rank 0, the metrics on
    every rank."""
    out = {}
    for case in cases:
        model = smoke_twin_model(case["arch"], **case.get("changes", {}))
        specs = param_specs(model, mesh)
        plan = ShardedStep(model, mesh)
        loss, metrics, grads = plan.loss_and_grads(
            shard_state(_tensors(model, case["params"]), mesh, specs),
            plan.local_batch(case["batch"]), remat=True)
        full = gather_state(grads, mesh, specs)
        res = {"metrics": {k: float(v) for k, v in metrics.items()}}
        if rank == 0:
            res.update(loss=float(loss), grads=_np(full))
        out[case.get("name", case["arch"])] = res
    return out


def serve_world(rank, world, job):
    """One rank of a (data, model) world serving each case of
    ``job["cases"]`` (``name``, ``arch``, config ``changes``, flat
    ``params``, global ``tokens`` and ``extra`` (a VLM's patch rows, an
    encoder-decoder's frames), ``max_seq``,
    decode ``feed`` tokens (steps, B)) through ``ShardedServe``: the
    sharded prefill, then a decode step per row of ``feed``.  Returns per
    case the global logits of the prefill and of each decode step, the
    rank's cache block shapes and (rank 0) the prefill's cache gathered."""
    mesh = make_host_mesh(*job["mesh"], device_type="cpu")
    out = {}
    for case in job["cases"]:
        model = smoke_twin_model(case["arch"], **case.get("changes", {}))
        params = shard_state(_tensors(model, case["params"]), mesh,
                             param_specs(model, mesh))
        tokens = torch.from_numpy(case["tokens"])
        serve = ShardedServe(model, mesh, tokens.shape[0], case["max_seq"])
        extra = case.get("extra")
        extra = None if extra is None else serve.local_rows(
            torch.from_numpy(extra))
        logits, cache = serve.prefill(params, serve.local_rows(tokens),
                                      extra)
        full = gather_state(cache, mesh, serve.cache_specs)
        steps = [gather_rows(logits, serve).numpy()]
        pos = serve.local_rows(torch.full((tokens.shape[0],), case["pos"],
                                          dtype=torch.int32))
        for feed in case["feed"]:
            logits, cache = serve.decode_step(
                params, cache, serve.local_rows(torch.from_numpy(feed)), pos)
            steps.append(gather_rows(logits, serve).numpy())
            pos = pos + 1
        res = {"logits": steps,
               "shapes": {k: tuple(v.shape) for k, v in cache.items()}}
        if rank == 0:
            res["cache"] = {k: v.numpy() for k, v in full.items()}
        out[case["name"]] = res
    return out


def restore_world(rank, world, job):
    """One rank of a world that restores the checkpoint in ``job["dir"]``
    onto a ``job["mesh"]`` mesh and gathers it back; rank 0 returns the
    global parameters and moments and every rank its block shapes."""
    model = smoke_twin_model(job["arch"])
    mesh = make_host_mesh(*job["mesh"], device_type="cpu")
    specs = state_shardings(model, mesh)
    abstract = model.abstract_params(torch.float32)
    template = TrainState(params=abstract,
                          opt={"m": abstract, "v": abstract,
                               "step": torch.zeros((), dtype=torch.int32)},
                          rng=torch.Generator())
    state, index = reshard_restore(CheckpointManager(job["dir"]), template,
                                   mesh, specs)
    full = gather_state(state, mesh, specs)
    out = {"shapes": {p: tuple(t.shape) for p, t in flatten(state.params)},
           "sizes": mesh_axes(mesh), "index_step": index["step"]}
    if rank == 0:
        out.update(params=_np(full.params), m=_np(full.opt["m"]),
                   v=_np(full.opt["v"]), step=int(full.opt["step"]))
    return out


def moe_exchange(mesh, job):
    """``moe_all_to_all_sharded`` over the mesh's ``model`` axis on the
    reference test's shapes (global inputs from the parent); returns the
    global output and this rank's dropped assignments."""
    xt, top_e, top_w, w1, w2 = (torch.from_numpy(job[k]) for k in
                                ("xt", "top_e", "top_w", "w1", "w2"))
    E = w1.shape[0]

    def act(local_eid, x, weights):
        w1_l, w2_l = weights
        h = torch.einsum("td,tdf->tf", x, w1_l[local_eid])
        return torch.einsum("tf,tfd->td", torch.relu(h), w2_l[local_eid])
    group = mesh.get_group("model")
    ep, r = coll.group_size(group), coll.group_rank(group)
    out = {}
    for cf in job["factors"]:
        y = coll.moe_all_to_all_sharded(
            mesh, xt, top_e, top_w, (w1, w2), act, n_experts=E,
            capacity_factor=cf)
        tl = xt.shape[0] // ep
        out[cf] = (y.numpy(), coll.dropped_assignments(
            top_e[r * tl:(r + 1) * tl], n_experts=E, ep=ep,
            capacity_factor=cf))
    # the exchange is differentiable: grads reach the tokens and experts
    xg, w1g = xt.clone().requires_grad_(), w1.clone().requires_grad_()
    y = coll.moe_all_to_all_sharded(mesh, xg, top_e, top_w, (w1g, w2), act,
                                    n_experts=E, capacity_factor=8.0)
    (y * y).sum().backward()
    out["grads"] = (xg.grad.numpy(), w1g.grad.numpy())
    # a strided tensor's sum comes back contiguous (nccl takes no other)
    s = coll.all_reduce(torch.arange(12.0).reshape(3, 4).t() * (r + 1),
                        group)
    out["all_reduce"] = (s.numpy(), s.is_contiguous())
    return out
