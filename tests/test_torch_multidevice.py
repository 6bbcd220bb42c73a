"""The port's data- and tensor-parallel training, MoE all-to-all and
elastic restore on CPU ``gloo`` ranks, against the JAX package's
single-device outputs.

Each world is spawned once for the module (``launch.mesh.spawn_ranks``: a
``FileStore`` in a temporary directory, one intra-op thread a rank), and
its ranks run ``torch_ranks.py``, which imports no JAX; the reference's
outputs are computed here, once.

* The sharded step of the llama3.2-1b and gpt3-xl smoke twins at (data,
  model) = (2, 2) and (1, 4): the global loss within rtol 1e-5 of the
  reference's ``jax.value_and_grad`` (``torch_parity.jref``), the gathered
  gradients per leaf within ``GRAD_RTOL`` 1e-4 of each leaf's largest
  value, a 3-step loss curve within ``CURVE_TOL`` 1e-4 of the
  reference's jitted ``make_train_step`` with a clip that binds (its norm
  ~0.94 against ``grad_clip_norm`` 0.05) and the final parameters within
  1% of the distance AdamW can move them (``PARAM_ATOL``), and
  each rank's blocks at the shapes the reference's specs imply.  At
  (1, 4) the smoke twins' 4 query heads split over the model axis and
  their 2 KV heads do not (each rank projects the KV head its query head
  reads); vocab 257 is gathered replicated.
* The same sharded loss and gradients in bf16 compute from the same
  float32 masters, against the port's unsharded bf16 step: the
  row-parallel partial sums and the FSDP gradients then add in bf16 across
  the ranks, as they add under nccl on a multi-card host (gloo sums in the
  tensor's dtype too): the loss within rtol 1e-4, each gradient leaf
  within ``chip_smoke.py``'s ``MD_GRAD_TOL``.
* ``moe_all_to_all_sharded`` at 4 ranks (E 8, K 2, T 64, d 16, ff 32, the
  reference test's sizes) against the dense einsum (1e-4) at capacity 8.0,
  and at ``capacity_factor`` 2.0 with routing skewed so that assignments
  drop, against the reference's own ``moe_all_to_all_sharded`` in a
  4-device JAX subprocess on ``AxisType.Auto`` axes (its tests build
  ``jax.make_mesh``'s default Explicit axes, which ``shard_map`` refuses
  without ``jax.set_mesh``).  The exchange's gradient against the dense
  combine's.
* The MoE and VLM families' sharded loss (granite-moe-1b-a400m's smoke
  twin at capacity factor ``MOE_CAPACITY`` 1.0, where pairs drop;
  internvl2-1b's with 8 patch rows a row; granite again on 3 rows, which
  do not split over the (2, 2) mesh's data axis and stay whole on each
  data rank, as the rules leave them; llama4-scout-17b-a16e's, one local
  layer at window 32 and one global layer, 4 experts top-1 with the
  shared expert, at the same capacity on rows of 48, past the window, its
  local layer's window in the flash forward and backward), in the
  llama3.2-1b worlds:
  the loss, the cross entropy and the three aux terms (load balance,
  router z-loss, dropped fraction: global means over the data ranks)
  within ``LOSS_RTOL`` of the reference's ``jax.value_and_grad``, every
  gathered gradient within ``GRAD_RTOL``, the dropped fraction above 0
  and equal on every rank.
* The SSM, hybrid and encoder-decoder families' sharded loss
  (mamba2-370m's, zamba2-7b's and seamless-m4t-medium's smoke twins, the
  last with 12 frames a row), in the same worlds: ``inner`` over
  ``model`` in whole heads (at (1, 4) mamba2's 8 heads 2 a rank, zamba2's
  B/C columns of one group a rank), the gate norm's sum of squares
  summed over ``model``, the hybrid's shared block made whole at each
  application, the encoder's and decoder's layers (cross-attention's
  memory entering through f); the loss and cross entropy within
  ``LOSS_RTOL`` of the reference's ``jax.value_and_grad`` and every
  gathered gradient within ``GRAD_RTOL``.  The smoke twins' SSD decays
  (A = -1, dt near 0.01) keep the reference's gradient finite.
* A state saved by ``save_sharded`` at (2, 2) restores through
  ``reshard_restore`` at (2, 1) and (1, 2), equal bit for bit after
  gathering (copies: an exact comparison).
"""
import dataclasses
import math
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jsh
from repro.train import OptimizerConfig as JaxOptConfig
from repro.train import make_train_step as jax_make_train_step
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro.train.step import TrainState as JaxTrainState
from repro_torch.launch.mesh import MeshSpec, spawn_ranks
from repro_torch.parallel.sharding import local_shape, param_specs
from repro_torch.train import loss_and_grads
from repro_torch.tree import flatten
import torch_ranks
from torch_parity import jref, twin

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("llama3.2-1b", "gpt3-xl")
MESHES = ((2, 2), (1, 4))
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4     # of each leaf's largest |value|
CURVE_TOL = 1e-4
STEPS = 3
OPT = dict(lr=1e-2, warmup_steps=2, decay_steps=100, grad_clip_norm=0.05)
PARAM_ATOL = 0.01 * OPT["lr"] * STEPS
# bf16 compute, sharded against unsharded (readings 1.3e-6-2.1e-5 and
# 1.2e-2-1.9e-2): the loss relative, each gradient leaf's largest
# |difference| relative to its largest |value| (the card's MD_GRAD_TOL)
BF16_LOSS_RTOL, BF16_GRAD_TOL = 1e-4, 5e-2
MOE = dict(E=8, K=2, T=64, d=16, ff=32)
# the MoE and VLM families' sharded loss: granite at a capacity where
# pairs drop
FAMILIES = {"granite-moe-1b-a400m": ("granite-moe-1b-a400m", 8),
            "internvl2-1b": ("internvl2-1b", 8),
            "granite 3 rows": ("granite-moe-1b-a400m", 3),
            "llama4-scout-17b-a16e": ("llama4-scout-17b-a16e", 8)}
# a case's sequence where the default of 32 will not do: llama4-scout's
# rows run past its local layer's window of 32
SEQ = {"llama4-scout-17b-a16e": 48}
# the SSM, hybrid and encoder-decoder families' sharded loss
SEQ_FAMILIES = {"mamba2-370m": ("mamba2-370m", 8),
                "zamba2-7b": ("zamba2-7b", 8),
                "seamless-m4t-medium": ("seamless-m4t-medium", 8)}
MOE_CAPACITY = 1.0
AUX = ("load_balance", "router_z", "dropped_frac")
MOE_FACTORS = (8.0, 2.0)


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(p.key) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in leaves}


def _batches(cfg, n=STEPS, B=8, S=32):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        out.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    return out


_REF = {}


def reference(arch):
    """The reference's loss and gradients on batch 0 and its jitted
    ``make_train_step`` over the batches (losses, grad norms, final
    parameters), from the smoke twin's weights."""
    if arch not in _REF:
        model, params, cfg, _, _ = twin(arch)
        batches = _batches(cfg)
        (loss, _), grads = jref(model).loss_grad(
            params, {k: jnp.asarray(v) for k, v in batches[0].items()},
            remat=True)
        step = jax.jit(jax_make_train_step(model, JaxOptConfig(**OPT),
                                           remat=True))
        state = JaxTrainState(params=params,
                              opt=jax_init_opt_state(params),
                              rng=jax.random.PRNGKey(0))
        losses, norms = [], []
        for b in batches:
            state, metrics = step(state, {k: jnp.asarray(v)
                                          for k, v in b.items()})
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        _REF[arch] = dict(loss=float(loss), grads=_flat(grads),
                          losses=losses, norms=norms,
                          params=_flat(state.params), batches=batches,
                          weights=_flat(params), model=model)
    return _REF[arch]


_FAMILY = {}


def family_reference(name):
    """A MoE or VLM twin's reference loss, metrics and gradients on a
    seeded batch (granite at ``MOE_CAPACITY``), and the case the ranks
    get."""
    if name not in _FAMILY:
        arch, rows = {**FAMILIES, **SEQ_FAMILIES}[name]
        model, params, cfg, _, _ = twin(arch)
        changes = {}
        if cfg.is_moe:
            changes = {"moe": {"capacity_factor": MOE_CAPACITY}}
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=MOE_CAPACITY))
            model = jax_build_model(cfg, block_k=16)
        batch = _batches(cfg, n=1, B=rows, S=SEQ.get(name, 32))[0]
        if cfg.family == "vlm":
            rng = np.random.default_rng(5)
            batch["patch_embeds"] = rng.normal(size=(
                rows, cfg.vision_prefix_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "encdec":
            rng = np.random.default_rng(6)
            batch["frames"] = rng.normal(size=(
                rows, cfg.encoder_frontend_len, cfg.d_model)
            ).astype(np.float32)
        (loss, metrics), grads = jref(model).loss_grad(
            params, {k: jnp.asarray(v) for k, v in batch.items()},
            remat=True)
        _FAMILY[name] = dict(
            loss=float(loss), grads=_flat(grads),
            metrics={k: float(v) for k, v in metrics.items()},
            case=dict(name=name, arch=arch, changes=changes,
                      params=_flat(params), batch=batch))
    return _FAMILY[name]


def unsharded_bf16(arch):
    """The port's unsharded loss and gradients of batch 0 in bf16 compute,
    from the reference's float32 weights."""
    model = torch_ranks.smoke_twin_model(arch, "bfloat16")
    ref = reference(arch)
    loss, _, grads = loss_and_grads(
        model, torch_ranks._tensors(model, ref["weights"]),
        ref["batches"][0])
    return float(loss), torch_ranks._np(grads)


def _moe_inputs(skew: bool):
    """The reference test's inputs (seed 0); with ``skew`` the router
    favours the experts of rank 0 so that its buckets overflow at
    capacity 2.0."""
    E, K, T, d, ff = (MOE[k] for k in ("E", "K", "T", "d", "ff"))
    rng = np.random.default_rng(0)
    xt = rng.normal(size=(T, d)).astype(np.float32)
    logits = rng.normal(size=(T, E)).astype(np.float32)
    if skew:
        logits[:, :2] += 2.0
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    top_e = np.argsort(-probs, axis=-1, kind="stable")[:, :K]
    top_w = np.take_along_axis(probs, top_e, -1)
    top_w = (top_w / top_w.sum(-1, keepdims=True)).astype(np.float32)
    w1 = (rng.normal(size=(E, d, ff)) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(E, ff, d)) * 0.1).astype(np.float32)
    return dict(xt=xt, top_e=top_e.astype(np.int32), top_w=top_w, w1=w1,
                w2=w2)


def _dense_moe(inp):
    """The reference test's dense combine: every expert on every token,
    weighted by the gates; and its gradient of sum(y^2) in xt and w1."""
    def f(xt, w1):
        h = jnp.einsum("td,edf->etf", xt, w1)
        y_all = jnp.einsum("etf,efd->etd", jax.nn.relu(h), inp["w2"])
        T = xt.shape[0]
        gates = jnp.zeros((T, MOE["E"])).at[
            jnp.arange(T)[:, None], inp["top_e"]].set(inp["top_w"])
        return jnp.einsum("te,etd->td", gates, y_all)
    y = f(inp["xt"], inp["w1"])
    gx, gw = jax.grad(lambda a, b: (f(a, b) ** 2).sum(), (0, 1))(
        inp["xt"], inp["w1"])
    return np.asarray(y), np.asarray(gx), np.asarray(gw)


_JAX_A2A = r"""
import sys, numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.parallel.collectives import moe_all_to_all_sharded
inp = dict(np.load(sys.argv[1]))
mesh = jax.make_mesh((4,), ("model",), axis_types=(AxisType.Auto,))

def act(local_eid, x, weights):
    w1_l, w2_l = weights
    h = jnp.einsum("td,tdf->tf", x, w1_l[local_eid])
    return jnp.einsum("tf,tfd->td", jax.nn.relu(h), w2_l[local_eid])
out = moe_all_to_all_sharded(
    mesh, jnp.asarray(inp["xt"]), jnp.asarray(inp["top_e"]),
    jnp.asarray(inp["top_w"]), (jnp.asarray(inp["w1"]),
    jnp.asarray(inp["w2"])), act, n_experts=int(inp["w1"].shape[0]),
    capacity_factor=float(sys.argv[3]))
np.save(sys.argv[2], np.asarray(out))
"""


def _reference_a2a(inp, cf):
    """The reference's ``moe_all_to_all_sharded`` on 4 host devices."""
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npy")
        np.savez(src, **inp)
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_"
                   "count=4", PYTHONPATH=os.path.join(REPO, "src"),
                   JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "-c", _JAX_A2A, src, dst,
                               str(cf)], env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return np.load(dst)


@pytest.fixture(scope="module")
def worlds():
    """Every world's results: (arch, mesh) -> per-rank outputs; the
    (1, 4) llama world also runs the MoE exchange, the (2, 2) llama world
    saves its final state, restored by a (2, 1) and a (1, 2) world.  The
    worlds of a stage run side by side (most of a world's seconds are its
    processes' start and their first collectives' connections)."""
    jobs = {}
    with tempfile.TemporaryDirectory() as ckpt:
        for arch in ARCHS:
            ref = reference(arch)
            for mesh in MESHES:
                job = dict(arch=arch, mesh=mesh, params=ref["weights"],
                           batches=ref["batches"], opt=OPT, bf16=True)
                if arch == "llama3.2-1b" and mesh == (1, 4):
                    job["moe"] = dict(_moe_inputs(skew=True),
                                      factors=MOE_FACTORS)
                if arch == "llama3.2-1b" and mesh == (2, 2):
                    job["save"] = ckpt
                if arch == "llama3.2-1b":
                    job["loss_cases"] = [family_reference(n)["case"]
                                         for n in (*FAMILIES,
                                                   *SEQ_FAMILIES)]
                jobs[arch, mesh] = (spawn_ranks, torch_ranks.train_world,
                                    math.prod(mesh), job)
        jobs["a2a"] = (_reference_a2a, _moe_inputs(skew=True), 2.0)
        out = _side_by_side(jobs)
        out.update(_side_by_side({
            ("restore", mesh): (spawn_ranks, torch_ranks.restore_world,
                                math.prod(mesh),
                                dict(arch="llama3.2-1b", mesh=mesh,
                                     dir=ckpt))
            for mesh in ((2, 1), (1, 2))}))
    return out


def _side_by_side(jobs):
    """key -> fn(*args) for ``jobs`` {key: (fn, *args)}, run in threads."""
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {key: pool.submit(*job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def _leaf_err(got, ref):
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_loss_and_grads_match_reference(worlds, arch, mesh):
    ref, r0 = reference(arch), worlds[arch, mesh][0]
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert set(r0["grads"]) == set(ref["grads"])
    for path, g in r0["grads"].items():
        assert g.shape == ref["grads"][path].shape, path
        err = _leaf_err(g, ref["grads"][path])
        assert err <= GRAD_RTOL, f"{path}: {err:.3e} > {GRAD_RTOL}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_bf16_sums_match_unsharded_bf16(worlds, arch, mesh):
    loss, grads = worlds[arch, mesh][0]["bf16"]
    want_loss, want = unsharded_bf16(arch)
    np.testing.assert_allclose(loss, want_loss, rtol=BF16_LOSS_RTOL)
    assert set(grads) == set(want)
    for path, g in grads.items():
        err = _leaf_err(g, want[path])
        assert err <= BF16_GRAD_TOL, f"{path}: {err:.3e} > {BF16_GRAD_TOL}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_curve_with_binding_clip_matches_reference(worlds, arch,
                                                          mesh):
    ref, r0 = reference(arch), worlds[arch, mesh][0]
    assert min(ref["norms"]) > 10 * OPT["grad_clip_norm"]   # it binds
    np.testing.assert_allclose(r0["norms"], ref["norms"], rtol=1e-4)
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=0,
                               atol=CURVE_TOL)
    assert r0["step"] == STEPS
    # AdamW moves an element by up to ~lr a step whatever its gradient's
    # size, so f32 rounding in a near-zero gradient can move it apart;
    # a block updated wrongly would part by the order of lr
    for path, p in r0["params"].items():
        diff = float(np.abs(p - ref["params"][path]).max())
        assert diff <= PARAM_ATOL, f"{path}: {diff:.3e}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_the_blocks_its_specs_say(worlds, arch, mesh):
    model = reference(arch)["model"]
    sizes = MeshSpec(dp=mesh[0], tp=mesh[1]).axes()
    amesh = jax.sharding.AbstractMesh(mesh, ("data", "model"))
    specs = jax.tree_util.tree_flatten_with_path(
        jsh.param_specs(model, amesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    shapes = {"/".join(str(p.key) for p in path): tuple(leaf.shape)
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  model.abstract_params())[0]}
    ranks = worlds[arch, mesh]
    split = 0
    for path, spec in ((("/".join(str(p.key) for p in pth)), tuple(s))
                       for pth, s in specs):
        want = local_shape(shapes[path], spec, sizes)
        split += want != shapes[path]
        for r in ranks:
            assert r["shapes"][path] == want, (path, spec)
    assert split > 0
    assert sorted(r["data_index"] for r in ranks) == sorted(
        d for d in range(mesh[0]) for _ in range(mesh[1]))
    wire = ranks[0]["wire"]                 # FSDP's only on a data axis
    assert (wire["all-gather"] > 0) == (wire["reduce-scatter"] > 0) \
        == (mesh[0] > 1)
    assert wire["all-reduce"] > 0           # g, f, the loss and the norm
    assert wire["all-to-all"] == 0


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", FAMILIES)
def test_moe_and_vlm_sharded_loss_and_grads_match_reference(worlds, name,
                                                            mesh):
    ref = family_reference(name)
    arch = FAMILIES[name][0]
    ranks = worlds["llama3.2-1b", mesh]
    r0 = ranks[0]["loss_cases"][name]
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=LOSS_RTOL)
    keys = ("ce_loss", "loss") + (AUX if twin(arch)[2].is_moe else ())
    assert set(r0["metrics"]) == set(ref["metrics"]) == set(keys)
    for k in keys:
        np.testing.assert_allclose(r0["metrics"][k], ref["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
        assert len({r["loss_cases"][name]["metrics"][k]
                    for r in ranks}) == 1, k
    if "dropped_frac" in keys:
        assert r0["metrics"]["dropped_frac"] > 0      # pairs drop
    assert set(r0["grads"]) == set(ref["grads"])
    for path, g in r0["grads"].items():
        err = _leaf_err(g, ref["grads"][path])
        assert err <= GRAD_RTOL, f"{path}: {err:.3e} > {GRAD_RTOL}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("name", SEQ_FAMILIES)
def test_ssm_hybrid_encdec_sharded_loss_and_grads_match_reference(
        worlds, name, mesh):
    ref = family_reference(name)
    assert all(np.isfinite(g).all() for g in ref["grads"].values())
    ranks = worlds["llama3.2-1b", mesh]
    r0 = ranks[0]["loss_cases"][name]
    np.testing.assert_allclose(r0["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert set(r0["metrics"]) == set(ref["metrics"]) == {"ce_loss", "loss"}
    for k in ("ce_loss", "loss"):
        np.testing.assert_allclose(r0["metrics"][k], ref["metrics"][k],
                                   rtol=LOSS_RTOL, err_msg=k)
        assert len({r["loss_cases"][name]["metrics"][k]
                    for r in ranks}) == 1, k
    assert set(r0["grads"]) == set(ref["grads"])
    for path, g in r0["grads"].items():
        assert g.shape == ref["grads"][path].shape, path
        err = _leaf_err(g, ref["grads"][path])
        assert err <= GRAD_RTOL, f"{path}: {err:.3e} > {GRAD_RTOL}"


def test_moe_all_to_all_matches_dense_combine(worlds):
    ranks = worlds["llama3.2-1b", (1, 4)]
    inp = _moe_inputs(skew=True)
    dense, gx, gw = _dense_moe(inp)
    for r in ranks:                   # capacity 8.0: nothing drops
        y, dropped = r["moe"][8.0]
        assert dropped == 0
        assert float(np.abs(y - dense).max()) < 1e-4
    np.testing.assert_allclose(sum(r["moe"]["grads"][0] for r in ranks), gx,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(sum(r["moe"]["grads"][1] for r in ranks), gw,
                               rtol=1e-4, atol=1e-4)


def test_moe_all_to_all_drops_as_the_reference(worlds):
    ranks = worlds["llama3.2-1b", (1, 4)]
    inp = _moe_inputs(skew=True)
    dense = _dense_moe(inp)[0]
    ref = worlds["a2a"]
    assert sum(r["moe"][2.0][1] for r in ranks) > 0     # drops occur
    for r in ranks:
        y = r["moe"][2.0][0]
        assert float(np.abs(y - ref).max()) < 1e-4
    assert float(np.abs(ref - dense).max()) > 1e-2     # and change y


def test_all_reduce_of_a_strided_tensor_is_contiguous(worlds):
    ranks = worlds["llama3.2-1b", (1, 4)]
    want = np.arange(12.0).reshape(3, 4).T * sum(range(1, len(ranks) + 1))
    for r in ranks:
        got, contiguous = r["moe"]["all_reduce"]
        assert contiguous
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mesh", [(2, 1), (1, 2)],
                         ids=lambda m: "x".join(map(str, m)))
def test_state_saved_at_2x2_restores_exactly(worlds, mesh):
    saved, got = worlds["llama3.2-1b", (2, 2)][0], \
        worlds["restore", mesh]
    r0 = got[0]
    assert r0["index_step"] == STEPS and r0["step"] == STEPS
    for key in ("params", "m", "v"):
        for path, want in saved[key].items():
            assert np.array_equal(r0[key][path], want), (key, path)
    # each rank holds the blocks of the new mesh's specs
    specs = dict(flatten(param_specs(twin("llama3.2-1b")[3],
                                     MeshSpec(dp=mesh[0], tp=mesh[1]))))
    for r in got:
        for path, shape in r["shapes"].items():
            assert shape == local_shape(r0["params"][path].shape,
                                        specs[path], got[0]["sizes"])
    assert got[0]["shapes"] != worlds["llama3.2-1b", (2, 2)][0]["shapes"]
