"""The port's count of a step (``repro_torch.hw.step_count``) and the
calibration it feeds (``core.calibrate_workload_against_count``), against
the JAX package's ``hw/hlo_parse.py:analyze_hlo`` on the CPU.

* A 64 x 64 x 64 product calibrates to 1.0 against its analytic
  ``KernelSpec``, as ``tests/test_train_plan.py`` holds the reference's
  HLO calibration.
* On the llama3.2-1b and gpt3-xl smoke twins (remat off) the counted
  forward FLOPs on fake tensors equal ``analyze_hlo`` of the reference's
  jitted forward loss less the head's pad term: the reference pads the
  head's weight to a multiple of 512 columns before the product
  (``src/repro/models/common.py:unembed``), the port pads the logits
  after it, so the reference multiplies 2 · B · S · d · (V_pad - V) more.
* ``torch._grouped_mm`` (the MoE experts) is counted by the port's
  formula, which ``FlopCounterMode`` lacks.
* The backward is not held to ``analyze_hlo``: its trip-count-corrected
  parse over-counts the reference's gradient HLO (more than 5x its own
  forward, where no backward of plain matrix products costs more than
  twice the forward).  The port's backward is held to its own algorithm.
"""
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import jax
import jax.numpy as jnp
from repro.configs import get_config as jax_get_config
from repro.core import calibrate_workload_against_hlo
from repro.core.power_model import KernelSpec as JaxKernelSpec
from repro.hw.hlo_parse import analyze_hlo
from repro.models import build_model as jax_build_model
from repro_torch import core as tcore
from repro_torch import dvfs as tdvfs
from repro_torch import kernels
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.hw.step_count import (count_step, count_train_step,
                                       fake_like, grouped_mm_flop)
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_prefill,
                                                 paged_flash_decode)
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import build_model
from repro_torch.train import OptimizerConfig, make_train_step
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.step import TrainState
from repro_torch.tree import flatten
from torch_parity import twin

B, S = 2, 64
VOCAB_PAD = 512            # src/repro/models/common.py:_VOCAB_PAD
DENSE = ("llama3.2-1b", "gpt3-xl")
MOE = "granite-moe-1b-a400m"


def fake(*shape, dtype=torch.float32):
    """An empty CPU tensor: a fake one inside a ``FakeTensorMode``."""
    return torch.empty(shape, dtype=dtype)


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S))
    t = torch.tensor(toks, dtype=torch.int32)
    return {"tokens": t, "targets": t}


def _fake_batch():
    t = torch.zeros((B, S), dtype=torch.int32)
    return {"tokens": t, "targets": t}


def _fake_twin(cfg):
    """The smoke twin's model (``cfg``: ``twin(arch)[2]``, made outside the
    mode, whose real weights ``twin`` keeps) and its parameters as fake CPU
    tensors (``abstract_params``); call it inside a ``FakeTensorMode``."""
    model = build_model(cfg, block_k=16, device="cpu")
    return model, fake_like(model.abstract_params())


_HLO = {}


def _reference_flops(arch, grad=False):
    """``analyze_hlo`` of the reference's jitted forward loss (remat off)
    on the twin, or of its ``value_and_grad``; memoized."""
    if (arch, grad) not in _HLO:
        model, params, cfg, _, _ = twin(arch)
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in _batch(cfg.vocab_size).items()}

        def loss(p, b):
            return model.loss(p, b, remat=False)[0]
        fn = jax.value_and_grad(loss) if grad else loss
        hlo = jax.jit(fn).lower(params, batch).compile().as_text()
        _HLO[arch, grad] = analyze_hlo(hlo).flops
    return _HLO[arch, grad]


@pytest.mark.parametrize("arch", ["llama3.2-1b", MOE, "mamba2-370m",
                                  "zamba2-7b", "seamless-m4t-medium"])
def test_abstract_params_are_the_references(arch):
    """Each family's ``abstract_params(dtype=param_dtype)`` at full width:
    meta tensors, nothing allocated, with the reference's
    ``abstract_params()`` leaves, shapes and dtypes (the f32 masters);
    without ``dtype``, the dtypes ``init`` gives a serving model."""
    model = build_model(get_config(arch), device="meta")
    got = {path: (tuple(t.shape), str(t.dtype).removeprefix("torch."),
                  t.device.type)
           for path, t in flatten(model.abstract_params(model.param_dtype))}
    ref = jax_build_model(jax_get_config(arch)).abstract_params()
    want = {"/".join(str(k.key) for k in path):
            (tuple(leaf.shape), str(leaf.dtype), "meta")
            for path, leaf in jax.tree_util.tree_leaves_with_path(ref)}
    assert got == want
    serving = flatten(model.abstract_params())
    assert all(t.dtype == model.leaf_dtype(path.split("/")[-1])
               for path, t in serving)


def test_product_calibrates_to_one():
    M = N = K = 64
    with FakeTensorMode():
        count = count_step(torch.matmul, fake(M, K), fake(K, N))
    spec = tcore.KernelSpec(name="gemm", kind="gemm", flops=2.0 * M * N * K,
                            hbm_bytes=4.0 * (M * K + K * N + M * N))
    cal = tcore.calibrate_workload_against_count([spec], count)
    assert cal["counted_flops"] == 2 * M * N * K
    assert cal["counted_hbm_bytes"] == 4 * (M * K + K * N + M * N)
    assert cal["flops_ratio"] == 1.0 and cal["hbm_ratio"] == 1.0
    # the reference's HLO reads the same dot
    hlo = jax.jit(lambda a, b: a @ b).lower(
        jnp.zeros((M, K), jnp.float32),
        jnp.zeros((K, N), jnp.float32)).compile().as_text()
    ref = calibrate_workload_against_hlo(
        [JaxKernelSpec(name="gemm", kind="gemm", flops=2.0 * M * N * K,
                       hbm_bytes=4.0 * (M * K + K * N + M * N))], hlo)
    assert ref["hlo_flops"] == cal["counted_flops"]
    assert ref["analytic_flops"] == cal["analytic_flops"]
    assert count.collective_bytes == {}
    assert count.by_op["aten.mm"] == {"calls": 1.0, "flops": 2.0 * M * N * K,
                                      "hbm_bytes": 4.0 * (M * K + K * N
                                                          + M * N)}


def test_hbm_bytes_rules():
    """Operands and results each once an op, over the elements their
    strides reach; views and allocations move nothing; an in-place op
    reads and writes its target."""
    with FakeTensorMode():
        x, y, b = fake(64, 64), fake(64, 64), fake(64)
        n = 64 * 64 * 4
        assert count_step(torch.add, x, y).hbm_bytes == 3 * n
        assert count_step(torch.mul, x, x).hbm_bytes == 2 * n
        assert count_step(torch.add, x, b).hbm_bytes == 2 * n + 64 * 4
        assert count_step(lambda: x.reshape(4096)[:10].unsqueeze(0).t()) \
            .hbm_bytes == 0
        # a reshape that cannot be a view copies
        assert count_step(lambda: x.t().reshape(4096)).hbm_bytes == 2 * n
        assert count_step(lambda: torch.empty(64, 64)).hbm_bytes == 0
        assert count_step(lambda: x.add_(y)).hbm_bytes == 3 * n
        assert count_step(lambda: x.expand(8, 64, 64).sum()).hbm_bytes \
            == n + 4
        bf = count_step(lambda: x.to(torch.bfloat16))
    assert bf.hbm_bytes == n + n // 2 and bf.flops == 0


@pytest.mark.parametrize("arch", DENSE)
def test_forward_flops_equal_analyze_hlo_less_the_pad(arch):
    cfg = twin(arch)[2]
    with FakeTensorMode():
        model, params = _fake_twin(cfg)
        count = count_step(model.loss, params, _fake_batch(), remat=False)
    v_pad = -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD
    pad = 2 * B * S * cfg.d_model * (v_pad - cfg.vocab_size)
    assert pad == 4_177_920
    assert count.flops == _reference_flops(arch) - pad
    assert set(k for k, v in count.by_op.items() if v["flops"]) \
        == {"aten.mm", "aten.bmm"}


@pytest.mark.parametrize("arch", DENSE)
def test_fake_count_equals_real_count(arch):
    """The forward loss and a whole train step (AdamW, remat, 2
    micro-batches) dispatch the same ops on fake tensors as on the twin's
    real CPU tensors: equal FLOPs, bytes and per-op counts."""
    _, _, cfg, tmodel, tparams = twin(arch)
    real = count_step(tmodel.loss, tparams, _batch(cfg.vocab_size),
                      remat=False)
    # the twins train in float32: their CPU weights are the masters
    params = torch.utils._pytree.tree_map(torch.clone, tparams)
    step = make_train_step(tmodel, OptimizerConfig(), accum_steps=2,
                           remat=True)
    steps = [count_step(step, TrainState(params=params,
                                         opt=init_opt_state(params),
                                         rng=None), _batch(cfg.vocab_size))]
    with FakeTensorMode():
        fmodel, fparams = _fake_twin(cfg)
        assert count_step(fmodel.loss, fparams, _fake_batch(),
                          remat=False) == real
        params = fake_like(fmodel.abstract_params(fmodel.param_dtype))
        step = make_train_step(fmodel, OptimizerConfig(), accum_steps=2,
                               remat=True)
        steps.append(count_step(step, TrainState(
            params=params, opt=init_opt_state(params), rng=None),
            _fake_batch()))
    assert steps[0].flops == steps[1].flops > 3 * real.flops
    assert steps[0].hbm_bytes == steps[1].hbm_bytes
    assert steps[0].by_op == steps[1].by_op


def test_grouped_mm_formula():
    """One call counts 2 · M · K · N (``FlopCounterMode`` alone counts
    none); the weight gradient's form, (K, M) x (M, N) -> (G, K, N), the
    same product."""
    M, K, N, G = 48, 64, 32, 4
    with FakeTensorMode():
        a = fake(M, K, dtype=torch.bfloat16)
        w = fake(G, K, N, dtype=torch.bfloat16)
        offs = fake(G, dtype=torch.int32)
        count = count_step(torch._grouped_mm, a, w, offs=offs)
        with FlopCounterMode(display=False) as plain:
            torch._grouped_mm(a, w, offs=offs)
    assert count.flops == 2 * M * K * N
    assert count.by_op["aten._grouped_mm"]["flops"] == 2 * M * K * N
    assert plain.get_total_flops() == 0
    assert grouped_mm_flop((K, M), (M, N)) == 2 * M * K * N
    assert grouped_mm_flop((G, M, K), (G, K, N)) == 2 * G * M * K * N


def test_granite_forward_counts_its_experts():
    """The granite twin's forward (its real f32 CPU tensors:
    ``_grouped_mm``'s meta kernel, which fake tensors run, takes bf16
    only) counts 3 · 2 · T · K · d · d_ff more per MoE layer with the
    formula than without: the three expert products over all T · K routed
    pairs, dropped pairs included, as the port computes them.  At full
    width in bf16 on fake tensors the experts' share is counted the same
    way."""
    _, _, cfg, tmodel, tparams = twin(MOE)
    batch = _batch(cfg.vocab_size)
    count = count_step(tmodel.loss, tparams, batch, remat=False)
    with FlopCounterMode(display=False) as plain:
        tmodel.loss(tparams, batch, remat=False)
    T, K = B * S, cfg.moe.top_k
    experts = cfg.n_layers * 3 * 2 * T * K * cfg.d_model * cfg.d_ff
    assert count.flops - plain.get_total_flops() == experts
    assert count.by_op["aten._grouped_mm"]["flops"] == experts
    full = get_config(MOE)
    with FakeTensorMode():
        model = build_model(full, device="cpu")
        count = count_step(model.loss, fake_like(model.abstract_params()),
                           _fake_batch(), remat=False)
    assert count.by_op["aten._grouped_mm"]["flops"] == full.n_layers * 3 \
        * 2 * T * full.moe.top_k * full.d_model * full.d_ff


@pytest.mark.parametrize("arch", DENSE)
def test_backward_is_held_to_the_port_not_to_analyze_hlo(arch):
    """The port's gradient (remat off) counts three times the forward's
    products and the plain attention backward's recompute of its scores
    (5 products where the forward has 2: half the attention's forward
    again).  The reference's parse of its own gradient HLO reads more
    than 5x its forward (the over-count of ``ROADMAP.md`` queue 3): it is
    no oracle for a backward."""
    cfg = twin(arch)[2]
    with FakeTensorMode():
        model, params = _fake_twin(cfg)
        batch = _fake_batch()
        fwd = count_step(model.loss, params, batch, remat=False)
        leaves = [t.requires_grad_() for t in
                  torch.utils._pytree.tree_leaves(params)]

        def grad():
            loss, _ = model.loss(params, batch, remat=False)
            torch.autograd.grad(loss, leaves)
        count = count_step(grad)
    attn = fwd.by_op["aten.bmm"]["flops"]
    assert count.flops == 3 * fwd.flops + attn // 2
    assert _reference_flops(arch, grad=True) > 5 * _reference_flops(arch)


def test_no_kernel_counter_moves_on_fake_tensors():
    """Each wrapper sends a fake CPU tensor to its plain version (at shapes
    and widths no kernel is built for, too) and counts no launch; a whole
    train step counted on fake tensors launches nothing."""
    kernels.reset_launch_counts()
    bf = torch.bfloat16
    with FakeTensorMode():
        assert rmsnorm(fake(4, 64, dtype=bf), fake(64)).shape == (4, 64)
        q, kv = fake(2, 40, 4, 16, dtype=bf), fake(2, 40, 2, 16, dtype=bf)
        assert flash_prefill(q, kv, kv).shape == q.shape
        lse = fake(2, 4, 40)
        assert [t.shape for t in flash_attention_bwd(q, kv, kv, q, q,
                                                     lse)] \
            == [q.shape, kv.shape, kv.shape]
        pages = fake(6, 16, 2, 16, dtype=bf)
        out = paged_flash_decode(fake(2, 1, 4, 16, dtype=bf), pages, pages,
                                 fake(2, 3, dtype=torch.int32),
                                 fake(2, dtype=torch.int32))
        assert out.shape == (2, 1, 4, 16)
        y, h = ssd_scan(fake(2, 40, 4, 16), fake(2, 40, 4),
                        fake(2, 40, 1, 8), fake(2, 40, 1, 8), 16)
        assert (y.shape, h.shape) == ((2, 40, 4, 16), (2, 4, 8, 16))
    count_train_step(twin("gpt3-xl")[2], global_batch=4, seq_len=32,
                     accum_steps=2)
    assert set(kernels.launch_counts().values()) == {0}


def test_count_calibration_feeds_the_plan(tmp_path):
    """``plan_train_bundle(..., step_count=)`` stores the calibration in
    the bundle's meta as ``count_calibration``; it rides the plan's JSON."""
    cfg = get_config("llama3.2-1b")
    shape = ShapeConfig(name="t", seq_len=128, global_batch=2, kind="train")
    count = count_train_step(cfg, global_batch=2, seq_len=128)
    chip = tcore.get_chip("h100")
    bundle = tcore.plan_train_bundle(cfg, chip, shape=shape, n_reps=1,
                                     step_count=count)
    want = tcore.calibrate_workload_against_count(
        tcore.WorkloadBuilder(cfg, shape, include_optimizer=True).build(),
        count)
    cal = bundle.meta["count_calibration"]
    assert cal == want
    assert cal["counted_flops"] == count.flops > 0
    assert 0.5 < cal["flops_ratio"] < 2.0 and cal["hbm_ratio"] > 0
    path = str(tmp_path / "plan.json")
    plan = tdvfs.DvfsPlan.from_train_bundle(bundle)
    plan.save(path)
    assert tdvfs.DvfsPlan.load(path).meta["count_calibration"] == cal
