"""The port's Mamba2 serving path against the JAX package's, on the CPU.

The SSD scan's plain version against the reference's Pallas kernel (in
interpret mode) and its sequential oracle, ``ssd_chunked`` with an initial
state, the conv and decode steps, ``mamba_block`` over ragged rows, the
mamba2-370m smoke model's prefill and decode, whole engine runs (token
streams, finish steps, executor-hook calls and trace events), the parameter
bridge, and the kernel wrapper's refusals.  The CUDA kernel itself is held
against the same plain version on the card by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_requests
from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.ssd_scan import ssd_ref as jax_ssd_sequential
from repro.models import common as jcm
from repro.models import ssm as jssm
from repro.obs import Tracer as JaxTracer
from repro.serve import ServeEngine as JaxEngine
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan import ssd_ref, ssd_scan
from repro_torch.models import build_model
from repro_torch.models import common as tcm
from repro_torch.models import ssm as tssm
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import unstack_layers
from repro_torch.obs import Tracer as TorchTracer
from repro_torch.serve import Request as TorchRequest
from repro_torch.serve import ServeEngine as TorchEngine
from torch_parity import (F32_TOL, LOGITS_TOL, SSD_TOL, RecordingExecutor,
                          np32, twin)

ARCH = "mamba2-370m"
RNG_SEED = 0


def _ssd_inputs(seed, B, S, H, P, G, N, h0=False):
    """Seeded f32 operands as numpy: x, a (log decay <= 0), B, C[, h0]."""
    rng = np.random.default_rng(seed)
    out = [rng.normal(size=(B, S, H, P)),
           -np.abs(rng.normal(size=(B, S, H))) * 0.1,
           rng.normal(size=(B, S, G, N)), rng.normal(size=(B, S, G, N))]
    if h0:
        out.append(rng.normal(size=(B, H, N, P)))
    return [a.astype(np.float32) for a in out]


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(32, 8), (40, 8), (16, 16), (24, 32)])
@pytest.mark.parametrize("G", [1, 2])
def test_ssd_scan_matches_reference_kernel(S, chunk, G):
    """The cases of ``tests/test_kernels.py::test_ssd_sweep``: the port's
    wrapper (its plain version on CPU tensors) against the reference's
    Pallas kernel in interpret mode and its sequential recurrence."""
    B, H, P, N = 2, 4, 8, 16
    x, a, Bm, Cm = _ssd_inputs(S * 10 + G, B, S, H, P, G, N)
    y, hf = ssd_scan(*map(torch.tensor, (x, a, Bm, Cm)), chunk)
    jy, jh = jax_ssd(*map(jnp.asarray, (x, a, Bm, Cm)), chunk=chunk,
                     interpret=True)
    rep = H // G
    sy, sh = jax_ssd_sequential(jnp.asarray(x), jnp.asarray(a),
                                jnp.repeat(jnp.asarray(Bm), rep, axis=2),
                                jnp.repeat(jnp.asarray(Cm), rep, axis=2))
    for got, want in ((y, jy), (hf, jh), (y, sy), (hf, sh)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(np32(got), np32(want), **SSD_TOL)


@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 32)])
def test_ssd_scan_matches_reference_kernel_at_state_64(S, chunk):
    """zamba2-7b's state 64 with 2 groups (heads 2 a group here): the
    plain version against the Pallas kernel in interpret mode."""
    B, H, P, G, N = 2, 4, 16, 2, 64
    x, a, Bm, Cm = _ssd_inputs(S + N, B, S, H, P, G, N)
    y, hf = ssd_scan(*map(torch.tensor, (x, a, Bm, Cm)), chunk)
    jy, jh = jax_ssd(*map(jnp.asarray, (x, a, Bm, Cm)), chunk=chunk,
                     interpret=True)
    for got, want in ((y, jy), (hf, jh)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(np32(got), np32(want), **SSD_TOL)


@pytest.mark.parametrize("S,chunk,G", [(40, 16, 1), (24, 32, 2),
                                       (64, 16, 2)])
def test_ssd_chunked_with_initial_state(S, chunk, G):
    B, H, P, N = 2, 4, 8, 16
    x, a, Bm, Cm, h0 = _ssd_inputs(S + G, B, S, H, P, G, N, h0=True)
    y, hf = tssm.ssd_chunked(*map(torch.tensor, (x, a, Bm, Cm)), chunk,
                             h0=torch.tensor(h0))
    jy, jh = jssm.ssd_chunked(*map(jnp.asarray, (x, a, Bm, Cm)), chunk,
                              h0=jnp.asarray(h0))
    np.testing.assert_allclose(np32(y), np32(jy), **SSD_TOL)
    np.testing.assert_allclose(np32(hf), np32(jh), **SSD_TOL)


@pytest.mark.parametrize("chunk", [4, 8, 16, 24])
def test_ssd_scan_is_chunk_size_invariant(chunk):
    """Any chunk length (a ragged last chunk included) gives what one chunk
    over the whole sequence gives."""
    B, S, H, P, G, N = 2, 40, 4, 8, 2, 16
    args = [torch.tensor(t) for t in _ssd_inputs(7, B, S, H, P, G, N,
                                                 h0=True)]
    y, hf = ssd_scan(*args[:4], chunk, h0=args[4])
    y1, h1 = ssd_scan(*args[:4], S, h0=args[4])
    np.testing.assert_allclose(np32(y), np32(y1), **SSD_TOL)
    np.testing.assert_allclose(np32(hf), np32(h1), **SSD_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_ssd_decode_step_matches(G):
    rng = np.random.default_rng(G)
    B, H, N, P = 3, 4, 16, 8
    h, x, a, Bm, Cm = (rng.normal(size=s).astype(np.float32) for s in (
        (B, H, N, P), (B, H, P), (B, H), (B, G, N), (B, G, N)))
    a = -np.abs(a)
    y, hn = tssm.ssd_decode_step(*map(torch.tensor, (h, x, a, Bm, Cm)))
    jy, jh = jssm.ssd_decode_step(*map(jnp.asarray, (h, x, a, Bm, Cm)))
    np.testing.assert_allclose(np32(y), np32(jy), **F32_TOL)
    np.testing.assert_allclose(np32(hn), np32(jh), **F32_TOL)


# ---------------------------------------------------------------------------
# conv, tail window, block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,W", [(12, 4), (2, 4)])
def test_causal_conv_matches(S, W):
    """A cross-correlation with the reference's taps (not flipped), also
    over a sequence shorter than the window."""
    rng = np.random.default_rng(S)
    x, w, b = (rng.normal(size=s).astype(np.float32)
               for s in ((2, S, 6), (W, 6), (6,)))
    got = tssm.causal_conv(*map(torch.tensor, (x, w, b)))
    want = jssm.causal_conv(*map(jnp.asarray, (x, w, b)))
    np.testing.assert_allclose(np32(got), np32(want), **F32_TOL)


def test_conv_decode_step_matches():
    rng = np.random.default_rng(3)
    win, xn, w, b = (rng.normal(size=s).astype(np.float32)
                     for s in ((2, 3, 6), (2, 6), (4, 6), (6,)))
    y, nw = tssm.conv_decode_step(*map(torch.tensor, (win, xn, w, b)))
    jy, jw = jssm.conv_decode_step(*map(jnp.asarray, (win, xn, w, b)))
    np.testing.assert_allclose(np32(y), np32(jy), **F32_TOL)
    np.testing.assert_allclose(np32(nw), np32(jw), **F32_TOL)


def test_gather_tail_window_matches():
    """Rows shorter than the window are zero-filled left of position 0."""
    x = np.random.default_rng(4).normal(size=(4, 9, 5)).astype(np.float32)
    lens = np.array([9, 4, 2, 1], np.int32)
    got = tcm.gather_tail_window(torch.tensor(x), torch.tensor(lens), 3)
    want = jcm.gather_tail_window(jnp.asarray(x), jnp.asarray(lens), 3)
    np.testing.assert_allclose(np32(got), np32(want), **F32_TOL)
    assert not np32(got)[3, :2].any() and not np32(got)[2, 0].any()


def _layer0(params, tparams, cfg):
    jp = jax.tree.map(lambda t: t[0], params["layers"]["mamba"])
    tp = unstack_layers(tparams["layers"], cfg.n_layers)[0]["mamba"]
    return jp, tp


@pytest.mark.parametrize("lens", [None, [12, 5]])
def test_mamba_block_matches(lens):
    """Output, final SSM state and conv tail, with ragged rows masked by
    ``seq_lens`` (dt = 0 past each row's length)."""
    _, params, cfg, _, tparams = twin(ARCH)
    jp, tp = _layer0(params, tparams, cfg)
    x = np.random.default_rng(5).normal(size=(2, 12, cfg.d_model)) \
        .astype(np.float32)
    kw_j = {} if lens is None else {"seq_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"seq_lens": torch.tensor(lens)}
    jo, (jh, jt) = jssm.mamba_block(jp, jnp.asarray(x), cfg,
                                    return_state=True, **kw_j)
    to, (th, tt) = tssm.mamba_block(tp, torch.tensor(x), cfg,
                                    return_state=True, **kw_t)
    for got, want in ((to, jo), (th, jh), (tt, jt)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(np32(got), np32(want), **LOGITS_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _prompts(seed=0, B=2, S=12):
    rng = np.random.default_rng(seed)
    _, _, cfg, _, _ = twin(ARCH)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("lens", [None, [12, 7]])
def test_prefill_logits_and_cache_match(lens):
    model, params, _, tmodel, tparams = twin(ARCH)
    toks = _prompts()
    kw_j = {} if lens is None else {"prompt_lens": jnp.asarray(lens)}
    kw_t = {} if lens is None else {"prompt_lens": torch.tensor(lens)}
    jl, jc = model.prefill(params, jnp.asarray(toks), remat=False, **kw_j)
    tl, tc = tmodel.prefill(tparams, torch.tensor(toks), **kw_t)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
    for key in ("ssm", "conv"):
        assert tuple(tc[key].shape) == jc[key].shape
        assert tc[key].dtype == torch.float32
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


def test_decode_steps_match():
    """Three decode steps from a ragged prefill: logits each step, and the
    state and conv window written in place."""
    model, params, _, tmodel, tparams = twin(ARCH)
    lens = np.array([12, 7], np.int32)
    jl, jc = model.prefill(params, jnp.asarray(_prompts(1)), remat=False,
                           prompt_lens=jnp.asarray(lens))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    tok, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), lens.copy()
    for _ in range(3):
        jl, jc = model.decode_step(params, jc, jnp.asarray(tok),
                                   jnp.asarray(pos))
        tl, tc2 = tmodel.decode_step(tparams, tc, torch.tensor(tok),
                                     torch.tensor(pos))
        assert tc2 is tc
        np.testing.assert_allclose(np32(tl), np32(jl), **LOGITS_TOL)
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    for key in ("ssm", "conv"):
        np.testing.assert_allclose(np32(tc[key]), np32(jc[key]), **LOGITS_TOL)


# ---------------------------------------------------------------------------
# engine runs: dense and paged, with and without EOS
# ---------------------------------------------------------------------------

# token 7 ends two of the smoke requests early, one in mid-chunk
CONFIGS = {
    "dense": dict(),
    "paged": dict(paged=True, page_size=16),
    "dense-eos": dict(eos_token=7),
    "paged-eos": dict(paged=True, page_size=16, eos_token=7),
}
_RUNS = {}


def _run(name):
    """Both engines over ``conftest.make_requests`` with a recording
    executor and a tracer, memoized per configuration."""
    if name not in _RUNS:
        model, params, cfg, tmodel, tparams = twin(ARCH)
        out = []
        for eng_cls, tr_cls, m, p, to_req in (
                (JaxEngine, JaxTracer, model, params, lambda r: r),
                (TorchEngine, TorchTracer, tmodel, tparams,
                 lambda r: TorchRequest(uid=r.uid, prompt=r.prompt,
                                        max_new_tokens=r.max_new_tokens))):
            ex, tracer = RecordingExecutor(), tr_cls()
            eng = eng_cls(m, p, batch_slots=2, max_seq=64, executor=ex,
                          tracer=tracer, **CONFIGS[name])
            reqs = eng.generate([to_req(r) for r in make_requests(cfg)])
            out.append((reqs, ex, tracer, eng))
        _RUNS[name] = out
    return _RUNS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_token_streams_identical(name):
    (jreqs, _, _, jeng), (treqs, _, _, teng) = _run(name)
    for j, t in zip(jreqs, treqs):
        assert t.generated == j.generated, (name, j.uid)
        assert t.finished_step == j.finished_step, (name, j.uid)
        assert t.done and j.done
    assert teng.n_decode_steps == jeng.n_decode_steps
    if "eos" in name:
        assert sum(len(t.generated) < t.max_new_tokens for t in treqs) == 2


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_engine_executor_hook_identical(name):
    (_, jex, _, _), (_, tex, _, _) = _run(name)
    assert tex.calls == jex.calls
    assert tex.calls[-1] == ("finish",)


@pytest.mark.parametrize("name", ["dense", "paged-eos"])
def test_engine_trace_events_identical(name):
    (_, _, jtr, _), (_, _, ttr, _) = _run(name)
    assert ttr.events == jtr.events
    assert ttr.to_dict()["traceEvents"] == jtr.to_dict()["traceEvents"]


# ---------------------------------------------------------------------------
# the parameter bridge, devices, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_params_from_jax_keeps_decay_leaves_in_f32(compute):
    """``dt_bias``, ``A_log``, ``D`` and the norm scales cross over in f32
    bit for bit under any compute dtype (a bf16 ``A_log`` would change
    every decay); the projections, conv weights and the embedding take the
    compute dtype, as the reference casts them at use."""
    import dataclasses
    _, _, cfg, _, _ = twin(ARCH)
    tmodel = build_model(dataclasses.replace(cfg, compute_dtype=compute),
                         device="cpu")
    rng = np.random.default_rng(6)

    def draw(spec):
        return {k: draw(v) if isinstance(v, dict) else
                rng.normal(size=v).astype(np.float32) for k, v in spec.items()}
    tree = draw(tmodel.param_shapes())
    got = params_from_jax(tmodel, tree)
    mamba, ref = got["layers"]["mamba"], tree["layers"]["mamba"]
    for name in ("dt_bias", "A_log", "D"):
        assert mamba[name].dtype == torch.float32
        np.testing.assert_array_equal(mamba[name].numpy(), ref[name])
    for scale in (mamba["gate_norm"]["scale"],
                  got["layers"]["norm"]["scale"], got["final_norm"]["scale"]):
        assert scale.dtype == torch.float32
    want = getattr(torch, compute)
    for name in ("w_z", "w_x", "w_bc", "w_dt", "out_proj", "conv_x_w",
                 "conv_x_b", "conv_bc_w", "conv_bc_b"):
        assert mamba[name].dtype == want
        np.testing.assert_array_equal(
            mamba[name].float().numpy(),
            torch.tensor(ref[name]).to(want).float().numpy())
    assert got["embed"]["wte"].dtype == want
    with pytest.raises(ValueError, match="A_log"):
        bad = draw(tmodel.param_shapes())
        bad["layers"]["mamba"]["A_log"] = bad["layers"]["mamba"]["A_log"][:, 1:]
        params_from_jax(tmodel, bad)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_ssd_scan_refuses_gradients(device):
    """Gradients go through the SSD scan's autograd ``Function`` (kernel
    forward, plain f32 backward); what it refuses is what the kernel
    refuses.  On the CPU an input that requires grad builds the
    ``Function``'s graph and ``torch.no_grad`` builds none; off the CPU
    with no card (``meta``) the ``Function`` still refuses the launch,
    before anything runs."""
    kernels.reset_launch_counts()
    dt = torch.float32 if device == "cpu" else torch.bfloat16
    x = torch.zeros(1, 16, 2, 64, dtype=dt, device=device,
                    requires_grad=True)
    a = torch.zeros(1, 16, 2, device=device)
    bc = torch.zeros(1, 16, 1, 128, dtype=dt, device=device)
    if device == "cpu":
        y, _ = ssd_scan(x, a, bc, bc, 16)
        assert type(y.grad_fn).__name__ == "_SsdScanTrainBackward"
        y.sum().backward()
        assert x.grad.shape == x.shape
    else:
        with pytest.raises(ValueError, match="CUDA device"):
            ssd_scan(x, a, bc, bc, 16)
    with torch.no_grad():
        if device == "cpu":
            y, _ = ssd_scan(x, a, bc, bc, 16)
            assert not y.requires_grad and y.grad_fn is None
    assert kernels.launch_counts()["ssd_scan"] == 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case,error,match", [
    ("f32", TypeError, "bf16"),
    ("state16", ValueError, r"state in \(64, 128\)"),
    ("chunk512", ValueError, "at most 256"), ("h0_bf16", ValueError, "h0"),
    ("meta", ValueError, "CUDA device")])
def test_ssd_kernel_refuses_what_it_is_not_built_for(case, error, match):
    """Off the CPU the wrapper launches the instantiations it is built
    for (bf16 x/B/C, f32 a, N 64 or 128, P 64, chunks up to 256) or
    raises; it never falls back to the plain version."""
    kernels.reset_launch_counts()
    B, S, H, P, G, N = 1, 600, 4, 64, 1, 128
    x, a = _meta(B, S, H, P), _meta(B, S, H, dtype=torch.float32)
    bc, h0, chunk = _meta(B, S, G, N), None, 256
    if case == "f32":
        x = _meta(B, S, H, P, dtype=torch.float32)
    elif case == "state16":
        bc = _meta(B, S, G, 16)
    elif case == "chunk512":
        chunk = 512
    elif case == "h0_bf16":
        h0 = _meta(B, H, N, P)
    with pytest.raises(error, match=match):
        ssd_scan(x, a, bc, bc, chunk, h0=h0)
    assert kernels.launch_counts()["ssd_scan"] == 0


def test_build_model_needs_the_card_unless_told():
    cfg = get_config(ARCH)
    assert cfg.family == "ssm" and cfg.ssm.state_dim == 128
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    assert isinstance(build_model(cfg, device="cpu"), tssm.MambaLM)


def test_training_entry_points_wait_for_their_slice():
    """The training slice has landed: ``forward_hidden`` and ``loss`` run
    (with and without remat, the same loss; held against the reference in
    ``tests/test_torch_ssm_train.py``)."""
    _, _, cfg, tmodel, tparams = twin(ARCH)
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 5)),
                        dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    losses = [float(tmodel.loss(tparams, batch, remat=r)[0])
              for r in (True, False)]
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    x, aux = tmodel.forward_hidden(tparams, torch.zeros(1, 4, cfg.d_model))
    assert x.shape == (1, 4, cfg.d_model) and aux == {}
