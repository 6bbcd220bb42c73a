"""The SSD scan kernel's rounding recipe against the JAX package, on the CPU.

``csrc/ssd_scan.cu`` runs the chunked scan in three passes (chunk states,
a sequential pass over the chunks, outputs) with every product on the
tensor cores in bf16 with f32 sums.  Beside its bf16 inputs it rounds
three intermediates before a product: L o C B^T (before the product with
x), decay_out o x (split into bf16 hi + lo, two products, for the state
update) and the entering state h (before C h).  ``recipe_scan`` below is a
plain PyTorch model of exactly that recipe and pass structure; it lives
here only, not in the port.  It is held against the JAX package's
``models/ssm.py:ssd_chunked`` and ``kernels/ssd_scan/ops.py:ssd`` (its
Pallas kernel in interpret mode) at ``chip_smoke.py``'s tolerances, on
seeded numpy inputs rounded to bf16 (the kernel's input type) with
``chip_smoke.py``'s decay scale.  One case shows that a single bf16
rounding of decay_out o x puts the final state outside ``SSD_H_TOL``, and
one that the kernel's source names the recipe modelled here.
"""
import ast
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.models import ssm as jssm
from repro_torch.kernels.ssd_scan import ssd_ref
from torch_parity import np32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "ssd_scan.cu")
N, P, CHUNK = 128, 64, 256

#: what the kernel rounds, as its source header names it
RECIPE = {"C.B^T": "bf16 x bf16 inputs, exact products, f32 sums",
          "L o C.B^T": "rounded to bf16",
          "state update": "split into bf16 hi + lo, two products",
          "C.h": "h rounded to bf16",
          "carried state": "f32"}


def _smoke_tolerances():
    """SSD_Y_TOL and SSD_H_TOL as ``chip_smoke.py`` states them (read from
    its source, which imports torch with CUDA in mind)."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Tuple):
            names = [t.id for t in node.targets[0].elts]
            if names == ["SSD_Y_TOL", "SSD_H_TOL"]:
                return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py states no SSD_Y_TOL, SSD_H_TOL")


SSD_Y_TOL, SSD_H_TOL = _smoke_tolerances()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """Round f32 to bf16 and back, as a register pack before an mma."""
    return x.to(torch.bfloat16).float()


def recipe_scan(x, a, Bm, Cm, chunk, h0=None, state_update="split",
                rounded=True):
    """The kernel's arithmetic pass by pass, in f32 on its inputs:

    (a) per chunk the inclusive cumulative sum a_cs of a and the state
        contribution S_c = B^T (decay_out o x), decay_out o x split into
        bf16 hi + lo (``state_update="split"``) or rounded once
        (``"bf16"``);
    (b) the state entering each chunk, h_c = exp(a_tot) h_c-1 + S_c-1 from
        h0 or zero, in f32, and the final state;
    (c) y = exp(a_cs[q]) C[q] . bf16(h_c) + bf16(L o C B^T) . x, rounded
        to bf16.

    ``rounded=False`` drops every rounding (the pass structure alone).
    Rows past S are zeros.  Returns (y (B, S, H, P), final state)."""
    rnd = _bf16 if rounded else (lambda t: t)
    B, S, H, _ = x.shape
    G = Bm.shape[2]
    Q = min(chunk, S)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):
        t = torch.cat([t, t.new_zeros(t.shape[0], pad, *t.shape[2:])], 1)
        return t.reshape(B, nc, Q, *t.shape[2:])
    heads = torch.arange(H) // (H // G)
    xs, acs = chunks(x), torch.cumsum(chunks(a), 2)       # (B, nc, Q, H[, P])
    Bh, Ch = chunks(Bm)[:, :, :, heads], chunks(Cm)[:, :, :, heads]
    a_tot = acs[:, :, -1]                                 # (B, nc, H)

    # (a) chunk states
    w = torch.exp(a_tot[:, :, None] - acs)[..., None] * xs
    if state_update == "split":
        hi = rnd(w)
        parts = (hi, rnd(w - hi))
    elif state_update == "bf16":
        parts = (rnd(w),)
    else:
        raise ValueError(state_update)
    S_c = sum(torch.einsum("bckhn,bckhp->bchnp", Bh, part) for part in parts)

    # (b) the states entering each chunk
    h = torch.zeros(B, H, Bm.shape[3], P) if h0 is None else h0
    entering = []
    for c in range(nc):
        entering.append(h)
        h = torch.exp(a_tot[:, c])[..., None, None] * h + S_c[:, c]
    entering = torch.stack(entering, 1)                   # (B, nc, H, N, P)

    # (c) outputs
    cb = torch.einsum("bcqhn,bckhn->bchqk", Ch, Bh)
    seg = acs.transpose(2, 3)[..., :, None] - acs.transpose(2, 3)[..., None, :]
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)), 0.0)
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", rnd(cb * L), xs)
    y_off = torch.exp(acs)[..., None] * torch.einsum(
        "bcqhn,bchnp->bcqhp", Ch, rnd(entering))
    y = rnd(y_off + y_intra).reshape(B, nc * Q, H, P)[:, :S]
    return y, h


def _operands(seed, B, S, H, G, h0, n=N):
    """x, a, B, C (and h0) from seeded numpy: x, B, C normal and rounded to
    bf16 (the kernel's input type), a the log decay -0.03 U(0, 1) of
    ``chip_smoke.py:_ssd_case`` (the served model's scale), h0 normal f32;
    B and C of state ``n``; the same f32 values go to both packages."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return np32(torch.tensor(rng.normal(size=shape).astype(np.float32))
                    .to(torch.bfloat16))
    out = [bf16(B, S, H, P), (-0.03 * rng.random((B, S, H))).astype(
        np.float32), bf16(B, S, G, n), bf16(B, S, G, n)]
    out.append(rng.normal(size=(B, H, n, P)).astype(np.float32) if h0
               else None)
    return out


def _errors(got, ref):
    """(y error / max |y|, state error / max |h|) of (y, h) pairs."""
    (y, h), (yr, hr) = [[np.asarray(np32(t), np.float64) for t in pair]
                        for pair in (got, ref)]
    assert y.shape == yr.shape and h.shape == hr.shape
    return (np.abs(y - yr).max() / np.abs(yr).max(),
            np.abs(h - hr).max() / np.abs(hr).max())


def _recipe(args, **kw):
    x, a, Bm, Cm, h0 = (None if t is None else torch.tensor(t) for t in args)
    return recipe_scan(x, a, Bm, Cm, CHUNK, h0, **kw)


# (S, G, h0): the serving length (two whole chunks) and a ragged one
# (256 + 44), one and two groups, with and without an initial state
CASES = [(512, 1, False), (512, 1, True), (512, 2, False), (300, 1, True),
         (300, 2, False), (300, 2, True)]


@pytest.mark.parametrize("S,G,h0", CASES)
def test_recipe_matches_reference(S, G, h0):
    """y within SSD_Y_TOL of its largest |value| and the final state within
    SSD_H_TOL of its largest |value| of the JAX package's ``ssd_chunked``
    (f32)."""
    args = _operands(S + 10 * G + h0, 2, S, 4, G, h0)
    ref = jssm.ssd_chunked(*(None if t is None else jnp.asarray(t)
                             for t in args[:4]), CHUNK,
                           h0=None if args[4] is None
                           else jnp.asarray(args[4]))
    ey, eh = _errors(_recipe(args), ref)
    assert ey <= SSD_Y_TOL, ey
    assert eh <= SSD_H_TOL, eh


@pytest.mark.parametrize("S,G", [(S, G) for S, G, h0 in CASES if not h0])
def test_recipe_matches_reference_kernel(S, G):
    """The same against the Pallas kernel (``ops.ssd``, interpret mode),
    which takes no initial state."""
    args = _operands(S + 10 * G, 2, S, 4, G, False)
    ref = jax_ssd(*(jnp.asarray(t) for t in args[:4]), chunk=CHUNK,
                  interpret=True)
    ey, eh = _errors(_recipe(args), ref)
    assert ey <= SSD_Y_TOL, ey
    assert eh <= SSD_H_TOL, eh


# zamba2-7b's state 64 with 2 groups: the serving length and a ragged one
# with an initial state
CASES_64 = [(512, False), (300, True)]


@pytest.mark.parametrize("S,h0", CASES_64)
def test_recipe_matches_reference_at_state_64(S, h0):
    """The recipe at N 64, G 2 (the kernel's other instantiation) against
    ``ssd_chunked`` at chip_smoke.py's tolerances."""
    args = _operands(S + 64 + h0, 2, S, 4, 2, h0, n=64)
    ref = jssm.ssd_chunked(*(jnp.asarray(t) for t in args[:4]), CHUNK,
                           h0=None if args[4] is None
                           else jnp.asarray(args[4]))
    ey, eh = _errors(_recipe(args), ref)
    assert ey <= SSD_Y_TOL, ey
    assert eh <= SSD_H_TOL, eh


def test_recipe_matches_reference_kernel_at_state_64():
    """The same against the Pallas kernel in interpret mode, at the
    serving length."""
    args = _operands(64, 2, 512, 4, 2, False, n=64)
    ref = jax_ssd(*(jnp.asarray(t) for t in args[:4]), chunk=CHUNK,
                  interpret=True)
    ey, eh = _errors(_recipe(args), ref)
    assert ey <= SSD_Y_TOL, ey
    assert eh <= SSD_H_TOL, eh


def test_recipe_passes_are_the_plain_version():
    """Without its roundings the recipe's three passes compute what the
    port's plain version ``ssd_ref`` computes (f32, ragged, h0, G 2)."""
    args = _operands(3, 2, 300, 4, 2, True)
    x, a, Bm, Cm, h0 = (torch.tensor(t) for t in args)
    ey, eh = _errors(recipe_scan(x, a, Bm, Cm, CHUNK, h0, rounded=False),
                     ssd_ref(x, a, Bm, Cm, CHUNK, h0))
    assert ey <= 1e-5 and eh <= 1e-5, (ey, eh)


def test_bf16_state_update_breaks_the_state_gate():
    """A single bf16 rounding of decay_out o x in the state update (every
    product in plain bf16) puts the final state outside SSD_H_TOL at the
    serving length and decay scale, where the hi + lo split stays far
    inside it: the split is what the gate needs."""
    args = _operands(16, 2, 512, 8, 1, False)
    ref = jssm.ssd_chunked(*(jnp.asarray(t) for t in args[:4]), CHUNK)
    _, eh_bf16 = _errors(_recipe(args, state_update="bf16"), ref)
    _, eh_split = _errors(_recipe(args), ref)
    assert eh_bf16 > SSD_H_TOL, eh_bf16
    assert eh_split <= SSD_H_TOL / 10, eh_split


def _header_recipe():
    """{product: rounding} from the "Rounding recipe" block of the kernel
    source's header."""
    with open(SOURCE) as f:
        lines = f.read().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("// Rounding recipe"))
    found = {}
    for line in lines[start + 1:]:
        m = re.match(r"//\s+([^:]+):\s+(.*)$", line)
        if not m:
            break
        found[m.group(1).strip()] = m.group(2).strip()
    return found


@pytest.mark.parametrize("product", sorted(RECIPE))
def test_kernel_header_names_the_modelled_recipe(product):
    """The kernel's source header names, for each product, the rounding
    that ``recipe_scan`` models."""
    found = _header_recipe()
    assert product in found, sorted(found)
    assert RECIPE[product] in found[product], (product, found[product])
