"""The port's launchers (``repro_torch.launch.serve`` / ``.train``) against
the JAX package's, in-process on the CPU with the same flags: the same plan
lines and the same executed DVFS totals.  The executed totals depend only
on the executor's hook sequence (lengths, not tokens), so the two models'
different random weights do not show; only the host tokens/s line and the
trained losses may differ.  Without ``--device cpu`` and without a card,
each launcher raises."""
import json
import sys

import pytest
import torch

from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro_torch.launch import serve, train
from repro_torch.obs import check_executor

SERVE_FLAGS = ["--arch", "llama3.2-1b", "--smoke", "--chip", "tpu-v5e",
               "--requests", "2"]


def _reference_lines(monkeypatch, capsys, module, flags):
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [module.__name__] + flags)
    module.main()
    return capsys.readouterr().out.splitlines()


def _port_lines(capsys, module, flags):
    capsys.readouterr()
    out = module.main(flags + ["--device", "cpu"])
    return out, capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("governor", ["kernel-static", "online"])
def test_serve_launcher_prints_the_references_lines(monkeypatch, capsys,
                                                    governor):
    flags = SERVE_FLAGS + ["--governor", governor]
    ref = _reference_lines(monkeypatch, capsys, jax_serve, flags)
    out, port = _port_lines(capsys, serve, flags)

    def same(lines):
        return [ln for ln in lines if "tok/s on this host" not in ln]
    assert same(port) == same(ref)
    assert len(same(port)) == len(port) - 1 == len(out["plan"]) + 1
    assert port[-1].startswith(f"[serve] executed ({governor}): ")
    # what main() returns is what it printed, and the books tie out
    assert out["requests"] == 2 and out["tokens"] == 16
    assert out["executed"]["steps"] == 2 + out["n_decode_steps"]
    assert check_executor(out["executor"]) == []


def test_train_launcher_prints_the_references_lines(monkeypatch, capsys,
                                                    tmp_path):
    flags = ["--arch", "llama3.2-1b", "--smoke", "--chip", "tpu-v5e",
             "--steps", "2"]
    ref = _reference_lines(monkeypatch, capsys, jax_train,
                           flags + ["--ckpt-dir", str(tmp_path / "jax")])
    out, port = _port_lines(capsys, train,
                            flags + ["--ckpt-dir", str(tmp_path / "port")])
    assert port[:2] == ref[:2]          # the model line and the plan line
    prefix = "[train] done: "
    jdone, tdone = (json.loads(lines[-1][len(prefix):])
                    for lines in (ref, port))
    assert tdone["dvfs"] == jdone["dvfs"] == out["done"]["dvfs"]
    assert tdone["final_step"] == jdone["final_step"] == 2
    assert [h["step"] for h in out["history"]] == [0, 1]
    assert (tmp_path / "port" / "ckpt_00000002" / "index.json").exists()


@pytest.mark.parametrize("module", [serve, train])
def test_launcher_raises_without_a_card(module, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "1",
                     "--ckpt-dir", str(tmp_path)] if module is train
                    else ["--arch", "llama3.2-1b", "--smoke"])


def test_card_smoke_config_keeps_the_kernels_widths():
    """``--smoke`` on the card reduces to widths the CUDA kernels are built
    for; the CPU keeps the reference's reduced config."""
    from repro_torch.configs import card_smoke_config, get_config, \
        smoke_config
    from repro_torch.kernels.rmsnorm import KERNEL_WIDTHS
    cfg = card_smoke_config(get_config("llama3.2-1b"))
    ref = smoke_config(get_config("llama3.2-1b"))
    assert cfg.d_model in KERNEL_WIDTHS and cfg.resolved_head_dim == 64
    assert cfg.n_heads * cfg.resolved_head_dim == cfg.d_model
    assert (cfg.n_layers, cfg.vocab_size, cfg.n_kv_heads) \
        == (ref.n_layers, ref.vocab_size, ref.n_kv_heads)
    with pytest.raises(NotImplementedError, match="full width"):
        card_smoke_config(get_config("mamba2-370m"))


def test_card_smoke_configs_are_built_kernel_cases():
    """Every dense and MoE arch's reduced config on the card runs only what
    the kernels are built for: its (head_dim, query heads per KV head) is a
    case of the paged decode kernel (with bf16 pools, which the serve
    launcher serves from) and of the flash prefill kernel, and its d_model
    a width of the RMSNorm kernel; the MoE family keeps the smoke config's
    4 experts and its top-k (2, or the full config's top-1 for
    llama4-scout-17b-a16e, whose local window stays 32)."""
    from repro_torch.configs import REGISTRY, card_smoke_config
    from repro_torch.kernels.flash_attention import paged, prefill
    from repro_torch.kernels.rmsnorm import KERNEL_WIDTHS
    dense = [c for c in REGISTRY.values() if c.family in ("dense", "moe")]
    assert {c.family for c in dense} == {"dense", "moe"}
    for full in dense:
        cfg = card_smoke_config(full)
        D, G = cfg.resolved_head_dim, cfg.n_heads // cfg.n_kv_heads
        assert cfg.n_heads % cfg.n_kv_heads == 0
        assert any((d, g) == (D, G) and torch.bfloat16 in pools
                   for d, g, pools in paged.KERNEL_CASES), (full.name, D, G)
        assert any(d == D and g in (0, G)
                   for d, g in prefill.KERNEL_CASES), (full.name, D, G)
        assert cfg.d_model in KERNEL_WIDTHS, full.name
        if full.is_moe:
            assert (cfg.moe.n_experts, cfg.moe.top_k) \
                == (4, min(full.moe.top_k, 2)), full.name
