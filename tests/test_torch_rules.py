"""Package rules of the PyTorch port: what it may import, and that its
entry points never carry on without the device they were asked for."""

import ast
import importlib
import pkgutil
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.api import backends, registry
from repro_torch.core.executor import CascadePlan
from repro_torch.kernels import _build
from repro_torch.kernels.cascade_kernel import cascade_chunk_kernel, cascade_kernel
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    matrix_stage_scorer,
)
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
from repro_torch.kernels.megakernel import (
    build_lattice_slabs,
    build_matrix_slabs,
    mega_stage_kernel,
)
from repro_torch.kernels.tree_kernel import gbt_scores_kernel
from repro_torch.launch import serve
from repro_torch.serving.engine import QWYCServer

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            out.add(node.module)
    return out


def _port_files():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_neither_jax_nor_repro(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path.name} imports {mod}"


def test_every_module_imports_without_a_card_or_nvcc():
    """Import starts no build: the kernels compile at first launch."""
    names = [
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    ]
    assert len(names) >= 16
    for name in names:
        importlib.import_module(name)


@pytest.mark.parametrize("source", _build.SOURCES)
def test_each_kernel_source_names_what_it_replaces(source):
    text = (PKG / "csrc" / f"{source}.cu").read_text()
    assert "Replaces repro/kernels/" in text
    assert "What bounds it on an H100" in text
    assert "Design:" in text


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_plan():
    T = 6
    return CascadePlan(
        order=np.arange(T), eps_pos=np.full(T, np.inf), eps_neg=np.full(T, -np.inf),
        beta=0.0, costs=np.ones(T), chunk_t=3,
    )


def test_default_device_entry_points_raise_without_cuda(no_cuda):
    plan = _tiny_plan()
    dplan = DevicePlan.from_plan(plan)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        matrix_stage_scorer(dplan)
    scorer = matrix_stage_scorer(dplan, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceExecutor(dplan, scorer)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        backends.DeviceBackend().make_executor(dplan, scorer=scorer)
    from repro_torch.core.qwyc import QWYCModel

    m = QWYCModel(
        order=plan.order, eps_pos=plan.eps_pos, eps_neg=plan.eps_neg, beta=0.0,
        costs=plan.costs, alpha=0.0, mode="both",
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        QWYCServer(m, score_fn=lambda x: x, exec_backend="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--T", "4", "--scale", "0.01"])


def test_auto_raises_without_cuda_instead_of_picking_host(no_cuda):
    with pytest.raises(RuntimeError, match="'auto' needs a CUDA device"):
        registry.resolve_backend("auto")
    with pytest.raises(RuntimeError, match="'auto' needs a CUDA device"):
        registry.resolve_backend("auto", device="cuda")
    # the caller named the CPU: the device loop on the plain versions
    assert registry.resolve_backend("auto", device="cpu").name == "device"
    assert registry.resolve_backend("host").name == "host"
    assert registry.resolve_backend("device").name == "device"


def test_wrappers_dispatch_on_tensor_device():
    """A CPU tensor takes the plain version and launches nothing; a tensor
    on any other non-CUDA device raises instead of falling back."""
    _build.LAUNCHES.clear()
    g0 = torch.zeros(4)
    s = torch.ones(4, 2)
    e = torch.zeros(2)
    cascade_chunk_kernel(g0, s, e, e, 0)
    feats = torch.zeros(2, 1, dtype=torch.int32)
    gbt_scores_kernel(feats, torch.zeros(2, 1), torch.ones(2, 2), torch.ones(4, 3))
    dplan = DevicePlan.from_plan(_tiny_plan())
    slabs = build_matrix_slabs(dplan, device="cpu")
    eps = torch.zeros(dplan.S, dplan.W)
    mega_stage_kernel(
        slabs, torch.ones(4, dplan.T_pad), g0, 0, 0, 4, eps, eps, block_n=64
    )
    theta, lfeats = torch.ones(dplan.T_pad, 4), torch.zeros(dplan.T_pad, 2, dtype=torch.int32)
    lattice_scores_kernel(theta, lfeats, torch.ones(4, 3))
    lslabs = build_lattice_slabs(dplan, theta.numpy(), lfeats.numpy(), device="cpu")
    mega_stage_kernel(lslabs, torch.ones(4, 3), g0, 0, 0, 4, eps, eps, block_n=64)
    cascade_kernel(s, e, e, 0.0)
    assert sum(_build.LAUNCHES.values()) == 0
    meta = torch.empty(4, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cascade_chunk_kernel(
            g0.to("meta"), meta, e.to("meta"), e.to("meta"), 0
        )
    with pytest.raises(ValueError, match="unsupported device"):
        gbt_scores_kernel(feats, torch.zeros(2, 1), torch.ones(2, 2), meta)
    with pytest.raises(ValueError, match="unsupported device"):
        lattice_scores_kernel(theta, lfeats, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        cascade_kernel(meta, e.to("meta"), e.to("meta"), 0.0)


def test_quantized_slabs_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        DevicePlan.from_plan(_tiny_plan(), quant="bf16")
    with pytest.raises(ValueError, match="quant must be one of"):
        DevicePlan.from_plan(_tiny_plan(), quant="fp4")
    dplan = DevicePlan.from_plan(_tiny_plan())
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        build_lattice_slabs(
            dplan, np.zeros((6, 4), np.float32), np.zeros((6, 2), np.int32),
            quant="bf16", device="cpu",
        )
