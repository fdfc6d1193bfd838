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
from repro_torch.kernels.cascade_kernel import (
    cascade_chunk_kernel,
    cascade_kernel,
    cascade_lane_kernel,
)
from repro_torch.kernels.device_executor import (
    DeviceExecutor,
    DevicePlan,
    matrix_stage_scorer,
)
from repro_torch.kernels.lattice_kernel import lattice_scores_kernel
from repro_torch.kernels.megakernel import (
    build_lattice_slabs,
    build_matrix_slabs,
    mega_lane_kernel,
    mega_stage_kernel,
)
from repro_torch.kernels.tree_kernel import gbt_scores_kernel
from repro_torch.launch import serve
from repro_torch.serving.engine import QWYCServer, StreamingServer

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
    return (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted((ROOT / "benchmarks" / "torch").glob("*.py")))


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


def test_streaming_entry_points_raise_without_cuda(no_cuda):
    """``run_stream``, ``StreamingServer`` and ``serve --streaming`` default
    to the card and raise without one; naming the CPU runs them."""
    plan = _tiny_plan()
    dplan = DevicePlan.from_plan(plan)
    from repro_torch.core.qwyc import QWYCModel

    m = QWYCModel(
        order=plan.order, eps_pos=plan.eps_pos, eps_neg=plan.eps_neg, beta=0.0,
        costs=plan.costs, alpha=0.0, mode="both",
    )
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingServer(m, score_fn=lambda x: x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingServer(m, score_fn=lambda x: x, exec_backend="device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--T", "4", "--scale", "0.01", "--streaming"])
    scorer = matrix_stage_scorer(dplan, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceExecutor(dplan, scorer).run_stream(np.zeros((2, 6), np.float32), 2)
    res = DeviceExecutor(dplan, scorer, device="cpu").run_stream(
        np.zeros((2, 6), np.float32), 2
    )
    assert res.exit_step.tolist() == [6, 6] and res.steps_run == dplan.S
    assert backends.DeviceBackend.capabilities.streaming
    assert not backends.HostBackend.capabilities.streaming


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
    e2 = torch.zeros(4, 2)
    cascade_lane_kernel(g0, s, e2, e2)
    rows = torch.zeros(4, dtype=torch.int64)
    stage = torch.zeros(4, dtype=torch.int32)
    stop = torch.zeros(4, dtype=torch.bool)
    mega_lane_kernel(
        slabs, torch.ones(4, dplan.T_pad), rows, g0, stage, stop, 4, eps, eps,
        block_n=64,
    )
    mega_lane_kernel(lslabs, torch.ones(4, 3), rows, g0, stage, stop, 4, eps, eps, block_n=64)
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
    with pytest.raises(ValueError, match="unsupported device"):
        cascade_lane_kernel(g0.to("meta"), meta, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        mega_lane_kernel(
            slabs, meta, rows.to("meta"), g0.to("meta"), stage.to("meta"),
            stop.to("meta"), 4, eps.to("meta"), eps.to("meta"), block_n=64,
        )


def test_quantized_slabs_name_the_roadmap_item():
    """bf16 and int8 slabs are accepted; an unknown storage name and int8
    matrix slabs are refused with ValueError."""
    for quant in ("bf16", "int8"):
        dplan = DevicePlan.from_plan(_tiny_plan(), quant=quant)
        slabs = build_lattice_slabs(
            dplan, np.ones((6, 4), np.float32), np.zeros((6, 2), np.int32),
            quant=quant, device="cpu",
        )
        assert slabs.quant == quant and slabs.data["payload"].dtype == {
            "bf16": torch.bfloat16, "int8": torch.int8
        }[quant]
    assert build_matrix_slabs(dplan, quant="bf16", device="cpu").x_dtype == torch.bfloat16
    with pytest.raises(ValueError, match="quant must be one of"):
        DevicePlan.from_plan(_tiny_plan(), quant="fp4")
    with pytest.raises(ValueError, match="matrix slabs support f32/bf16 only"):
        build_matrix_slabs(dplan, quant="int8", device="cpu")


def test_group_decide_wrapper_dispatches_on_tensor_device():
    """B8's wrapper: a CPU tensor takes the plain version and launches
    nothing; a tensor on another non-CUDA device raises."""
    from repro_torch.kernels.cascade_kernel import cascade_group_kernel, cascade_group_plain

    _build.LAUNCHES.clear()
    g = torch.tensor([[3.0, 1.0, 2.0, 0.0], [1.0, 1.0, 0.0, 0.0]])
    valid = torch.tensor([[1, 1, 1, 1], [1, 1, 0, 0]], dtype=torch.int32)
    eps = torch.zeros(2)
    got = cascade_group_kernel(g, valid, eps, 1, n_live=torch.tensor(1, dtype=torch.int32))
    want = cascade_group_plain(g, valid, eps, 1, n_live=1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].tolist() == [1.0, 0.0] and got[1].tolist() == [1, 0]
    assert sum(_build.LAUNCHES.values()) == 0
    with pytest.raises(ValueError, match="unsupported device"):
        cascade_group_kernel(g.to("meta"), valid.to("meta"), eps.to("meta"), 1)
    assert "cascade_group" in _build.SOURCES


def _grouped_fit():
    from repro_torch import api

    rng = np.random.default_rng(0)
    sizes = np.array([3, 5, 1, 4])
    F = rng.normal(size=(int(sizes.sum()), 6))
    return api.fit(F, groups=sizes, topk=2, chunk_t=3), F, sizes


def test_ranking_entry_points_raise_without_cuda(no_cuda):
    """``compile()``, its ``rank()`` and ``serve --groups`` default to the
    card and raise without one; naming the CPU runs them."""
    from repro_torch.ranking import GroupedRankServer

    fitted, F, sizes = _grouped_fit()
    for backend in ("auto", "device", "host"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fitted.compile(backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GroupedRankServer(fitted.grouped)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--T", "4", "--scale", "0.01", "--groups", "4"])
    for backend in ("auto", "device", "host"):
        res = fitted.compile(backend, device="cpu").rank(scores=F, groups=sizes)
        assert [len(r["ranking"]) for r in res] == [2, 2, 1, 2]


def test_auto_compile_never_lands_on_host(no_cuda):
    fitted, _, _ = _grouped_fit()
    c = fitted.compile("auto", device="cpu")
    assert c.backend_name == "device" and c._executor is not None
    assert fitted.compile(device="cpu").backend_name == "device"
    assert fitted.compile("host", device="cpu").backend_name == "host"
    assert backends.DeviceBackend.capabilities.grouped
    assert backends.HostBackend.capabilities.grouped


def test_grouped_streaming_raises_without_cuda(no_cuda):
    """Grouped streaming defaults to the card like every entry point:
    the server, ``compile().serve(streaming=True)`` and ``serve --groups
    --streaming`` raise without one; naming the CPU runs them."""
    from repro_torch.ranking import GroupedRankServer

    fitted, F, sizes = _grouped_fit()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GroupedRankServer(fitted.grouped, streaming=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fitted.compile("device").serve(streaming=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--T", "4", "--scale", "0.01", "--groups", "4", "--streaming"])
    srv = fitted.compile("device", device="cpu").serve(streaming=True, policy="wait")
    off = np.concatenate([[0], np.cumsum(sizes)])
    for i in range(sizes.size):
        srv.submit(F[off[i] : off[i + 1]], arrival=float(i))
    assert [len(r["ranking"]) for r in srv.drain()] == [2, 2, 1, 2]
    assert srv.streaming and srv.policy == "wait" and srv.stats.n_waves >= 1


def test_baseline_entry_points_raise_without_cuda(no_cuda):
    """The masked-walk cascade, the MoE contributions and the device sweep
    default to the card and raise without one; the ladder never makes the
    host a rung of ``auto`` (it is reached only by a recorded fall)."""
    import types

    from repro_torch.core import cascade_from_scores, expert_contributions
    from repro_torch.core.qwyc_distributed import fit_qwyc_sharded

    S = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cascade_from_scores(S, np.full(3, np.inf), np.full(3, -np.inf), 0.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit_qwyc_sharded(S)
    p = {"router": np.zeros((2, 2)), "wi": np.zeros((2, 2, 1)),
         "wg": np.zeros((2, 2, 1)), "wo": np.zeros((2, 1, 2))}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        expert_contributions(p, np.zeros((3, 2)), np.zeros(2),
                             types.SimpleNamespace(n_experts=2, top_k=1))
    assert backends.LADDER_ORDER == ("device", "host")
    assert registry.NEGOTIATION_ORDER == ("device",)
    assert backends.fallback_rung("device").name == "host"
