"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

A subprocess imports every ``repro_torch`` module and finds neither
``jax`` nor ``repro`` in ``sys.modules``; an AST scan finds no such
import in the package or in ``chip_smoke.py``; and the port's config
copies equal the reference's field for field.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest

from repro.configs import granite_moe_3b as ref_granite
from repro.configs import qwen3_moe_30b as ref_qwen3_moe
from repro.configs import qwen15_4b as ref_qwen
from repro.configs import recurrentgemma_2b as ref_rg
from repro.configs import rwkv6_3b as ref_rwkv
from repro.models.config import LMConfig as RefLMConfig
from repro_torch.configs import get_arch
from repro_torch.configs import granite_moe_3b as port_granite
from repro_torch.configs import qwen3_moe_30b as port_qwen3_moe
from repro_torch.configs import qwen15_4b as port_qwen
from repro_torch.configs import recurrentgemma_2b as port_rg
from repro_torch.configs import rwkv6_3b as port_rwkv
from repro_torch.models.config import LMConfig as PortLMConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _port_files():
    out = []
    for root, _dirs, names in os.walk(PKG):
        out.extend(os.path.join(root, n) for n in sorted(names)
                   if n.endswith(".py"))
    return sorted(out) + [os.path.join(ROOT, "chip_smoke.py")]


def _module_name(path):
    rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
    parts = rel.split(os.sep)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_importing_every_module_pulls_in_no_jax():
    mods = [_module_name(p) for p in _port_files()
            if p.startswith(PKG)]
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert len(mods) >= 20
    assert {"repro_torch.models.recurrent", "repro_torch.kernels.rglru",
            "repro_torch.configs.recurrentgemma_2b", "repro_torch.models.moe",
            "repro_torch.kernels.moe_gmm", "repro_torch.configs.granite_moe_3b",
            "repro_torch.configs.qwen3_moe_30b", "repro_torch.serving.engine",
            "repro_torch.serving.kv", "repro_torch.serving.scheduler",
            "repro_torch.runtime.qos", "repro_torch.core", "repro_torch.core.ao",
            "repro_torch.core.costs", "repro_torch.core.schedule",
            "repro_torch.wireless", "repro_torch.wireless.channel",
            "repro_torch.wireless.fleet", "repro_torch.models.resnet",
            "repro_torch.configs.resnet18_cifar10",
            "repro_torch.sl.baselines",
            "repro_torch.launch.wireless_sl",
            "repro_torch.runtime.ue", "repro_torch.runtime.bs",
            "repro_torch.runtime.driver", "repro_torch.training.replan",
            "repro_torch.training.fault",
            "repro_torch.analysis.roofline"} <= set(mods)


def test_source_scan_covers_every_module():
    names = {os.path.relpath(p, PKG) for p in _port_files()
             if p.startswith(PKG)}
    assert {os.path.join("models", "recurrent.py"),
            os.path.join("kernels", "rglru.py"),
            os.path.join("models", "moe.py"),
            os.path.join("kernels", "moe_gmm.py"),
            os.path.join("serving", "engine.py"),
            os.path.join("serving", "kv.py"),
            os.path.join("serving", "scheduler.py"),
            os.path.join("runtime", "qos.py"),
            os.path.join("core", "ao.py"), os.path.join("core", "costs.py"),
            os.path.join("core", "schedule.py"),
            os.path.join("wireless", "channel.py"),
            os.path.join("wireless", "fleet.py"),
            os.path.join("models", "resnet.py"),
            os.path.join("sl", "baselines.py"),
            os.path.join("runtime", "ue.py"),
            os.path.join("runtime", "bs.py"),
            os.path.join("runtime", "driver.py"),
            os.path.join("training", "replan.py"),
            os.path.join("training", "fault.py"),
            os.path.join("analysis", "roofline.py"),
            os.path.join("launch", "wireless_sl.py")} <= names


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import_in_source(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert bad == [], f"{path} imports {bad}"


def _field_table(cls):
    return [(f.name, str(f.type), f.default) for f in dataclasses.fields(cls)]


def test_lmconfig_fields_and_defaults_match_reference():
    assert _field_table(PortLMConfig) == _field_table(RefLMConfig)


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_qwen_configs_match_reference(size):
    ref, port = getattr(ref_qwen, size), getattr(port_qwen, size)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("padded_vocab", "hd", "layer_kinds", "homogeneous",
                 "is_moe", "r_width"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_rwkv_configs_match_reference(size):
    ref, port = getattr(ref_rwkv, size), getattr(port_rwkv, size)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("padded_vocab", "hd", "layer_kinds", "homogeneous",
                 "is_moe", "r_width"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
def test_recurrentgemma_configs_match_reference(size):
    ref, port = getattr(ref_rg, size), getattr(port_rg, size)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("padded_vocab", "hd", "layer_kinds", "homogeneous",
                 "is_moe", "r_width"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("size", ["FULL", "SMOKE"])
@pytest.mark.parametrize("ref_mod,port_mod",
                         [(ref_granite, port_granite),
                          (ref_qwen3_moe, port_qwen3_moe)],
                         ids=["granite-moe", "qwen3-moe"])
def test_moe_configs_match_reference(ref_mod, port_mod, size):
    ref, port = getattr(ref_mod, size), getattr(port_mod, size)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    for prop in ("padded_vocab", "hd", "layer_kinds", "homogeneous",
                 "is_moe", "r_width"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.param_count() == ref.param_count()


def test_arch_registry():
    spec = get_arch("qwen1.5-4b")
    assert spec.full is port_qwen.FULL and spec.smoke is port_qwen.SMOKE
    assert (spec.full.num_layers, spec.full.d_model, spec.full.hd) \
        == (40, 2560, 128)
    spec = get_arch("rwkv6-3b")
    assert spec.full is port_rwkv.FULL and spec.smoke is port_rwkv.SMOKE
    assert spec.full.param_count() == 3_282_042_880
    spec = get_arch("recurrentgemma-2b")
    assert spec.full is port_rg.FULL and spec.smoke is port_rg.SMOKE
    assert (spec.full.num_layers, spec.full.hd, spec.full.n_kv,
            spec.full.layer_kinds.count("rglru")) == (26, 256, 1, 18)
    spec = get_arch("granite-moe-3b-a800m")
    assert spec.full is port_granite.FULL and spec.smoke is port_granite.SMOKE
    assert (spec.full.num_layers, spec.full.d_model, spec.full.hd,
            spec.full.moe_experts, spec.full.moe_topk,
            spec.full.tie_embeddings) == (32, 1536, 64, 40, 8, True)
    spec = get_arch("qwen3-moe-30b-a3b")
    assert spec.full is port_qwen3_moe.FULL \
        and spec.smoke is port_qwen3_moe.SMOKE
    with pytest.raises(KeyError):
        get_arch("no-such-arch")
