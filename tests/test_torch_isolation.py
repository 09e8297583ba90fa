"""The port stands alone: importing it loads neither ``jax`` nor ``repro``,
its entry points run on the card unless the caller asks for the CPU, and
what it does not port yet raises instead of running something else."""
import os
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core.tg_linear import min_linear, tglinear
from repro_torch.data.kb_sources import LUBM_L, LUBM_LI, lubm_facts
from repro_torch.engine.materialize import EngineKB, materialize
from repro_torch.engine.relation import Relation

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)


def port_modules():
    return sorted("repro_torch." + ".".join(p.relative_to(PKG).with_suffix("")
                                            .parts).removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m.removesuffix('.__init__'))\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro')\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=300)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PKG.rglob("*.py")]
    + ["chip_smoke.py", "tests/torch_card_comm.py"]))
def test_no_source_imports_jax_or_repro(path):
    assert not FORBIDDEN.search((ROOT / path).read_text()), path


def test_engine_kb_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EngineKB(LUBM_L, lubm_facts(n_univ=1))
    kb = EngineKB(LUBM_L, lubm_facts(n_univ=1), device="cpu")
    assert kb.rels["subOrg"].data.device.type == "cpu"


def test_relation_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rows = np.array([[1, 2]], np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Relation.from_numpy(rows)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Relation.empty(2)
    assert Relation.from_numpy(rows, device="cpu").device.type == "cpu"


def test_models_and_serving_default_to_the_card(monkeypatch):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models.model import build
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("stablelm_12b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(cfg, 2, 8, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "stablelm_12b", "--smoke"])
    assert build(cfg, device="cpu").device.type == "cpu"
    gen, _, _ = serve.serve(cfg, 2, 8, 2, device="cpu")
    assert gen.shape == (2, 2)


@pytest.mark.parametrize("how", ["tg_linear", "dist", "REPRO_DIST"])
def test_unported_features_raise(how, monkeypatch):
    """The sharded executor runs behind ``backend="dist"`` and
    ``REPRO_DIST=1`` in ``tg`` (``seminaive`` runs two-phase, as on the
    reference); what it leaves unported, the XLA lowering of a sharded
    round on several cards (the multi-card dry run), raises naming its
    ROADMAP item.  ``tg_linear`` returns before
    the executor flags are read, as on the reference, so under
    ``REPRO_DIST=1`` it runs.  (``REPRO_FUSED=1`` runs the fused executor:
    see ``tests/test_torch_fused.py``.)"""
    from repro_torch.engine import distributed
    kb = EngineKB(LUBM_L, lubm_facts(n_univ=1), device="cpu")
    kw = {}
    if how == "tg_linear":
        monkeypatch.setenv("REPRO_DIST", "1")
        eg = min_linear(tglinear(LUBM_LI))
        kb_li = EngineKB(LUBM_LI, lubm_facts(n_univ=1), device="cpu")
        st = materialize(kb_li, mode="tg_linear", tg_eg=eg)
        assert (st.mode, st.rounds) == ("tg_linear[w-cleaning]", 5)
        assert kb_li.rels["Person"].count > 0
    elif how == "dist":
        kw["backend"] = "dist"
    else:
        monkeypatch.setenv(how, "1")
    st = materialize(kb, mode="tg", **kw)
    assert st.extra == {"dist": True, "ndev": 1}
    kb_two = EngineKB(LUBM_L, lubm_facts(n_univ=1), device="cpu")
    st_two = materialize(kb_two, mode="seminaive", **kw)
    assert "dist" not in st_two.extra
    assert kb.decode_facts() == kb_two.decode_facts()
    from repro_torch.launch import dryrun
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        dryrun.main(["--arch", "stablelm_12b", "--shape", "train_4k",
                     "--multi-pod"])


def test_core_holds_its_own_symbolic_layer():
    for name in ("terms", "unify", "chase", "eg", "tg_linear", "rewrite",
                 "tg_datalog"):
        assert (PKG / "core" / f"{name}.py").is_file(), name


def test_analysis_holds_its_own_accounting():
    """The cost walk and the roofline are the port's own (the reference's
    ``repro.analysis`` parses HLO); with no recorder active, no dispatch
    mode is pushed and the kernel wrappers run as they are."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    from repro_torch.analysis import cost
    for name in ("cost", "roofline"):
        assert (PKG / "analysis" / f"{name}.py").is_file(), name
    assert cost.ACTIVE is None and _get_current_dispatch_mode() is None


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card_or_the_repo(alone, tmp_path):
    """No card here, so the smoke must exit non-zero and print no result;
    alone in a directory it has no package to run either."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = pathlib.Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
