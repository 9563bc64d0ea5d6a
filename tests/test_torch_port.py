"""The port as a package: parameter conversion, the golden U0 fixture, its
independence from JAX, and its default device."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pddp_tpu.examples.cartpole import CartpoleCost as JCost
from pddp_tpu.examples.cartpole import CartpoleDynamicsModel as JModel
from pddp_tpu_torch import convert
from pddp_tpu_torch.device import resolve_device
from pddp_tpu_torch.examples.cartpole import CartpoleCost, CartpoleDynamicsModel
from tests.golden.cases import make_solve_args

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_golden_U0_fixture_is_bit_exact():
    _, _, _, U0, _, _ = make_solve_args("cartpole")
    fixture = convert.golden_cartpole_U0()
    assert fixture.dtype == np.float64 and fixture.shape == (60, 1)
    np.testing.assert_array_equal(fixture, np.asarray(U0))


def test_cartpole_conversion_carries_every_parameter():
    jm = JModel(dt=0.03, mc=0.7, mp=0.4, l=0.6, mu=0.2, g=9.81)
    jc = JCost()
    mp = {n: np.asarray(getattr(jm, n)) for n in
          convert.CARTPOLE_MODEL_FIELDS}
    cp = {n: np.asarray(getattr(jc, n)) for n in
          convert.CARTPOLE_COST_FIELDS}
    model, cost = convert.cartpole(mp, cp, device="cpu", dtype=torch.float64)
    assert isinstance(model, CartpoleDynamicsModel)
    assert isinstance(cost, CartpoleCost)
    for n in convert.CARTPOLE_MODEL_FIELDS:
        assert getattr(model, n).dtype == torch.float64
        np.testing.assert_array_equal(getattr(model, n).numpy(), mp[n])
    for n in convert.CARTPOLE_COST_FIELDS:
        np.testing.assert_array_equal(getattr(cost, n).numpy(), cp[n])
    model32, _ = convert.cartpole(mp, cp, device="cpu")
    assert model32.dt.dtype == torch.float32
    with pytest.raises(TypeError):
        convert.cartpole({**mp, "dt": torch.tensor(0.1)}, cp, device="cpu")


def test_port_imports_neither_jax_nor_pddp_tpu():
    """Every module of the port, and every script of examples_torch/,
    imports in a process where importing jax or pddp_tpu fails (the
    scripts also without matplotlib)."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["pddp_tpu"] = None
        import pddp_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            pddp_tpu_torch.__path__, "pddp_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        sys.modules["matplotlib"] = None
        import examples_torch
        scripts = [m.name for m in pkgutil.iter_modules(
            examples_torch.__path__, "examples_torch.")]
        for name in scripts:
            importlib.import_module(name)
        assert len(scripts) == 9, scripts
        assert not any(k == "jax" or k.startswith("jax.") or
                       k == "pddp_tpu" or k.startswith("pddp_tpu.")
                       for k, v in sys.modules.items() if v is not None)
        for new in ("controllers.pddp", "models.bnn.losses",
                    "examples.problems", "utils.trajectory", "utils.draws"):
            assert "pddp_tpu_torch." + new in names, new
        print(len(names))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 15


def test_chip_smoke_imports_neither_jax_nor_pddp_tpu():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['pddp_tpu'] = None; import chip_smoke")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError):
        resolve_device()
    with pytest.raises(RuntimeError):
        CartpoleDynamicsModel()
    with pytest.raises(RuntimeError):
        CartpoleCost()
    assert resolve_device("cpu").type == "cpu"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
